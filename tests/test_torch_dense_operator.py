"""``DensifiedOperator`` of the torch port against the JAX package.

The same scipy matrix goes through both packages: the bf16 ``hi``/``lo``
payloads must agree bit for bit (uint16 views) whichever route built them
(native host densify, the torch fallback, the scatter on the matrix's
device), the fast products within bf16-class tolerance (the operand is
rounded to bf16: 2^-8 relative per entry), and the precise products within
1e-6 of max |result| of the JAX three-term result (both accumulate the
same nine bf16 products in float32, in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu.linalg import operators as jops
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.linalg import operators as tops
from single_algebra_tpu_torch.linalg.operators import DensifiedOperator

from tests.conftest import cluster_counts


def bits(t):
    """bf16 tensor (torch) or array (ml_dtypes) -> its uint16 bit patterns."""

    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.ascontiguousarray(np.asarray(t)).view(np.uint16)


def matrix(kind):
    """exact: raw counts (bf16-exact, no lo half); frac: the same counts
    times a float32 constant (needs the lo half)."""

    X = cluster_counts(300, 90, n_clusters=6, seed=2).astype(np.float32)
    if kind == "frac":
        X = sp.csr_matrix((X.data * np.float32(1.2345), X.indices, X.indptr), shape=X.shape)
    return X


@pytest.fixture(scope="module", params=["exact", "frac"])
def both(request):
    X = matrix(request.param)
    jop = jops.DensifiedOperator.from_matrix(JMatrix.from_scipy(X))
    top = DensifiedOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"))
    return request.param, X, jop, top


def test_payload_bit_identical_to_jax(both):
    kind, X, jop, top = both
    jhi, jlo = jops.DensifiedOperator.densify_host(JMatrix.from_scipy(X))
    hi, lo = DensifiedOperator.densify_host(SparseMatrix.from_scipy(X, device="cpu"))
    np.testing.assert_array_equal(bits(hi), bits(jhi))
    np.testing.assert_array_equal(bits(top.hi), bits(jop.hi))
    assert (lo is None) == (jlo is None) == (kind == "exact")
    assert (top.lo is None) == (jop.lo is None)
    if lo is not None:
        np.testing.assert_array_equal(bits(lo), bits(jlo))
        np.testing.assert_array_equal(bits(top.lo), bits(jop.lo))
    assert top.shape == X.shape and top.dtype == torch.float32


def test_lo_is_nonzero_on_inexact_values():
    """The lo half must carry the residual: were f32 -> bf16 -> f32 folded
    to the identity, it would be all zero and the precise products would
    drop to single-bf16 accuracy."""

    top = DensifiedOperator.from_matrix(
        SparseMatrix.from_scipy(matrix("frac"), device="cpu"))
    assert top.lo is not None and bool((top.lo != 0).any())
    dense = top.hi.float() + top.lo.float()
    ref = torch.from_numpy(matrix("frac").toarray())
    assert float((dense - ref).abs().max()) <= 2.0 ** -16 * float(ref.abs().max())
    assert float((top.hi.float() - ref).abs().max()) > 0.0


@pytest.mark.parametrize("kind", ["exact", "frac"])
@pytest.mark.parametrize("native", [True, False])
def test_construction_routes_identical(kind, native, monkeypatch):
    """Host densify (native, or its torch fallback) + upload, and the
    scatter on the matrix's device, give the same hi/lo."""

    if not native:
        monkeypatch.setenv("SINGLE_ALGEBRA_TPU_NO_NATIVE", "1")
        from single_algebra_tpu_torch.native import build as nbuild

        monkeypatch.setattr(nbuild, "_tried", False)
        monkeypatch.setattr(nbuild, "_lib", None)
    X = matrix(kind)
    host = DensifiedOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"), device=False)
    dev = DensifiedOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"), device=True)
    np.testing.assert_array_equal(bits(host.hi), bits(dev.hi))
    assert (host.lo is None) == (dev.lo is None)
    if host.lo is not None:
        np.testing.assert_array_equal(bits(host.lo), bits(dev.lo))
    assert set(host.build_seconds) == {"host_densify", "upload"}
    assert set(dev.build_seconds) == {"upload", "device_densify"}
    csc = DensifiedOperator.from_matrix(
        SparseMatrix.from_scipy(X.tocsc(), device="cpu"), device=True)
    np.testing.assert_array_equal(bits(csc.hi), bits(host.hi))


def test_device_densify_in_row_blocks(monkeypatch):
    X = matrix("frac")
    whole = DensifiedOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"), device=True)
    monkeypatch.setattr(DensifiedOperator, "_BLOCK_BYTES", 4096)  # a few rows per block
    blocked = DensifiedOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"), device=True)
    np.testing.assert_array_equal(bits(blocked.hi), bits(whole.hi))
    np.testing.assert_array_equal(bits(blocked.lo), bits(whole.lo))
    s, sq = blocked.col_stats()
    s1, sq1 = whole.col_stats()
    np.testing.assert_allclose(s.numpy(), s1.numpy(), rtol=1e-6)
    np.testing.assert_allclose(sq.numpy(), sq1.numpy(), rtol=1e-6)


def test_fast_products_bf16_class(both):
    _, X, jop, top = both
    rng = np.random.default_rng(5)
    B = rng.standard_normal((90, 7)).astype(np.float32)
    C = rng.standard_normal((300, 7)).astype(np.float32)
    D = X.toarray().astype(np.float64)
    for got, jgot, ref in (
        (top.mv(torch.from_numpy(B)), jop.mv(jnp.asarray(B)), D @ B),
        (top.rmv(torch.from_numpy(C)), jop.rmv(jnp.asarray(C)), D.T @ C),
    ):
        assert got.dtype == torch.float32
        scale = np.abs(ref).max()
        # same bf16 products, float32 sums in another order
        assert np.abs(got.numpy() - np.asarray(jgot)).max() <= 1e-5 * scale
        # the operand's rounding to bf16: 2^-8 relative an entry
        assert np.abs(got.numpy() - ref).max() <= 2.0 ** -7 * scale


def test_precise_products_match_jax_three_term(both):
    _, X, jop, top = both
    rng = np.random.default_rng(6)
    B = rng.standard_normal((90, 5)).astype(np.float32)
    C = rng.standard_normal((300, 5)).astype(np.float32)
    D = X.toarray().astype(np.float64)
    for got, jgot, ref in (
        (top.mv_precise(torch.from_numpy(B)), jop.mv_precise(jnp.asarray(B)), D @ B),
        (top.rmv_precise(torch.from_numpy(C)), jop.rmv_precise(jnp.asarray(C)), D.T @ C),
    ):
        scale = np.abs(ref).max()
        assert np.abs(got.numpy() - np.asarray(jgot)).max() <= 1e-6 * scale
        # 16 matrix bits x 24 operand bits: float32-class against float64
        assert np.abs(got.numpy() - ref).max() <= 2e-5 * scale


def test_bf16_terms_match_jax():
    rng = np.random.default_rng(7)
    B = (rng.standard_normal((40, 6)) * 10.0 ** rng.integers(-3, 4, (40, 6))).astype(np.float32)
    terms = tops.bf16_terms(torch.from_numpy(B))
    jterms = jops.bf16_terms(jnp.asarray(B))
    assert len(terms) == len(jterms) == tops.OPERAND_TERMS == jops.OPERAND_TERMS
    for t, jt in zip(terms, jterms):
        np.testing.assert_array_equal(bits(t), bits(jt))
    total = sum(t.double() for t in terms).numpy()
    assert np.abs(total - B).max() <= 2.0 ** -23 * np.abs(B).max()


def test_col_stats_match_jax(both):
    _, X, jop, top = both
    s, sq = top.col_stats()
    js, jsq = jop.col_stats()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=1e-5, atol=1e-5)


def test_from_arrays_round_trip(both):
    """The JAX operator's halves carry across as numpy arrays."""

    _, X, jop, top = both
    hi = np.asarray(jop.hi)
    lo = None if jop.lo is None else np.asarray(jop.lo)
    op = DensifiedOperator.from_arrays(hi, lo, X.shape, device="cpu")
    np.testing.assert_array_equal(bits(op.hi), bits(top.hi))
    assert (op.lo is None) == (top.lo is None)
    B = torch.from_numpy(np.random.default_rng(8).standard_normal((90, 3)).astype(np.float32))
    assert torch.equal(op.mv_precise(B), top.mv_precise(B))
    # uint16 bit patterns are taken as well
    op2 = DensifiedOperator.from_arrays(bits(top.hi), None, X.shape, device="cpu")
    assert torch.equal(op2.hi, top.hi)
    with pytest.raises(ValueError):
        DensifiedOperator.from_arrays(hi[:10], None, X.shape, device="cpu")


# -- an odd number of columns (GRCh38's 36,601), and the padded row stride -------


def odd_matrix(kind):
    """91 columns: the dense form's rows then need padding to 96 elements."""

    X = cluster_counts(300, 91, n_clusters=6, seed=3).astype(np.float32)
    if kind == "frac":
        X = sp.csr_matrix((X.data * np.float32(1.2345), X.indices, X.indptr), shape=X.shape)
    return X


@pytest.mark.parametrize("kind", ["exact", "frac"])
@pytest.mark.parametrize("route", ["from_matrix", "from_arrays"])
def test_odd_width_matches_jax(kind, route):
    X = odd_matrix(kind)
    jop = jops.DensifiedOperator.from_matrix(JMatrix.from_scipy(X))
    if route == "from_matrix":
        top = DensifiedOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"))
    else:
        top = DensifiedOperator.from_arrays(
            np.asarray(jop.hi), None if jop.lo is None else np.asarray(jop.lo), X.shape,
            device="cpu")
    np.testing.assert_array_equal(bits(top.hi), bits(jop.hi))
    assert (top.lo is None) == (jop.lo is None) == (kind == "exact")
    if top.lo is not None:
        np.testing.assert_array_equal(bits(top.lo), bits(jop.lo))
    rng = np.random.default_rng(9)
    B = rng.standard_normal((91, 5)).astype(np.float32)
    C = rng.standard_normal((300, 5)).astype(np.float32)
    D = X.toarray().astype(np.float64)
    for got, jgot, ref, tol in (
        (top.mv(torch.from_numpy(B)), jop.mv(jnp.asarray(B)), D @ B, 1e-5),
        (top.rmv(torch.from_numpy(C)), jop.rmv(jnp.asarray(C)), D.T @ C, 1e-5),
        (top.mv_precise(torch.from_numpy(B)), jop.mv_precise(jnp.asarray(B)), D @ B, 1e-6),
        (top.rmv_precise(torch.from_numpy(C)), jop.rmv_precise(jnp.asarray(C)), D.T @ C, 1e-6),
    ):
        assert np.abs(got.numpy() - np.asarray(jgot)).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["exact", "frac"])
@pytest.mark.parametrize("route", ["host", "device", "arrays"])
def test_padded_stride_agrees_with_the_unpadded_form(kind, route):
    """Every route stores rows of 96 elements for 91 columns and keeps the
    [n, 91] view; products and column statistics equal those of the same
    halves stored contiguously (1e-6 of max |result|)."""

    X = odd_matrix(kind)
    m = SparseMatrix.from_scipy(X, device="cpu")
    if route == "arrays":
        hi, lo = DensifiedOperator.densify_host(m)
        op = DensifiedOperator.from_arrays(bits(hi), None if lo is None else bits(lo), X.shape,
                                           device="cpu")
    else:
        op = DensifiedOperator.from_matrix(m, device=route == "device")
    halves = [h for h in (op.hi, op.lo) if h is not None]
    assert all(tuple(h.shape) == X.shape and h.stride() == (96, 1) for h in halves)
    plain = DensifiedOperator(op.hi.contiguous(),
                              None if op.lo is None else op.lo.contiguous(), X.shape)
    assert plain.hi.stride() == (91, 1)
    rng = np.random.default_rng(10)
    B = torch.from_numpy(rng.standard_normal((91, 6)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((300, 6)).astype(np.float32))
    for name, arg in (("mv", B), ("rmv", C), ("mv_precise", B), ("rmv_precise", C)):
        got, ref = getattr(op, name)(arg), getattr(plain, name)(arg)
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    for got, ref in zip(op.col_stats(), plain.col_stats()):
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    budget = 2 * 300 * 96 * (1 if op.lo is None else 2)  # the padded halves
    assert DensifiedOperator.fits(X.shape, budget, op.lo is not None, device="cpu")
    assert not DensifiedOperator.fits(X.shape, budget - 1, op.lo is not None, device="cpu")
