"""The gather engine (``SparseOperator``) and the column-masked view
(``MaskedOperator``) of the port against the JAX package's, on the same
seeded matrices. Float32-class products are held to 1e-6 of max |JAX
result|; products that round the operand to bf16 (the fast class of the
densified and tiled engines, and the densified engine's plain ``mv``) to
1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu.linalg import MaskedOperator as JMasked
from single_algebra_tpu.linalg import SparseOperator as JSparse
from single_algebra_tpu.models import pca as jpca
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.linalg import MaskedOperator, SparseOperator
from single_algebra_tpu_torch.models import pca as tpca
from tests.conftest import cluster_counts


@pytest.fixture(scope="module")
def counts():
    return cluster_counts(300, 90, n_clusters=6, seed=11).astype(np.float32)


def close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("k", [1, 5])
def test_sparse_operator_matches_jax(counts, fmt, k):
    m = SparseMatrix.from_scipy(counts, fmt=fmt, device="cpu")
    op = SparseOperator.from_matrix(m)
    jop = JSparse.from_matrix(JMatrix.from_scipy(counts, fmt=fmt))
    rng = np.random.default_rng(k)
    B = rng.standard_normal((90, k)).astype(np.float32)
    C = rng.standard_normal((300, k)).astype(np.float32)
    close(op.mv(torch.from_numpy(B)).numpy(), jop.mv(jnp.asarray(B)))
    close(op.rmv(torch.from_numpy(C)).numpy(), jop.rmv(jnp.asarray(C)))
    close(op.mv(torch.from_numpy(B)).numpy(), counts @ B)
    assert op.shape == (300, 90) and op.dtype == torch.float32


def test_sparse_operator_float64():
    X = cluster_counts(80, 40, n_clusters=4, seed=2)  # float64 values
    op = SparseOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu"))
    B = np.random.default_rng(0).standard_normal((40, 3))
    got = op.mv(torch.from_numpy(B)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, X @ B, rtol=1e-12, atol=1e-12)


def test_engine_sparse_builds_sparse_operator(counts):
    m = SparseMatrix.from_scipy(counts, device="cpu")
    op = tpca.make_engine_operator(m, "sparse")
    assert isinstance(op, SparseOperator)
    assert tpca.make_engine_operator(m, "auto") is op  # 'auto' off the card is 'sparse'


# the products of each engine that are float32-class; the others round
# the operand to bf16 (held to the JAX package at 1e-2)
PRECISE = {"sparse": {"mv", "rmv", "mv_precise", "rmv_precise", "mv_fast", "rmv_fast"},
           "dense": {"mv_precise", "rmv_precise"},
           "tiled": {"mv", "rmv", "mv_precise", "rmv_precise"}}


@pytest.mark.parametrize("engine", ["sparse", "dense", "tiled"])
def test_masked_operator_over_each_engine(counts, engine):
    """Every product class of the masked view equals the JAX masked view
    over the same engine (1e-6 for the float32-class products, 1e-2 for
    those with a bf16 operand), and the float32-class ones equal the
    product with the sliced matrix."""

    mask_idx = np.sort(np.random.default_rng(5).choice(90, 37, replace=False))
    base = tpca.make_engine_operator(SparseMatrix.from_scipy(counts, device="cpu"), engine)
    jbase = jpca.make_engine_operator(JMatrix.from_scipy(counts), engine)
    op = MaskedOperator(base, torch.from_numpy(mask_idx))
    jop = JMasked(jbase, jnp.asarray(mask_idx, jnp.int32))
    assert op.shape == (300, 37)
    rng = np.random.default_rng(6)
    B = rng.standard_normal((37, 4)).astype(np.float32)
    C = rng.standard_normal((300, 4)).astype(np.float32)
    Xm = counts[:, mask_idx].toarray().astype(np.float64)
    for name in ("mv", "mv_precise", "mv_fast", "rmv", "rmv_precise", "rmv_fast"):
        operand, want = (B, Xm @ B) if name.startswith("mv") else (C, Xm.T @ C)
        got = getattr(op, name)(torch.from_numpy(operand)).numpy()
        precise = name in PRECISE[engine]
        close(got, getattr(jop, name)(jnp.asarray(operand)), rel=1e-6 if precise else 1e-2)
        if precise:
            close(got, want)


class _Plain:
    """A base with only ``mv``/``rmv``: every class must fall back to them."""

    def __init__(self, a):
        self.a = a
        self.shape, self.dtype, self.device = tuple(a.shape), a.dtype, a.device

    def mv(self, B):
        return self.a @ B

    def rmv(self, C):
        return self.a.T @ C


def test_masked_operator_falls_back_to_plain_products():
    A = torch.from_numpy(np.random.default_rng(1).standard_normal((12, 8)))
    idx = torch.tensor([6, 1, 3])
    op = MaskedOperator(_Plain(A), idx)
    B = torch.ones((3, 2), dtype=A.dtype)
    C = torch.ones((12, 2), dtype=A.dtype)
    for name in ("mv", "mv_fast", "mv_precise"):
        torch.testing.assert_close(getattr(op, name)(B), A[:, idx] @ B)
    for name in ("rmv", "rmv_fast", "rmv_precise"):
        torch.testing.assert_close(getattr(op, name)(C), A[:, idx].T @ C)


def test_ell_scatter_densify_matches_jax(counts):
    from single_algebra_tpu.ops.spmm import ell_scatter_densify as jdensify
    from single_algebra_tpu_torch.ops.spmm import ell_scatter_densify

    m = SparseMatrix.from_scipy(counts, device="cpu")
    jm = JMatrix.from_scipy(counts)
    got = ell_scatter_densify(m.ell_data, m.ell_ids, m.row_nnz, 90).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdensify(jm.ell_data, jm.ell_ids,
                                                           jm.row_nnz, 90)))
    np.testing.assert_array_equal(got[:300], counts.toarray())


def test_onehot_product_is_the_indicator_product(counts):
    """``ell_onehot_spmm`` (the batch statistics' scatter-add) equals the
    gather product with the dense one-hot indicator."""

    from single_algebra_tpu_torch.ops.spmm import ell_onehot_spmm, ell_spmm

    col = SparseMatrix.from_scipy(counts, device="cpu").transpose()
    codes = torch.from_numpy(np.random.default_rng(3).integers(0, 5, 300))
    onehot = torch.nn.functional.one_hot(codes, 5).float()
    torch.testing.assert_close(ell_onehot_spmm(col.ell_data, col.ell_ids, codes, 5),
                               ell_spmm(col.ell_data, col.ell_ids, onehot), rtol=1e-6, atol=1e-4)
