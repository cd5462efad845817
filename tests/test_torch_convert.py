"""Host converters and the sparse container of the torch port against the
JAX package: the same CSR gives byte-identical arrays."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import single_algebra_tpu.sparse.convert as jcv
from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.sparse import convert as tcv

from tests.conftest import cluster_counts, make_random_csr


def _csr(seed, n=300, p=700, density=0.05, heavy_rows=True):
    X = make_random_csr(n, p, density=density, seed=seed, dtype=np.float32)
    if heavy_rows:
        # a few dense rows: wide (row, tile) groups and overflow entries
        X = X.tolil()
        rng = np.random.default_rng(seed)
        for r in rng.choice(n, 3, replace=False):
            X[r, rng.choice(p, p // 3, replace=False)] = 1.0 + rng.random(p // 3)
        X = X.tocsr()
    X.sort_indices()
    return X.indptr.astype(np.int64), X.indices.astype(np.int32), X.data, X


def _assert_same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_round_up():
    for x in (0, 1, 7, 8, 9, 1023, 1025):
        for m in (8, 128, 1024):
            assert tcv.round_up(x, m) == jcv.round_up(x, m)


@pytest.mark.parametrize("col_tile", [64, 256])
def test_row_tile_widths(col_tile):
    ip, ix, _, X = _csr(1)
    _assert_same(
        [tcv.row_tile_widths(ip, ix, X.shape[0], col_tile)],
        [jcv.row_tile_widths(ip, ix, X.shape[0], col_tile)],
    )


def test_extract_rows_csr():
    ip, ix, dt, _ = _csr(2)
    rows = np.random.default_rng(0).permutation(300)[:120]
    _assert_same(
        tcv.extract_rows_csr(ip, ix, dt, rows), jcv.extract_rows_csr(ip, ix, dt, rows)
    )


@pytest.mark.parametrize("quantile", [0.9, 1.0])
def test_tiled_split_layout(quantile):
    ip, ix, dt, X = _csr(3)
    n, p = X.shape
    _assert_same(
        tcv.tiled_split_widths(ip, ix, n, p, 128, quantile),
        jcv.tiled_split_widths(ip, ix, n, p, 128, quantile),
    )
    _assert_same(
        tcv.csr_to_tiled_ell_split_numpy(ip, ix, dt, n, p, 128, 256, quantile),
        jcv.csr_to_tiled_ell_split_numpy(ip, ix, dt, n, p, 128, 256, quantile),
    )


def test_fill_class_payload():
    ip, ix, dt, X = _csr(4)
    n, p = X.shape
    w = jcv.row_tile_widths(ip, ix, n, 256)
    rows = np.where(w <= 8)[0]
    _assert_same(
        tcv.fill_class_payload(ip, ix, dt, rows, p, 256, 8, 512),
        jcv.fill_class_payload(ip, ix, dt, rows, p, 256, 8, 512),
    )


def test_csr_transpose():
    ip, ix, dt, X = _csr(5)
    _assert_same(
        tcv.csr_transpose_numpy(ip, ix, dt, *X.shape),
        jcv.csr_transpose_numpy(ip, ix, dt, *X.shape),
    )


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_matrix_row_layout_matches(fmt):
    X = cluster_counts(200, 90, seed=1).astype(np.float32)
    X = X.tocsc() if fmt == "csc" else X
    m, jm = SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)
    assert m.format == jm.format == fmt
    assert m.shape == jm.shape and m.nnz == jm.nnz
    assert m.dtype == torch.float32 and m.device == torch.device("cpu")
    r, jr = m._layout_for("row"), jm._layout_for("row")
    _assert_same(
        [r._h_indptr, r._h_indices, r._csr_data_host()],
        [jr._h_indptr, jr._h_indices, jr._csr_data_host()],
    )
    np.testing.assert_array_equal(m.to_dense(), X.toarray())


@pytest.mark.parametrize(
    "values, bf16, i8",
    [
        (lambda d: np.round(d * 100), True, True),  # small counts
        (lambda d: np.round(d * 100) + 128, True, False),  # counts 128..228
        (lambda d: d, False, False),  # general floats
        (lambda d: -np.round(d * 127), True, True),
    ],
)
def test_value_gates(values, bf16, i8):
    X = make_random_csr(80, 60, density=0.2, seed=6, dtype=np.float32)
    X.data = values(X.data).astype(np.float32)
    m, jm = SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)
    assert m.values_bf16_exact() == jm.values_bf16_exact() == bf16
    assert m.values_int8_exact() == jm.values_int8_exact() == i8


def test_from_scipy_dtypes():
    X = make_random_csr(30, 20, seed=7)  # float64
    assert SparseMatrix.from_scipy(X, device="cpu").dtype == torch.float64
    assert SparseMatrix.from_scipy(X, dtype=np.float32, device="cpu").dtype == torch.float32
    Xi = sp.csr_matrix(np.arange(12).reshape(3, 4))
    assert SparseMatrix.from_scipy(Xi, device="cpu").dtype == torch.float32
    with pytest.raises(TypeError):
        SparseMatrix.from_scipy(X, dtype=np.int32, device="cpu")
    m = SparseMatrix.from_scipy(X, device="cuda")  # a device is a name here
    assert m.device.type == "cuda"


@pytest.mark.parametrize("wt", [8, 16, 64])
def test_tiled_overflow_col_width(wt):
    # heavy rows over one column block: wide per-column overflow; wt 64 has none
    ip, ix, _, X = _csr(5, heavy_rows=True)
    n, p = X.shape
    got = tcv.tiled_overflow_col_width(ip, ix, n, p, 128, wt)
    assert got == jcv.tiled_overflow_col_width(ip, ix, n, p, 128, wt)
    assert (got > 0) == (wt < 64)


def test_plain_ell_matches_jax():
    ip, ix, dt, X = _csr(6)
    for args in ((), (None, 400), ):
        _assert_same(tcv.csr_to_ell_numpy(ip, ix, dt, X.shape[0], *args),
                     jcv.csr_to_ell_numpy(ip, ix, dt, X.shape[0], *args))
    for w in (0, 5, 100, 129):
        assert tcv.pad_width(w) == jcv.pad_width(w)
        assert tcv.pad_rows(w) == jcv.pad_rows(w)


@pytest.mark.parametrize("rows_padded", [None, 512])
def test_csr_to_ell_native_route_matches_numpy(monkeypatch, rows_padded):
    """float32 inputs take the bound native converter (as the JAX package
    routes them), float64 inputs and a missing native library the numpy
    path: identical arrays, padding rows and rows at full width included."""

    from single_algebra_tpu_torch.native import build as nb

    indptr, indices, data, X = _csr(11)
    indptr = np.concatenate([indptr, np.full(4, indptr[-1])])  # 4 empty rows at the end
    n = len(indptr) - 1
    width = int(np.diff(indptr).max())  # the heavy rows fill it exactly
    assert nb.get_lib() is not None and nb.get_lib().csr_to_ell_f32.argtypes
    calls = []
    real = nb.csr_to_ell
    monkeypatch.setattr(nb, "csr_to_ell", lambda *a: calls.append(a[2].dtype) or real(*a))
    nat = tcv.csr_to_ell_numpy(indptr, indices, data, n, width, rows_padded)
    assert calls == [np.float32]
    d64 = tcv.csr_to_ell_numpy(indptr, indices, data.astype(np.float64), n, width,
                               rows_padded)
    assert calls == [np.float32] and d64[0].dtype == np.float64
    monkeypatch.setattr(nb, "get_lib", lambda: None)
    ref = tcv.csr_to_ell_numpy(indptr, indices, data, n, width, rows_padded)
    _assert_same(nat, ref)
    np.testing.assert_array_equal(d64[0], ref[0].astype(np.float64))
    R = rows_padded or tcv.pad_rows(n)
    assert nat[0].shape == (R, width) and (nat[2][n:] == 0).all()
    assert (nat[2][:n] == width).any()
    _assert_same(nat, jcv.csr_to_ell_numpy(indptr, indices, data, n, width, rows_padded))


def _coo(seed, n=40, p=25, nnz=300):
    """COO triplets in random order with repeated (row, col) pairs."""

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, p, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals, n, p


@pytest.mark.parametrize("sum_duplicates", [True, False])
def test_coo_to_csr_numpy(sum_duplicates):
    rows, cols, vals, n, p = _coo(12)
    assert len(set(zip(rows.tolist(), cols.tolist()))) < len(rows)  # duplicates
    got = tcv.coo_to_csr_numpy(rows, cols, vals, n, p, sum_duplicates)
    _assert_same(got, jcv.coo_to_csr_numpy(rows, cols, vals, n, p, sum_duplicates))
    assert got[0].dtype == np.int64 and got[1].dtype == np.int32
    assert got[2].dtype == np.float32
    want = sp.coo_matrix((vals.astype(np.float64), (rows, cols)), shape=(n, p)).toarray()
    np.testing.assert_allclose(
        sp.csr_matrix((got[2], got[1], got[0]), shape=(n, p)).toarray(), want, atol=1e-5)


@pytest.mark.parametrize("n_rows, n_slabs", [(1001, 8), (130, 3), (5, 8), (64, 8), (0, 2)])
def test_slab_row_ranges(n_rows, n_slabs):
    got = tcv.slab_row_ranges(n_rows, n_slabs)
    assert got == jcv.slab_row_ranges(n_rows, n_slabs)
    assert len(got) == n_slabs and got[-1][1] == n_rows
    assert all(a % 8 == 0 or a == n_rows for a, _ in got)  # empty slabs trail


@pytest.mark.parametrize("col_tile", [128, 256])
@pytest.mark.parametrize("case", ["heavy", "plain", "empty"])
def test_csr_to_tiled_ell_numpy(col_tile, case):
    if case == "empty":
        ip, ix, dt = np.zeros(11, np.int64), np.zeros(0, np.int32), np.zeros(0, np.float32)
        n, p = 10, 300
    else:
        ip, ix, dt, X = _csr(13, heavy_rows=case == "heavy")
        n, p = X.shape
    got = tcv.csr_to_tiled_ell_numpy(ip, ix, dt, n, p, col_tile, 512)
    _assert_same(got, jcv.csr_to_tiled_ell_numpy(ip, ix, dt, n, p, col_tile, 512))
    td, tl, wt, ntiles = got
    assert td.shape == tl.shape == (max(tcv.round_up(n, 512), 512), ntiles * wt)
    assert ntiles == -(-p // col_tile) and tl.dtype == np.int32 and td.dtype == dt.dtype
    if case == "empty":
        assert wt == 8 and not td.any() and not tl.any()
    else:
        assert (tl[td == 0] == 0).all()  # padding slots are (0, 0)
        groups = max(np.bincount(ix[ip[r]:ip[r + 1]] // col_tile).max() for r in range(n)
                     if ip[r + 1] > ip[r])
        assert wt == tcv.round_up(int(groups), 8)


@pytest.mark.parametrize(
    "n,p,k,density,ct",
    [(512, 300, 16, 0.1, 128), (1024, 700, 60, 0.05, 256), (512, 90, 5, 0.3, 128)],
)
def test_tiled_layout_through_plain_kernels_and_pallas(n, p, k, density, ct):
    """``csr_to_tiled_ell_numpy``'s arrays, transposed, through the port's
    plain kernel versions and the Pallas kernels in interpret mode (the
    shapes of tests/test_pallas_kernels.py): densify, ``A @ B`` and
    ``A^T @ C`` agree within 1e-5 of the largest value, and with scipy."""

    import jax.numpy as jnp

    from single_algebra_tpu.ops.pallas import spmm_kernel as pk
    from single_algebra_tpu_torch.ops.densify import tiled_ell_densify_t_plain
    from single_algebra_tpu_torch.ops.spmm_kernel import (
        tiled_ell_rmv_t_plain, tiled_ell_spmm_t_plain,
    )

    rng = np.random.default_rng(0)
    X = sp.random(n, p, density=density, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random).astype(np.float32)
    td, tl, wt, nt = tcv.csr_to_tiled_ell_numpy(X.indptr, X.indices, X.data, n, p, ct, 512)
    tdt, tlt = np.ascontiguousarray(td.T), np.ascontiguousarray(tl.T)
    R, kp = td.shape[0], 128
    Bt = np.zeros((kp, nt * ct), np.float32)
    Bt[:k, :p] = rng.standard_normal((k, p))
    Ct = np.zeros((kp, R), np.float32)
    Ct[:k, :n] = rng.standard_normal((k, n))
    kw = dict(wt=wt, ntiles=nt, col_tile=ct, block_rows=512)
    jx = dict(interpret=True, **kw)
    ttd, ttl = torch.from_numpy(tdt), torch.from_numpy(tlt)

    dense = tiled_ell_densify_t_plain(ttd, ttl, wt=wt, ntiles=nt, col_tile=ct,
                                      out_dtype=torch.float32).numpy()
    dense_j = np.asarray(pk.tiled_ell_densify_t(jnp.asarray(tdt), jnp.asarray(tlt),
                                                out_dtype=jnp.float32, **jx))
    np.testing.assert_array_equal(dense, dense_j)
    np.testing.assert_array_equal(dense[:p, :n], X.toarray().T)

    for plain, pallas, op, ref in (
        (tiled_ell_spmm_t_plain, pk.tiled_ell_spmm_t, Bt, (X @ Bt[:k, :p].T.astype(np.float64)).T),
        (tiled_ell_rmv_t_plain, pk.tiled_ell_rmv_t, Ct, X.T @ Ct[:k, :n].T.astype(np.float64)),
    ):
        got = plain(ttd, ttl, torch.from_numpy(op), **kw).numpy()
        want = np.asarray(pallas(jnp.asarray(tdt), jnp.asarray(tlt), jnp.asarray(op), **jx))
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(got[:ref.shape[0], :ref.shape[1]], ref, rtol=0,
                                   atol=1e-5 * scale)
