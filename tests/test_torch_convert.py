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
