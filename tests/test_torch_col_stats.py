"""The fit's column statistics (``models/pca.py::_host_col_stats``, the
matrix's ``SparseMatrix._host_col_stats``).

The native pass (``native/build.py::csr_col_stats``, ``csr_col_stats_f64``
in ``native/ell_convert.cpp``) against numpy's two ``bincount``s of the
float64-widened values: bit for bit on integer-valued CSR, within 1e-12
relative on float data, and bit for bit between thread counts and
repeats. Then the numpy fallback the seam takes without the native
library, and the fits on both routes.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
from single_algebra_tpu_torch.models import pca as pca_mod
from single_algebra_tpu_torch.native import build as nbuild
from single_algebra_tpu_torch.types import PowerIterationNormalizer as PIN
from single_algebra_tpu_torch.types import SVDMethod
from single_algebra_tpu_torch.utils import tracing


def bincount_stats(data, idx, p):
    d = np.asarray(data).astype(np.float64)
    return (np.bincount(idx, weights=d, minlength=p)[:p],
            np.bincount(idx, weights=d * d, minlength=p)[:p])


def native(data, idx, p, n_threads=0):
    out = nbuild.csr_col_stats(data, idx, p, n_threads)
    if out is None:
        pytest.skip("no native library (no g++ on this host)")
    return out


def integer_csr(case):
    """(values float32, column indices int32, p) of an integer-valued CSR."""

    rng = np.random.default_rng(7)
    if case == "nnz0":
        return np.zeros(0, np.float32), np.zeros(0, np.int32), 40
    if case == "nnz_under_blocks":  # 5 entries: fewer than the 64 blocks at most
        return (np.array([3, 1, 4, 1, 5], np.float32),
                np.array([0, 7, 7, 2, 9], np.int32), 12)
    if case == "duplicates_in_a_row":  # scipy keeps them; both sides add each
        X = sp.csr_matrix((np.array([2, 3, 5, 7, 11, 13], np.float32),
                           np.array([4, 4, 1, 4, 0, 0], np.int32),
                           np.array([0, 4, 4, 6])), shape=(3, 6))
        assert not X.has_canonical_format
        return X.data, X.indices, X.shape[1]
    n, p = {"empty_rows_and_columns": (3000, 500), "many_blocks": (20000, 300)}[case]
    lam = rng.gamma(2.0, 1.0, p) * (np.arange(p) % 7 != 0)  # every 7th column empty
    X = sp.csr_matrix(rng.poisson(lam, (n, p)).astype(np.float32))
    if case == "empty_rows_and_columns":
        X = X.multiply((np.arange(n) % 5 != 0)[:, None]).tocsr()  # every 5th row empty
        X = sp.hstack([X, sp.csr_matrix((n, 37), dtype=np.float32)]).tocsr()  # trailing
    X.data *= 1000.0  # counts in the thousands: squares past float32's 2^24
    return X.data, X.indices.astype(np.int32), X.shape[1]


@pytest.mark.parametrize("case", ["nnz0", "nnz_under_blocks", "duplicates_in_a_row",
                                  "empty_rows_and_columns", "many_blocks"])
def test_native_equals_bincount_bit_for_bit_on_integers(case):
    data, idx, p = integer_csr(case)
    s, sq = native(data, idx, p)
    rs, rsq = bincount_stats(data, idx, p)
    assert s.dtype == sq.dtype == np.float64 and s.shape == sq.shape == (p,)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(sq, rsq)


def float_values(kind, n):
    rng = np.random.default_rng(11)
    if kind == "log1p":  # log1p of depth-normalised counts
        counts = 1.0 + rng.poisson(2.0, n)
        return np.log1p(counts * 1e4 / rng.uniform(500, 5000, n)).astype(np.float32)
    return rng.lognormal(0.0, 4.0, n).astype(np.float32)  # exponents far apart


@pytest.mark.parametrize("kind", ["log1p", "lognormal"])
def test_native_within_1e_12_on_float_values(kind):
    n, p = 400_000, 300
    idx = np.random.default_rng(3).integers(0, p, n).astype(np.int32)
    data = float_values(kind, n)
    s, sq = native(data, idx, p)
    rs, rsq = bincount_stats(data, idx, p)
    np.testing.assert_allclose(s, rs, rtol=1e-12, atol=0)
    np.testing.assert_allclose(sq, rsq, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kind", ["log1p", "lognormal"])
def test_native_repeats_bit_for_bit_across_thread_counts(kind):
    n, p = 400_000, 300  # 64 blocks, sums that round
    idx = np.random.default_rng(5).integers(0, p, n).astype(np.int32)
    data = float_values(kind, n)
    one = native(data, idx, p, 1)
    for got in (native(data, idx, p, 8), native(data, idx, p, 8), native(data, idx, p, 3),
                native(data, idx, p, 1), native(data, idx, p)):
        np.testing.assert_array_equal(got[0], one[0])
        np.testing.assert_array_equal(got[1], one[1])


def test_native_refuses_mismatched_lengths():
    if nbuild.get_lib() is None:
        pytest.skip("no native library (no g++ on this host)")
    with pytest.raises(ValueError):
        nbuild.csr_col_stats(np.ones(4, np.float32), np.zeros(3, np.int32), 5)


# -- the seam and the fits on both routes ---------------------------------------


def counts(n, p, seed):
    rng = np.random.default_rng(seed)
    lam = rng.gamma(2.0, 1.0, (6, p)) * (rng.random((6, p)) < 0.5)
    return sp.csr_matrix(rng.poisson(lam[rng.integers(0, 6, n)]).astype(np.float32))


def without_native(monkeypatch):
    monkeypatch.setenv("SINGLE_ALGEBRA_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(nbuild, "_tried", False)
    monkeypatch.setattr(nbuild, "_lib", None)


def fit(X, engine):
    pca = (SparsePCABuilder().n_components(4).engine(engine)
           .svd_method(SVDMethod.random(10, 4, PIN.QR)).build())
    pca.fit(SparseMatrix.from_scipy(X, device="cpu"))
    return pca


def test_numpy_fallback_gives_the_native_stats(monkeypatch):
    X = counts(1500, 120, 1)
    on = pca_mod._host_col_stats(SparseMatrix.from_scipy(X, device="cpu"))
    without_native(monkeypatch)
    assert nbuild.csr_col_stats(X.data, X.indices, X.shape[1]) is None
    off = pca_mod._host_col_stats(SparseMatrix.from_scipy(X, device="cpu"))
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1], off[1])
    np.testing.assert_array_equal(off[0], np.asarray(X.sum(axis=0)).ravel())


def test_float64_values_take_numpy(monkeypatch):
    X = counts(600, 50, 2).astype(np.float64)
    called, real = [], nbuild.csr_col_stats
    monkeypatch.setattr(nbuild, "csr_col_stats", lambda *a: called.append(1) or real(*a))
    with tracing.recording() as rec:
        s, sq = pca_mod._host_col_stats(
            SparseMatrix.from_scipy(X, dtype=np.float64, device="cpu"))
    assert called == [1]  # asked, and refused: the values are not float32
    assert rec.spans()[-1]["attrs"] == {"cached": False, "route": "numpy"}
    np.testing.assert_array_equal(s, np.asarray(X.sum(axis=0)).ravel())
    np.testing.assert_array_equal(sq, np.asarray(X.multiply(X).sum(axis=0)).ravel())


@pytest.mark.parametrize("engine", ["gram", "sparse"])
def test_fit_is_the_same_on_both_routes(engine, monkeypatch):
    X = counts(2000, 150, 3)
    on = fit(X, engine)
    without_native(monkeypatch)
    off = fit(X, engine)
    np.testing.assert_array_equal(on.mean_, off.mean_)
    np.testing.assert_array_equal(np.asarray(on.explained_variance_),
                                  np.asarray(off.explained_variance_))
