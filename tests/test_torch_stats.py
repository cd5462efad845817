"""The port's statistics (``ops/stats.py`` through ``SparseMatrix``) against
the JAX package's, on the same seeded scipy inputs, CSR and CSC, float32 and
float64.

Tolerances: counts and min / max exact; float32 within 1e-6 of the largest
|JAX value| (the two packages sum in different orders), float64 within
1e-12 of it. The variances cancel ``sq/n - mean^2`` (and the batch form
``sumsq - sum^2/count``), so their rounding scales with those terms, not
with the result: they are held at the same 1e-6 / 1e-12 of
``2 max x^2``, which bounds every term.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu_torch import SparseMatrix

CASES = [
    # (n, p, density, fmt, dtype, seed)
    (1, 1, 1.0, "csr", np.float64, 0),
    (7, 130, 0.02, "csc", np.float32, 1),
    (64, 64, 0.5, "csr", np.float64, 2),
    (129, 3, 0.3, "csc", np.float64, 3),
    (200, 1000, 0.001, "csr", np.float32, 4),  # many empty rows/cols
    (33, 47, 0.15, "csc", np.float32, 5),
    (40, 30, 0.2, "csr", np.float32, 6),
]

STATS = {
    "nonzero_row": lambda m, rm, cm, b: m.nonzero_row(),
    "nonzero_col": lambda m, rm, cm, b: m.nonzero_col(),
    "nonzero_row_masked": lambda m, rm, cm, b: m.nonzero_row_masked(cm),
    "nonzero_col_masked": lambda m, rm, cm, b: m.nonzero_col_masked(rm),
    "sum_row": lambda m, rm, cm, b: m.sum_row(),
    "sum_col": lambda m, rm, cm, b: m.sum_col(),
    "sum_row_squared": lambda m, rm, cm, b: m.sum_row_squared(),
    "sum_col_squared": lambda m, rm, cm, b: m.sum_col_squared(),
    "sum_row_masked": lambda m, rm, cm, b: m.sum_row_masked(cm),
    "sum_col_masked": lambda m, rm, cm, b: m.sum_col_masked(rm),
    "var_row": lambda m, rm, cm, b: m.var_row(),
    "var_col": lambda m, rm, cm, b: m.var_col(),
    "var_row_masked": lambda m, rm, cm, b: m.var_row_masked(cm),
    "var_col_masked": lambda m, rm, cm, b: m.var_col_masked(rm),
    "var_row_chunk": lambda m, rm, cm, b: m.var_row_chunk(),
    "var_col_chunk": lambda m, rm, cm, b: m.var_col_chunk(),
    "min_row": lambda m, rm, cm, b: m.min_max_row()[0],
    "max_row": lambda m, rm, cm, b: m.min_max_row()[1],
    "min_col": lambda m, rm, cm, b: m.min_max_col()[0],
    "max_col": lambda m, rm, cm, b: m.min_max_col()[1],
    "sum_row_n_top": lambda m, rm, cm, b: m.sum_row_n_top(3),
    "mean_batch_row": lambda m, rm, cm, b: m.mean_batch_row(b[1]),
    "mean_batch_col": lambda m, rm, cm, b: m.mean_batch_col(b[0]),
    "var_batch_row": lambda m, rm, cm, b: m.var_batch_row(b[0]),
    "var_batch_col": lambda m, rm, cm, b: m.var_batch_col(b[1]),
}
EXACT = {"nonzero_row", "nonzero_col", "nonzero_row_masked", "nonzero_col_masked",
         "min_row", "max_row", "min_col", "max_col"}


def as_np(x):
    """A statistic of either package as numpy (batch dicts stacked in
    label order)."""

    if isinstance(x, dict):
        return np.stack([as_np(x[k]) for k in x], axis=1) if x else np.zeros((0, 0))
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_stat_close(got, want, dtype, exact=False, term_scale=0.0):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    rel = 1e-6 if np.dtype(dtype) == np.float32 else 1e-12
    scale = max(float(np.abs(want).max()) if want.size else 0.0, term_scale, 1e-30)
    assert np.abs(got.astype(np.float64) - want).max(initial=0.0) <= rel * scale


@functools.lru_cache(maxsize=None)
def case_inputs(case):
    n, p, density, fmt, dtype, seed = case
    rng = np.random.default_rng(seed)
    X = sp.random(n, p, density=density, format="csr", dtype=np.float64, random_state=rng,
                  data_rvs=lambda s: rng.standard_normal(s)).astype(dtype)
    row_mask, col_mask = rng.random(n) < 0.5, rng.random(p) < 0.5
    batches = (list(rng.integers(0, 4, n)), [f"b{i}" for i in rng.integers(0, 3, p)])
    return (X, JMatrix.from_scipy(X, fmt=fmt, dtype=dtype),
            SparseMatrix.from_scipy(X, fmt=fmt, dtype=dtype, device="cpu"),
            row_mask, col_mask, batches)


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}x{c[1]}-{c[3]}-{np.dtype(c[4]).name}"
                                             for c in CASES])
@pytest.mark.parametrize("stat", sorted(STATS))
def test_stat_matches_jax(case, stat):
    X, jm, tm, rm, cm, b = case_inputs(case)
    want = STATS[stat](jm, rm, cm, b)
    got = STATS[stat](tm, rm, cm, b)
    assert_stat_close(got, want, case[4], exact=stat in EXACT, term_scale=var_scale(X, stat))


def var_scale(X, stat):
    """2 max x^2 for a variance (a bound on its cancelling terms), else 0."""

    return 2.0 * float((X.data.astype(np.float64) ** 2).max(initial=0.0)) if "var" in stat else 0.0


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_stored_zeros_and_empty_lines(fmt):
    # explicit stored zeros count as entries; row 1 and column 3 are empty
    X = sp.csr_matrix((np.array([1.0, 0.0, 2.0, -3.0]), np.array([0, 1, 2, 0]),
                       np.array([0, 3, 3, 4])), shape=(3, 4))
    jm, tm = JMatrix.from_scipy(X, fmt=fmt), SparseMatrix.from_scipy(X, fmt=fmt, device="cpu")
    for stat in sorted(STATS):
        rm, cm = np.array([True, False, True]), np.array([True, True, False, True])
        b = ([0, 1, 1], ["a", "b", "a", "c"])
        assert_stat_close(STATS[stat](tm, rm, cm, b), STATS[stat](jm, rm, cm, b),
                          np.float64, exact=stat in EXACT, term_scale=var_scale(X, stat))
    np.testing.assert_array_equal(tm.nonzero_row().numpy(), [3, 0, 1])
    mins, maxs = tm.min_max_row()
    assert mins[1] == np.finfo(np.float64).max and maxs[1] == np.finfo(np.float64).min


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_all_zero_matrix(dtype):
    X = sp.csr_matrix((5, 4), dtype=dtype)
    jm, tm = JMatrix.from_scipy(X, dtype=dtype), SparseMatrix.from_scipy(X, dtype=dtype,
                                                                        device="cpu")
    for stat in ("sum_row", "sum_col", "var_row", "var_col", "sum_row_n_top", "nonzero_col",
                 "var_col_chunk"):
        got = STATS[stat](tm, None, None, None)
        assert_stat_close(got, STATS[stat](jm, None, None, None), dtype)
        assert not np.any(as_np(got))


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_chunk_accumulation(fmt):
    """Streaming row slabs into the chunk accumulators gives the whole
    matrix's column result, as in the JAX package."""

    X = sp.random(60, 25, density=0.2, format="csr", dtype=np.float64,
                  random_state=np.random.default_rng(9))
    acc_t = np.zeros(25)
    acc_n = np.zeros(25, np.int64)
    acc_mm = (np.full(25, np.inf), np.full(25, -np.inf))
    for r0 in range(0, 60, 20):
        part = SparseMatrix.from_scipy(X[r0:r0 + 20], fmt=fmt, device="cpu")
        jpart = JMatrix.from_scipy(X[r0:r0 + 20], fmt=fmt)
        acc_t = part.sum_col_chunk(acc_t)
        acc_n = part.nonzero_col_chunk(acc_n)
        acc_mm_j = jpart.min_max_col_chunk(acc_mm)
        acc_mm = part.min_max_col_chunk(acc_mm)
        np.testing.assert_array_equal(acc_mm[0], acc_mm_j[0])
    whole = SparseMatrix.from_scipy(X, fmt=fmt, device="cpu")
    np.testing.assert_allclose(acc_t, whole.sum_col().numpy(), rtol=1e-12)
    np.testing.assert_array_equal(acc_n, whole.nonzero_col().numpy())
    # a shorter accumulator takes the overlapping prefix, as the reference does
    short = whole.sum_row_chunk(np.zeros(10))
    np.testing.assert_allclose(short, whole.sum_row().numpy()[:10], rtol=1e-12)
    jshort = JMatrix.from_scipy(X, fmt=fmt).sum_row_chunk(np.zeros(10))
    np.testing.assert_allclose(short, jshort, rtol=1e-12)
    with pytest.raises(ValueError, match="Reference slice length"):
        whole.var_col_chunk(np.zeros(3))


def test_batch_stats_with_singletons():
    """Singleton batches: variance 0 (count <= 1), means of one entry."""

    X = sp.random(12, 9, density=0.5, format="csr", dtype=np.float64,
                  random_state=np.random.default_rng(4))
    rows = ["solo"] + ["a"] * 6 + ["b"] * 5
    cols = [0, 1, 1, 2, 2, 2, 3, 3, 4]
    jm, tm = JMatrix.from_scipy(X), SparseMatrix.from_scipy(X, device="cpu")
    for name, b in (("var_batch_row", rows), ("mean_batch_col", rows),
                    ("var_batch_col", cols), ("mean_batch_row", cols)):
        got, want = getattr(tm, name)(b), getattr(jm, name)(b)
        assert list(got) == list(want)
        assert_stat_close(got, want, np.float64, term_scale=var_scale(X, name))
    assert not tm.var_batch_row(rows)["solo"].any()


def test_n_top_ties_and_negatives():
    data = np.array([5.0, 5.0, -1.0, 5.0, -7.0, -2.0, -3.0, 0.5])
    X = sp.csr_matrix((data, np.array([0, 1, 2, 3, 0, 1, 2, 3]), np.array([0, 4, 7, 8])),
                      shape=(3, 4))
    jm, tm = JMatrix.from_scipy(X), SparseMatrix.from_scipy(X, device="cpu")
    for n in (1, 2, 3, 4, 9):
        np.testing.assert_array_equal(tm.sum_row_n_top(n).numpy(),
                                      np.asarray(jm.sum_row_n_top(n)))
    np.testing.assert_array_equal(tm.sum_row_n_top(2).numpy(), [10.0, -5.0, 0.5])


@pytest.mark.parametrize("name, length", [
    ("sum_row_masked", 36), ("sum_col_masked", 51), ("nonzero_row_masked", 38),
    ("nonzero_col_masked", 49), ("var_row_masked", 10), ("var_col_masked", 0)])
def test_mask_length_errors(small_csr, name, length):
    tm = SparseMatrix.from_scipy(small_csr, device="cpu")
    jm = JMatrix.from_scipy(small_csr)
    mask = np.ones(length, bool)
    with pytest.raises(ValueError) as te:
        getattr(tm, name)(mask)
    with pytest.raises(ValueError) as je:
        getattr(jm, name)(mask)
    assert str(te.value) == str(je.value)


def test_batch_length_error(small_csr):
    tm = SparseMatrix.from_scipy(small_csr, device="cpu")
    with pytest.raises(ValueError, match="Batch vector length"):
        tm.mean_batch_col([0] * 3)


def test_stats_stay_on_the_matrix_device(small_csr):
    tm = SparseMatrix.from_scipy(small_csr, device="cpu")
    assert tm._ell is None  # from_scipy is host-only
    out = tm.var_col()
    col = tm._transpose_cache
    assert out.device.type == "cpu" and col._ell is not None and tm._ell is None
    assert set(col.ell_build_seconds) == {"host_build", "upload"}
