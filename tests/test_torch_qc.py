"""``qc.py`` of the torch port against the JAX package.

Counts and masks are held exactly; sums to 1e-6 of the largest |truth|
(both packages reduce float32 values on their devices, in different
orders).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu import qc as jqc
from single_algebra_tpu_torch import SparseMatrix, calculate_qc_metrics, qc

SUMS = ("total_counts", "mean_counts", "pct_dropout_by_counts", "log1p_total_counts",
        "log1p_mean_counts", "log1p_n_genes_by_counts", "pct_counts_mito",
        "total_counts_mito", "log1p_total_counts_mito", "pct_counts_ribo",
        "total_counts_ribo", "log1p_total_counts_ribo")
COUNTS = ("n_genes_by_counts", "n_cells_by_counts")


def counts(n=120, p=80, seed=0, fmt="csr"):
    rng = np.random.default_rng(seed)
    X = sp.random(n, p, density=0.2, format="csr", random_state=rng,
                  data_rvs=lambda s: rng.integers(1, 60, s)).astype(np.float32).tolil()
    X[7, :] = 0  # an empty cell
    X[:, 3] = 0  # an unseen gene
    return X.tocsr() if fmt == "csr" else X.tocsc()


def both(X):
    return SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)


def assert_frames(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        assert g.shape == w.shape, key
        if key in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert key in SUMS, key
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("log1p", [True, False])
def test_calculate_qc_metrics_matches_jax(fmt, log1p):
    X = counts(fmt=fmt)
    tm, jm = both(X)
    rng = np.random.default_rng(1)
    qv = {"mito": np.arange(80) % 13 == 0, "ribo": rng.random(80) < 0.2}
    obs, var = calculate_qc_metrics(tm, qc_vars=qv, log1p=log1p)
    jobs, jvar = jqc.calculate_qc_metrics(jm, qc_vars=qv, log1p=log1p)
    assert_frames(obs, jobs)
    assert_frames(var, jvar)
    # exact against the host CSR in float64
    np.testing.assert_array_equal(obs["n_genes_by_counts"], np.diff(X.tocsr().indptr))
    np.testing.assert_array_equal(obs["total_counts"],
                                  np.asarray(X.sum(axis=1), np.float64).ravel())


def test_calculate_qc_metrics_rejects_bad_masks():
    tm, _ = both(counts())
    with pytest.raises(ValueError, match="bool mask"):
        calculate_qc_metrics(tm, qc_vars={"mito": np.ones(79, bool)})
    with pytest.raises(ValueError, match="bool mask"):
        calculate_qc_metrics(tm, qc_vars={"mito": np.ones(80)})


@pytest.mark.parametrize("kw", [dict(min_genes=10), dict(max_genes=20),
                                dict(min_counts=200, max_counts=700),
                                dict(min_genes=5, max_counts=600)])
def test_filter_cells_matches_jax(kw):
    X = counts()
    tm, jm = both(X)
    out, keep = qc.filter_cells(tm, **kw)
    jout, jkeep = jqc.filter_cells(jm, **kw)
    np.testing.assert_array_equal(keep, jkeep)
    assert 0 < keep.sum() < len(keep)
    np.testing.assert_array_equal(out.to_dense(), np.asarray(jout.to_dense()))
    np.testing.assert_array_equal(out.to_dense(), X.toarray()[keep])


@pytest.mark.parametrize("kw", [dict(min_cells=25), dict(max_cells=24),
                                dict(min_counts=700, max_counts=900)])
def test_filter_genes_matches_jax(kw):
    X = counts()
    tm, jm = both(X)
    out, keep = qc.filter_genes(tm, **kw)
    jout, jkeep = jqc.filter_genes(jm, **kw)
    np.testing.assert_array_equal(keep, jkeep)
    assert 0 < keep.sum() < len(keep)
    np.testing.assert_array_equal(out.to_dense(), X.toarray()[:, keep])
