"""The three scanpy recipes of the torch port against the JAX package.

``Z`` within 1e-5 of max |Z|; every mask of ``info`` identical, and the
HVG scores within 1e-5 (the HVG step's cutoffs are ranked on data whose
margin ``tests/test_torch_feature_selection.py`` discusses; here a
different mask would change Z's shape and fail the case outright).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu import recipes as jrec
from single_algebra_tpu_torch import SparseMatrix, recipe_pearson_residuals, recipe_seurat
from single_algebra_tpu_torch import recipe_zheng17


def counts(n=300, p=260, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.lognormal(-0.5, 1.3, p)
    prog = rng.gamma(0.7, 1.0, (5, p))
    X = rng.poisson(base[None, :] * prog[rng.integers(0, 5, n)]).astype(np.float32)
    X[:, 7] = 0  # a gene no cell expresses
    X[11, :] = 0  # an empty cell
    return sp.csr_matrix(X)


def check(got, want, keys):
    (Z, info), (jZ, jinfo) = got, want
    Z, jZ = Z.cpu().numpy(), np.asarray(jZ)
    assert Z.shape == jZ.shape and np.isfinite(Z).all()
    assert np.abs(Z - jZ).max() <= 1e-5 * np.abs(jZ).max()
    for key in keys:
        np.testing.assert_array_equal(info[key], jinfo[key], err_msg=key)
    h, jh = info["hvg"], jinfo["hvg"]
    np.testing.assert_array_equal(h.mask, jh.mask)
    for f in ("means", "dispersions", "dispersions_norm"):
        g, w = np.asarray(getattr(h, f), np.float64), np.asarray(getattr(jh, f), np.float64)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-5 * np.abs(w[fin]).max())


@pytest.mark.parametrize("log", [True, False])
def test_recipe_zheng17_matches_jax(log):
    X = counts()
    got = recipe_zheng17(SparseMatrix.from_scipy(X, device="cpu"), n_top_genes=80, log=log)
    want = jrec.recipe_zheng17(JMatrix.from_scipy(X), n_top_genes=80, log=log)
    check(got, want, ("gene_mask", "counts_mask"))
    assert got[1]["target_sum"] == pytest.approx(want[1]["target_sum"], rel=1e-7)
    assert got[0].shape == (300, 80)


def test_recipe_seurat_matches_jax():
    X = counts(seed=1)
    got = recipe_seurat(SparseMatrix.from_scipy(X, device="cpu"), min_genes=40, min_cells=3)
    want = jrec.recipe_seurat(JMatrix.from_scipy(X), min_genes=40, min_cells=3)
    check(got, want, ("cell_mask", "gene_mask", "counts_mask"))
    assert 0 < got[1]["cell_mask"].sum() < X.shape[0]


@pytest.mark.parametrize("batched", [False, True])
def test_recipe_pearson_residuals_matches_jax(batched):
    X = counts(seed=2)
    b = np.random.default_rng(3).choice(["x", "y"], X.shape[0]) if batched else None
    kw = dict(n_top_genes=60, min_genes=40, min_cells=3, batches=b)
    got = recipe_pearson_residuals(SparseMatrix.from_scipy(X, device="cpu"), **kw)
    want = jrec.recipe_pearson_residuals(JMatrix.from_scipy(X), **kw)
    check(got, want, ("cell_mask", "gene_mask", "counts_mask"))
    with pytest.raises(ValueError, match="batches length"):
        recipe_pearson_residuals(SparseMatrix.from_scipy(X, device="cpu"), min_genes=40,
                                 batches=np.zeros(5))
