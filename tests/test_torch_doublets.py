"""``doublets.py`` of the torch port against the JAX package.

Both packages draw the simulated pairs with ``np.random.default_rng``;
the PCA is ``SparsePCABuilder``'s defaults (Lanczos), whose start vector
the JAX package draws from ``jax.random``: the tests feed it to the
port's ``lanczos_svd`` (``v0=``). From there the two planted components
of the observed embedding agree within 1e-5 of the largest |JAX| value;
the other 13 are directions of a flat noise spectrum that the Lanczos
tolerance (1e-6) leaves undetermined at ~1e-5, held within 1e-4. The
scores count simulated neighbors: a near-tie of the union kNN under
those differences moves one cell's count by one (1-2 of 550 cells
here), so at least 99 % of the scores and calls are equal and the rest
within one neighbor's weight; the threshold within 1e-3.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu_torch import SparseMatrix, scrublet
from single_algebra_tpu_torch.models import pca as tpca
from tests.test_doublets import _counts_with_doublets

jdb = importlib.import_module("single_algebra_tpu.doublets")
tdb = importlib.import_module("single_algebra_tpu_torch.doublets")


@pytest.fixture
def jax_v0(monkeypatch):
    real = tpca.lanczos_svd

    def start_from_jax(op, k, steps=None, seed=42, tol=None, v0=None, info=None):
        key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        v0 = torch.from_numpy(np.array(jax.random.normal(key, (op.shape[1],), jnp.float32)))
        return real(op, k, steps=steps, seed=seed, tol=tol, v0=v0.to(op.device), info=info)

    monkeypatch.setattr(tpca, "lanczos_svd", start_from_jax)


@pytest.mark.parametrize("seed", [1])
def test_scrublet_from_the_jax_start_matches_jax(seed, jax_v0):
    X, is_doub = _counts_with_doublets(seed=seed)
    kw = dict(n_top_genes=300, n_comps=15, seed=seed)
    got = scrublet(SparseMatrix.from_scipy(X, device="cpu"), **kw)
    want = jdb.scrublet(JMatrix.from_scipy(X), **kw)
    scale = np.abs(want.embedding).max()
    assert np.abs(got.embedding[:, :2] - want.embedding[:, :2]).max() <= 1e-5 * scale
    assert np.abs(got.embedding - want.embedding).max() <= 1e-4 * scale
    k_adj = round(round(0.5 * np.sqrt(X.shape[0])) * 3)  # sim ratio 2: r = 2
    q = (np.arange(k_adj + 1) + 1.0) / (k_adj + 2.0)
    ladder = 0.06 * q / 2 / (0.06 * q / 2 + 0.94 * (1 - q))  # score of c simulated neighbors
    for a, b in ((got.doublet_scores, want.doublet_scores), (got.sim_scores, want.sim_scores)):
        assert np.mean(a == b) >= 0.99
        ca = np.abs(a[:, None] - ladder[None, :]).argmin(axis=1)
        cb = np.abs(b[:, None] - ladder[None, :]).argmin(axis=1)
        assert np.abs(ca - cb).max() <= 1
    assert abs(got.threshold - want.threshold) <= 1e-3
    assert np.mean(got.predicted == want.predicted) >= 0.99
    order = np.argsort(got.doublet_scores)
    ranks = np.empty(len(order))
    ranks[order] = np.arange(len(order))
    n1, n0 = is_doub.sum(), (~is_doub).sum()
    assert (ranks[is_doub].sum() - n1 * (n1 - 1) / 2) / (n1 * n0) > 0.9


def test_scrublet_all_genes_threshold_and_verbose(jax_v0, capsys):
    X, _ = _counts_with_doublets(n_per=60, p=120, n_doub=12, seed=2)
    kw = dict(n_top_genes=500, n_comps=8, threshold=0.3, k=6)
    got = scrublet(SparseMatrix.from_scipy(X, device="cpu"), verbose=True, **kw)
    want = jdb.scrublet(JMatrix.from_scipy(X), **kw)
    np.testing.assert_array_equal(got.doublet_scores, want.doublet_scores)
    assert got.threshold == 0.3 and "[scrublet] simulate" in capsys.readouterr().err
    assert "ScrubletResult(predicted=" in repr(got)


def test_auto_threshold_and_validation():
    rng = np.random.default_rng(3)
    s = np.concatenate([rng.normal(0.1, 0.02, 300), rng.normal(0.8, 0.05, 100)])
    assert tdb._auto_threshold(s) == jdb._auto_threshold(s)
    assert tdb._auto_threshold(np.full(5, 0.2)) == 0.2
    X, _ = _counts_with_doublets(n_per=8, p=30, n_doub=2)
    with pytest.raises(ValueError, match="at least 10"):
        scrublet(SparseMatrix.from_scipy(X[:9], device="cpu"))
    with pytest.raises(ValueError, match="expected_doublet_rate"):
        scrublet(SparseMatrix.from_scipy(X, device="cpu"), expected_doublet_rate=1.0)
