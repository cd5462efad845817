"""``models/lsi.py`` of the torch port against the JAX package.

The JAX randomized SVD draws its sketch from ``jax.random``; the tests
feed that sketch to the port by monkeypatching
``linalg.svd.gaussian_sketch``. From the same sketch, on the same engine
('sparse', the CPU's ``auto``; 'dense'; and 'tiled', whose
``tiled_ell_spmm_t`` / ``tiled_ell_rmv_t`` run as their plain versions
here and as the JAX package's Pallas kernels in interpret mode), the
singular values and explained-variance ratios agree within 1e-5 of the
largest |JAX| value on every engine, and so do the scores and components
on 'sparse' (exact float32 products). On 'dense' and 'tiled' the power
iterations ride bf16 products: where the two packages' float32 operands
fall on either side of a bf16 rounding boundary, the sketched subspace
moves by up to 2e-4 (seen on a few seeds), so the scores and components
there are held within 1e-3.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.linalg import svd as tsvd
from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator
from single_algebra_tpu_torch.models import LSIResult, lsi
from tests.test_lsi import _atac_counts

jlsi = importlib.import_module("single_algebra_tpu.models.lsi")


@pytest.fixture
def jax_sketch(monkeypatch):
    def sketch(p, l, seed, *, dtype, device):
        key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        omega = np.array(jax.random.normal(key, (p, l), dtype=jnp.float32))
        return torch.from_numpy(omega).to(device=device, dtype=dtype)

    monkeypatch.setattr(tsvd, "gaussian_sketch", sketch)


def programs(n=400, p=300, k=6, seed=0, density=0.15):
    """Binary accessibility of ``k`` planted programs with geometric
    abundances: a gapped spectrum (a flat one leaves the randomized
    solve's tail undetermined)."""

    rng = np.random.default_rng(seed)
    open_ = rng.random((k, p)) < 0.25
    w = np.geomspace(1, 0.15, k)
    lab = rng.choice(k, n, p=w / w.sum())
    X = (rng.random((n, p)) < density * open_[lab]).astype(np.float32)
    return sp.csr_matrix(X), lab


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def assert_same(got: LSIResult, want, vec_tol=1e-5):
    assert isinstance(got, LSIResult) and got.n_components == want.n_components
    for f in ("singular_values", "explained_variance_ratio"):
        assert rel(getattr(got, f), getattr(want, f)) <= 1e-5, f
    for f in ("scores", "components"):
        assert rel(getattr(got, f), getattr(want, f)) <= vec_tol, f


@pytest.mark.parametrize("engine, drop_first, seeds", [
    ("sparse", True, (1, 2, 3)),
    ("sparse", False, (1, 2)),
    ("dense", True, (1, 2)),
    ("dense", False, (3,)),
    ("tiled", True, (2,)),  # the JAX kernels run in interpret mode: slow
])
def test_lsi_from_the_jax_sketch_matches_jax(engine, drop_first, seeds, jax_sketch):
    for seed in seeds:
        X, _ = programs(seed=seed)
        kw = dict(engine=engine, drop_first=drop_first, seed=3)
        got = lsi(SparseMatrix.from_scipy(X, device="cpu"), 3, **kw)
        want = jlsi.lsi(JMatrix.from_scipy(X), 3, **kw)
        assert_same(got, want, 1e-5 if engine == "sparse" else 1e-3)


@pytest.mark.parametrize("opts", [
    dict(log_tf=False, log_idf=False, log_tfidf=True),
    dict(scale_embeddings=False, n_power_iterations=2, n_oversamples=4),
])
def test_lsi_options_match_jax(opts, jax_sketch):
    X, _ = programs(seed=2)
    got = lsi(SparseMatrix.from_scipy(X, device="cpu"), 3, **opts)
    want = jlsi.lsi(JMatrix.from_scipy(X), 3, **opts)
    assert_same(got, want)


def test_pre_transformed_input_and_tiled_engine(jax_sketch):
    from single_algebra_tpu_torch.preprocess import tfidf

    X, lab = programs(n=500, p=900, seed=3, density=0.05)
    m = SparseMatrix.from_scipy(X, device="cpu")
    x = tfidf(m)
    a = lsi(m, 5, engine="tiled")
    b = lsi(x, 5, apply_tfidf=False, engine="tiled")
    np.testing.assert_allclose(a.singular_values, b.singular_values, rtol=1e-6)
    op = x._operator_cache["tiled"]
    assert isinstance(op, TiledSparseOperator) and op.tdata_lo is not None  # TF-IDF: hi + lo
    from single_algebra_tpu_torch.metrics import adjusted_rand_index
    from single_algebra_tpu_torch.models import KMeans

    pred = KMeans(6, n_init=5, random_seed=0, device="cpu").fit(a.scores.astype(np.float32))
    assert adjusted_rand_index(lab, pred.labels_.numpy()) > 0.9


def test_validation():
    m = SparseMatrix.from_scipy(sp.csr_matrix(_atac_counts(n=20, p=10)), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        lsi(m, 10)
    with pytest.raises(ValueError, match="log_tfidf"):
        lsi(m, 3, log_tfidf=True)
    assert "LSIResult(n_components=3" in repr(lsi(m, 3))
