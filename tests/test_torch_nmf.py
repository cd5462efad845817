"""``models/nmf.py`` of the torch port against the JAX package.

Each random part is held on its own:

- NNDSVD / NNDSVDa from a given ``(u, s, vt)``: the port's ``_nndsvd``
  against the JAX ``_init_wh`` with its randomized SVD replaced by the same
  triplets, 1e-12 relative.
- ``_mu_loop`` from a given ``W0, H0``: the gather engine against the JAX
  ``_LocalEllOp`` and the densified engine (compensated products) against
  the JAX ``DensifiedOperator``; float64 1e-9 of max |W|, |H| and the
  same iteration count; float32 1e-4.
- ``fit_transform`` with the JAX sketch replayed into the port's
  randomized SVD (``linalg.svd.gaussian_sketch``): float64 1e-8 of max
  |W| and |H|, the same iteration count, reconstruction error 1e-6
  relative; float32 at a fixed iteration count, within 1e-4 of the JAX
  run beyond its own distance to float64 (see the test).
- ``transform`` under the JAX model's programs: float64 1e-9.
- The 'random' init: its scale and its seeded determinism (``torch``
  draws, not ``jax.random``'s).
- The mesh on ``make_mesh(8, device="cpu")`` against the single device at
  the JAX test's bars (reconstruction error 1e-2, ``W H`` 2e-2), and the
  JAX tests' recovery, sklearn, Frobenius and validation bars.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu.linalg.operators import DensifiedOperator as JDensified
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.linalg.operators import DensifiedOperator, SparseOperator
from single_algebra_tpu_torch.models import NMF
from single_algebra_tpu_torch.parallel import make_mesh
from tests.test_nmf import _planted
from tests.test_torch_parallel import inject_sketch, jax_normal

jnmf = importlib.import_module("single_algebra_tpu.models.nmf")
tnmf = importlib.import_module("single_algebra_tpu_torch.models.nmf")


def both(X, dtype):
    Xs = sp.csr_matrix(np.asarray(X, dtype))
    return SparseMatrix.from_scipy(Xs, device="cpu"), JMatrix.from_scipy(Xs)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("init", ["nndsvd", "nndsvda"])
def test_nndsvd_from_a_given_svd_matches_jax(init, monkeypatch):
    from single_algebra_tpu import linalg as jlinalg
    from single_algebra_tpu.linalg.svd import SvdResult

    X, _, _ = _planted(n=90, p=40, k=4, seed=1)
    tm, jm = both(X, np.float64)
    u, s, vt = np.linalg.svd(X, full_matrices=False)
    k = 4
    fixed = SvdResult(u=jnp.asarray(u[:, :k]), s=jnp.asarray(s[:k]), vt=jnp.asarray(vt[:k]))
    monkeypatch.setattr(jlinalg, "randomized_svd", lambda *a, **kw: fixed)
    jW, jH = jnmf.NMF(k, init=init)._init_wh(jm, jnp.float64, op=object())
    fill = tnmf._mean(tm) if init == "nndsvda" else None
    W, H = tnmf._nndsvd(u[:, :k], s[:k], vt[:k], fill)
    assert rel(W, jW) <= 1e-12 and rel(H, jH) <= 1e-12
    assert (W > 0).all() and (H > 0).all()


def jax_local_op(jm):
    n, p = jm.shape
    mr, mc = jm._layout_for("row"), jm._layout_for("col")
    return jnmf._LocalEllOp(mr.ell_data, mr.ell_ids, mc.ell_data, mc.ell_ids, (n, p))


# the densified engine holds float32 matrices only, in both packages
@pytest.mark.parametrize("engine,dtype,tol_rel", [
    ("gather", np.float64, 1e-9), ("gather", np.float32, 1e-4), ("dense", np.float32, 1e-4)])
def test_mu_loop_from_a_given_start_matches_jax(engine, dtype, tol_rel):
    X, _, _ = _planted(n=120, p=60, k=3, seed=2)
    tm, jm = both(X, dtype)
    rng = np.random.default_rng(0)
    W0 = rng.random((120, 3)).astype(dtype)
    H0 = rng.random((3, 60)).astype(dtype)
    x_sq = float((X.astype(dtype).astype(np.float64) ** 2).sum())
    if engine == "gather":
        jop, top = jax_local_op(jm), SparseOperator.from_matrix(tm)
    else:
        jop, top = JDensified.from_matrix(jm), DensifiedOperator.from_matrix(tm)
    jW, jH, jloss, jit = jnmf._mu_loop(jop, jnp.asarray(W0), jnp.asarray(H0),
                                       jnp.asarray(x_sq, dtype), jnp.asarray(1e-6, dtype), 60)
    W, H, loss, it = tnmf._mu_loop(top, torch.from_numpy(W0), torch.from_numpy(H0),
                                   torch.tensor(x_sq, dtype=torch.from_numpy(W0).dtype), 1e-6, 60)
    assert it == int(jit)
    assert rel(W, jW) <= tol_rel and rel(H, jH) <= tol_rel
    np.testing.assert_allclose(float(loss), float(jloss), rtol=100 * tol_rel)


def fit_both(X, dtype, monkeypatch, **kw):
    tm, jm = both(X, dtype)
    inject_sketch(monkeypatch, jax_normal((X.shape[1], kw["n_components"] + 10), 42, dtype))
    k = kw.pop("n_components")
    jmodel = jnmf.NMF(k, **kw)
    model = NMF(k, **kw)
    return model, model.fit_transform(tm), jmodel, jmodel.fit_transform(jm)


@pytest.mark.parametrize("init", ["nndsvd", "nndsvda"])
def test_fit_transform_with_the_jax_sketch_matches_jax(init, monkeypatch):
    X, _, _ = _planted(n=150, p=70, k=3, seed=3)
    model, W, jmodel, jW = fit_both(X, np.float64, monkeypatch, n_components=3, init=init,
                                    max_iter=300, tol=1e-8)
    assert model.engine_ == "SparseOperator"
    assert W.dtype == np.float64 and model.components_.shape == (3, 70)
    assert model.n_iter_ == jmodel.n_iter_
    assert rel(W, jW) <= 1e-8 and rel(model.components_, jmodel.components_) <= 1e-8
    np.testing.assert_allclose(model.reconstruction_err_, jmodel.reconstruction_err_, rtol=1e-6)


@pytest.mark.parametrize("init", ["nndsvd", "nndsvda"])
def test_float32_fit_transform_matches_jax_within_its_distance_to_float64(init, monkeypatch):
    """At a fixed iteration count (``tol=0``): in float32 the loss is
    ``||X||^2 - 2 <W, X H^T> + ...``, whose cancellation at a small residual
    makes the stopping iteration noise in both packages; and NNDSVD's exact
    zero tests ("W == 0") flip on rounding, so each float32 run sits ~1e-3
    from float64. The port is held within 1e-4 of the JAX run beyond the
    JAX run's own distance to the port's float64 run."""

    X, _, _ = _planted(n=150, p=70, k=3, seed=3)
    model, W, jmodel, jW = fit_both(X, np.float32, monkeypatch, n_components=3, init=init,
                                    max_iter=100, tol=0.0)
    _, W64, _, _ = fit_both(X, np.float64, monkeypatch, n_components=3, init=init,
                            max_iter=100, tol=0.0)
    assert W.dtype == np.float32 and model.n_iter_ == jmodel.n_iter_ == 100
    assert rel(W, W64) <= 5e-3
    assert rel(W, jW) <= rel(jW, W64) + 1e-4


def test_transform_matches_jax():
    X, _, _ = _planted(n=110, p=50, k=3, seed=4)
    tm, jm = both(X, np.float64)
    jmodel = jnmf.NMF(3, max_iter=200, tol=1e-10).fit(jm)
    model = NMF(3, tol=1e-10)
    model.components_ = np.asarray(jmodel.components_)  # the same programs
    assert rel(model.transform(tm), jmodel.transform(jm)) <= 1e-9
    assert rel(model.transform(tm, max_iter=7), jmodel.transform(jm, max_iter=7)) <= 1e-9


def test_random_init_scale_and_determinism():
    X, _, _ = _planted(n=400, p=200, k=4, seed=5)
    tm, _ = both(X, np.float32)
    model = NMF(4, init="random", seed=3)
    W, H = model._init_wh(tm, torch.float32)
    scale = np.sqrt(X.astype(np.float32).mean() / 4)
    for a in (W, H):
        a = a.numpy()
        assert a.min() >= 0 and a.max() <= scale * (1 + 1e-6)
        assert abs(a.mean() / (scale / 2) - 1) < 0.05  # uniform on [0, scale)
    W2, H2 = NMF(4, init="random", seed=3)._init_wh(tm, torch.float32)
    assert torch.equal(W, W2) and torch.equal(H, H2)
    W3, _ = NMF(4, init="random", seed=4)._init_wh(tm, torch.float32)
    assert not torch.equal(W, W3)


def test_nmf_recovers_planted_error():
    X, _, _ = _planted()
    model = NMF(4, max_iter=400, tol=1e-9)
    W = model.fit_transform(SparseMatrix.from_dense(X, device="cpu"))
    assert W.shape == (300, 4) and model.components_.shape == (4, 120)
    assert (W >= 0).all() and (model.components_ >= 0).all()
    assert model.reconstruction_err_ / np.linalg.norm(X) < 0.08


def test_nmf_loss_vs_sklearn():
    from sklearn.decomposition import NMF as SKNMF

    X, _, _ = _planted(seed=1)
    ours = NMF(4, max_iter=300, tol=1e-8, init="nndsvda").fit(SparseMatrix.from_dense(X, device="cpu"))
    ref = SKNMF(4, solver="mu", init="nndsvda", max_iter=300, tol=1e-8, random_state=0).fit(X)
    assert ours.reconstruction_err_ <= ref.reconstruction_err_ * 1.02


def test_nmf_reconstruction_err_is_true_frobenius():
    X, _, _ = _planted(n=120, p=60, seed=2)
    model = NMF(3, max_iter=150, tol=0.0)
    W = model.fit_transform(SparseMatrix.from_dense(X, device="cpu"))
    direct = np.linalg.norm(X - W @ model.components_)
    np.testing.assert_allclose(model.reconstruction_err_, direct, rtol=1e-4, atol=1e-6)
    assert model.n_iter_ == 150


@pytest.mark.parametrize("init", ["nndsvd", "nndsvda", "random"])
def test_nmf_inits_converge(init):
    X, _, _ = _planted(n=150, p=80, k=3, seed=3)
    model = NMF(3, init=init, max_iter=250, tol=1e-7)
    W = model.fit_transform(SparseMatrix.from_dense(X, device="cpu"))
    assert np.isfinite(W).all()
    assert model.reconstruction_err_ / np.linalg.norm(X) < 0.2
    assert model.n_iter_ >= 2


def test_nmf_transform_matches_fit_usages():
    X, _, _ = _planted(n=200, p=90, k=3, seed=4)
    m = SparseMatrix.from_dense(X, device="cpu")
    model = NMF(3, max_iter=400, tol=1e-10)
    W_fit = model.fit_transform(m)
    W_new = model.transform(m)
    err_fit = np.linalg.norm(X - W_fit @ model.components_)
    err_new = np.linalg.norm(X - W_new @ model.components_)
    assert err_new <= err_fit * 1.05


def test_nmf_validation():
    X, _, _ = _planted(n=40, p=20, k=2, seed=5)
    m = SparseMatrix.from_dense(X, device="cpu")
    with pytest.raises(ValueError, match="n_components"):
        NMF(0)
    with pytest.raises(ValueError, match="init"):
        NMF(2, init="bogus")
    with pytest.raises(ValueError, match="max_iter"):
        NMF(2, max_iter=0)
    with pytest.raises(ValueError, match="non-negative"):
        NMF(2).fit(SparseMatrix.from_dense(X - 0.5, device="cpu"))
    with pytest.raises(TypeError):
        NMF(2).fit_transform(X)
    with pytest.raises(ValueError, match="n_components"):
        NMF(30).fit(m)
    with pytest.raises(ValueError, match="not fitted"):
        NMF(2).transform(m)
    fitted = NMF(2, max_iter=20).fit(m)
    with pytest.raises(ValueError, match="columns"):
        fitted.transform(SparseMatrix.from_dense(X[:, :10], device="cpu"))
    with pytest.raises(TypeError):
        fitted.transform(X)


@pytest.mark.parametrize("nd", [1, 8])
def test_nmf_mesh_matches_single_device(nd):
    X, _, _ = _planted(n=160, p=70, k=3, seed=6)
    m = SparseMatrix.from_dense(X.astype(np.float32), device="cpu")
    local = NMF(3, max_iter=80, tol=1e-9)
    W_local = local.fit_transform(m)
    sharded = NMF(3, max_iter=80, tol=1e-9, mesh=make_mesh(nd, device="cpu"))
    W_mesh = sharded.fit_transform(m)
    assert sharded.engine_ == "ShardedSpMM"
    np.testing.assert_allclose(sharded.reconstruction_err_, local.reconstruction_err_, rtol=1e-2)
    R_local = W_local @ local.components_
    R_mesh = W_mesh @ sharded.components_
    assert np.linalg.norm(R_mesh - R_local) / np.linalg.norm(R_local) < 0.02


def test_nmf_mesh_float64_matches_the_jax_mesh(monkeypatch):
    from single_algebra_tpu.parallel import make_mesh as jmake_mesh

    X, _, _ = _planted(n=160, p=70, k=3, seed=7)
    tm, jm = both(X, np.float64)
    inject_sketch(monkeypatch, jax_normal((70, 13), 42, np.float64))
    jW = jnmf.NMF(3, max_iter=60, tol=1e-9, mesh=jmake_mesh(8)).fit_transform(jm)
    W = NMF(3, max_iter=60, tol=1e-9, mesh=make_mesh(8, device="cpu")).fit_transform(tm)
    assert rel(W, jW) <= 1e-8


def test_engine_choice_reuses_one_payload_for_the_init(monkeypatch):
    """On a CUDA float32 matrix whose dense form fits, the MU products run
    on ``make_engine_operator(m, 'dense')``, which the NNDSVD init's
    'auto' engine then reuses (one payload)."""

    from single_algebra_tpu_torch.models import pca as tpca

    X, _, _ = _planted(n=100, p=40, k=3, seed=8)
    tm, _ = both(X, np.float32)
    model = NMF(3, max_iter=30)
    calls = []
    real = tpca.make_engine_operator
    monkeypatch.setattr(tpca, "make_engine_operator",
                        lambda m, engine="auto": calls.append(engine) or real(m, engine))
    model.fit(tm)
    # on the CPU the gather engine runs the products and the init's 'auto'
    # ('sparse' off the card) reuses it
    assert calls == ["sparse", "auto"] and model.engine_ == "SparseOperator"
    assert tm._operator_cache["auto"] is tm._operator_cache["sparse"]
