"""``models/kmeans.py`` of the torch port against the JAX package.

The JAX package draws its k-means++ seeds from ``jax.random``; the port
from a ``torch.Generator``. So Lloyd is held from the JAX init's centers
(``_plusplus_init`` with the JAX fit's key): labels identical, centers
within 1e-5 (of max |center|), inertia within 1e-5 relative. The same
for the ``mesh=`` branch on a 4-entry CPU mesh against the JAX 4-device
mesh, for ``predict`` / ``transform`` through ``KMeans.from_state``, and
for one minibatch step. The port's own draws are held by what a fit
finds on planted blobs.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu.models import kmeans as jkm
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.models import KMeans, KMeansBuilder
from single_algebra_tpu_torch.models import kmeans as tkm
from single_algebra_tpu_torch.parallel import make_mesh


def blobs(n=300, d=6, k=5, seed=0, spread=1.5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 6.0
    labels = rng.integers(0, k, n)
    return (centers[labels] + spread * rng.standard_normal((n, d))).astype(np.float32), labels


def count_blobs(n=200, p=40, k=4, seed=0):
    rng = np.random.default_rng(seed)
    lam = rng.gamma(1.0, 2.0, (k, p)) * (rng.random((k, p)) < 0.4)
    labels = rng.integers(0, k, n)
    return sp.csr_matrix(rng.poisson(lam[labels]).astype(np.float32)), labels


def ari(a, b):
    from scipy.special import comb

    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(table, (ai, bi), 1)
    s = comb(table, 2).sum()
    sa, sb = comb(table.sum(1), 2).sum(), comb(table.sum(0), 2).sum()
    exp = sa * sb / comb(len(a), 2)
    return (s - exp) / (0.5 * (sa + sb) - exp)


def assert_fit(got, want, labels_too=True):
    C, labels, inertia, n_iter = got
    jC, jlabels, jinertia, jn_iter = want
    jC = np.asarray(jC)
    assert np.abs(C.cpu().numpy() - jC).max() <= 1e-5 * np.abs(jC).max()
    if labels_too:
        np.testing.assert_array_equal(labels.cpu().numpy(), np.asarray(jlabels))
    assert inertia == pytest.approx(float(jinertia), rel=1e-5)
    assert n_iter == int(jn_iter)


def jax_fit_one(jX, key, k, max_iter, tol=1e-4, w=None):
    """The JAX fit's ``_fit_one`` and its init's centers (same key)."""

    jX = jkm._prep(jX)
    x2 = jkm._row_sq_norms(jX).astype(jnp.float32)
    n = jkm._n_of(jX)
    w = jnp.ones((n,), jnp.float32) if w is None else w
    tol2 = jkm.KMeans(k, tol=tol)._tol2(jX)
    C0 = jkm._plusplus_init(key, jX, x2, w, k)
    return jkm._fit_one(jX, x2, tol2, key, w, k=k, max_iter=max_iter), np.array(C0), tol2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lloyd_from_jax_init_matches_jax_dense(seed):
    x, _ = blobs(seed=seed)
    (jout, C0, tol2) = jax_fit_one(x, jax.random.PRNGKey(seed), 5, 300)
    X = torch.from_numpy(x)
    got = tkm._lloyd(X, tkm._row_sq_norms(X), float(tol2), torch.from_numpy(C0),
                     torch.ones(len(x)), k=5, max_iter=300)
    assert_fit(got, jout)


def test_lloyd_from_jax_init_matches_jax_sparse():
    X, _ = count_blobs()
    jm = JMatrix.from_scipy(X)
    (jout, C0, tol2) = jax_fit_one(jm, jax.random.PRNGKey(4), 4, 100)
    tm = SparseMatrix.from_scipy(X, device="cpu")
    got = tkm._lloyd(tm, tkm._row_sq_norms(tm), float(tol2), torch.from_numpy(C0),
                     torch.ones(X.shape[0]), k=4, max_iter=100)
    assert_fit(got, jout)
    assert float(tol2) == pytest.approx(KMeans(4, device="cpu")._tol2(tm), rel=1e-6)


def test_lloyd_reseeds_empty_clusters_as_jax():
    x, _ = blobs(n=120, k=3, seed=5)
    X = torch.from_numpy(x)
    C0 = np.asarray(x[:4]).copy()
    C0[3] = 1e4  # no point is nearest: the cluster starts empty
    jX = jnp.asarray(x)
    x2 = jkm._row_sq_norms(jX)
    tol2 = jkm.KMeans(4)._tol2(jX)

    def jax_lloyd(key_unused):  # _fit_one with its init replaced by C0
        orig = jkm._plusplus_init
        jkm._plusplus_init = lambda *a: jnp.asarray(C0)
        try:
            jkm._fit_one.clear_cache()
            return jkm._fit_one(jX, x2, tol2, jax.random.PRNGKey(0),
                                jnp.ones(len(x), jnp.float32), k=4, max_iter=50)
        finally:
            jkm._plusplus_init = orig
            jkm._fit_one.clear_cache()

    want = jax_lloyd(None)
    got = tkm._lloyd(X, tkm._row_sq_norms(X), float(tol2), torch.from_numpy(C0),
                     torch.ones(len(x)), k=4, max_iter=50)
    assert_fit(got, want)
    assert (np.bincount(got[1].numpy(), minlength=4) > 0).all()
    meshed = tkm._lloyd_mesh(make_mesh(4, device="cpu"), X, tkm._row_sq_norms(X), float(tol2),
                             torch.from_numpy(C0), k=4, max_iter=50)
    assert_fit(meshed, want)


def test_mesh_lloyd_matches_the_jax_mesh():
    from jax.sharding import Mesh as JMesh

    x, _ = blobs(n=203, seed=6)  # not a multiple of 4: padded slabs
    jmesh = JMesh(np.array(jax.devices()[:4]), ("rows",))
    jfit = jkm.KMeans(5, mesh=jmesh, random_seed=3).fit(x)
    # the JAX mesh fit's init: _plusplus_init over the padded rows
    n, pad = len(x), (-len(x)) % 4
    xp = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
    wp = jnp.concatenate([jnp.ones(n), jnp.zeros(pad)]).astype(jnp.float32)
    C0 = jkm._plusplus_init(jax.random.PRNGKey(3), jnp.asarray(xp),
                            jkm._row_sq_norms(jnp.asarray(xp)), wp, 5)
    X = torch.from_numpy(x)
    tol2 = float(jkm.KMeans(5)._tol2(jnp.asarray(x)))
    got = tkm._lloyd_mesh(make_mesh(4, device="cpu"), X, tkm._row_sq_norms(X), tol2,
                          torch.from_numpy(np.array(C0)), k=5, max_iter=300)
    assert_fit(got, (jfit.cluster_centers_, jfit.labels_, jfit.inertia_, jfit.n_iter_))
    # and the single-card Lloyd from the same centers
    single = tkm._lloyd(X, tkm._row_sq_norms(X), tol2, torch.from_numpy(np.array(C0)),
                        torch.ones(n), k=5, max_iter=300)
    assert_fit(got, single)


def test_mesh_fit_equals_the_single_card_fit():
    x, labels = blobs(n=250, seed=7)
    single = KMeans(5, random_seed=1, device="cpu").fit(x)
    mesh = KMeans(5, random_seed=1, mesh=make_mesh(4, device="cpu")).fit(x)
    assert_fit((mesh.cluster_centers_, mesh.labels_, mesh.inertia_, mesh.n_iter_),
               (single.cluster_centers_, single.labels_, single.inertia_, single.n_iter_))
    with pytest.raises(ValueError, match="dense inputs"):
        KMeans(3, mesh=make_mesh(2, device="cpu")).fit(
            SparseMatrix.from_scipy(sp.csr_matrix(x), device="cpu"))


@pytest.mark.parametrize("sparse_in", [False, True])
def test_predict_and_transform_from_jax_state(sparse_in):
    if sparse_in:
        X, _ = count_blobs(seed=8)
        jX, tX = JMatrix.from_scipy(X), SparseMatrix.from_scipy(X, device="cpu")
    else:
        x, _ = blobs(seed=8)
        jX, tX = x, x
    jfit = jkm.KMeans(4, random_seed=2).fit(jX)
    m = KMeans.from_state(np.asarray(jfit.cluster_centers_), device="cpu")
    np.testing.assert_array_equal(m.predict(tX).numpy(), np.asarray(jfit.predict(jX)))
    T, jT = m.transform(tX).numpy(), np.asarray(jfit.transform(jX))
    assert np.abs(T - jT).max() <= 1e-5 * np.abs(jT).max()
    assert m.score(tX) == pytest.approx(jfit.score(jX), rel=1e-5)


def test_minibatch_step_matches_jax():
    x, _ = blobs(n=160, seed=9)
    jfit = jkm.KMeans(5, random_seed=0).fit(x[:80])
    C = np.asarray(jfit.cluster_centers_)
    jm = jkm.KMeans(5)
    jm.cluster_centers_, jm._counts, jm.n_iter_ = jnp.asarray(C), jnp.zeros(5), 0
    tm = KMeans.from_state(C, device="cpu")
    for batch in (x[80:120], x[120:]):
        jm.partial_fit(batch)
        tm.partial_fit(batch)
        jC = np.asarray(jm.cluster_centers_)
        assert np.abs(tm.cluster_centers_.numpy() - jC).max() <= 1e-5 * np.abs(jC).max()
        np.testing.assert_array_equal(tm.labels_.numpy(), np.asarray(jm.labels_))
        assert tm.inertia_ == pytest.approx(jm.inertia_, rel=1e-5)
    np.testing.assert_allclose(tm._counts.numpy(), np.asarray(jm._counts))


def test_save_load_across_packages(tmp_path):
    x, _ = blobs(seed=10)
    jfit = jkm.KMeans(4).fit(x)
    jfit.save(str(tmp_path / "j"))
    m = KMeans.load(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(m.cluster_centers_.numpy(), np.asarray(jfit.cluster_centers_))
    assert m.n_iter_ == jfit.n_iter_ and m.inertia_ == jfit.inertia_
    m.save(str(tmp_path / "t"))
    back = jkm.KMeans.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(back.cluster_centers_), m.cluster_centers_.numpy())


@pytest.mark.parametrize("sparse_in", [False, True])
def test_fit_recovers_planted_clusters(sparse_in):
    if sparse_in:
        X, labels = count_blobs(n=300, seed=11)
        X = SparseMatrix.from_scipy(X, device="cpu")
        k = 4
    else:
        X, labels = blobs(n=400, seed=11, spread=0.5)
        k = 5
    m = KMeansBuilder().n_clusters(k).n_init(3).random_seed(5).device("cpu").build()
    m.fit(X)
    assert ari(m.labels_.numpy(), labels) > 0.95
    again = KMeans(k, n_init=3, random_seed=5, device="cpu").fit(X)
    np.testing.assert_array_equal(again.labels_.numpy(), m.labels_.numpy())
    np.testing.assert_array_equal(m.fit_predict(X).numpy(), m.predict(X).numpy())
    with pytest.raises(ValueError, match="exceeds"):
        KMeans(10_000, device="cpu").fit(X)
