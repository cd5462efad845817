"""``models/umap.py`` of the torch port against the JAX package.

The JAX package draws each epoch's edge gates and negatives from
``jax.random``; the port's epochs take theirs as arguments. These tests
replay the JAX keys (``split`` / ``uniform`` / ``randint`` as the JAX
epoch calls them) and feed the draws to the port: one layout epoch
within 1e-5 of max |update|, 20 float64 epochs from the JAX start within
1e-4 of max |Y|, ``transform`` through ``UMAP.from_state`` within 1e-4 of max
|Y|. ``_smooth_knn``'s rho and sigma within 1e-5 relative, ``_fit_ab``
to 1e-12, the PCA init up to each column's sign within 1e-5 (of max
|Y0|). Whole fits, with the port's own draws, by cluster separation and
bit-for-bit repeats.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from single_algebra_tpu import neighbors as jnb
from single_algebra_tpu.models import umap as ju
from single_algebra_tpu_torch.models import UMAP, UMAPConfig
from single_algebra_tpu_torch.models import umap as tu


def blobs(n=240, d=10, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 8.0
    labels = rng.integers(0, k, n)
    return (centers[labels] + rng.standard_normal((n, d))).astype(np.float32), labels


def separation(y, labels):
    cs = np.unique(labels)
    cents = np.stack([y[labels == c].mean(0) for c in cs])
    within = np.mean([np.linalg.norm(y[labels == c] - cents[i], axis=1).mean()
                      for i, c in enumerate(cs)])
    d = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1)
    return d[np.triu_indices(len(cs), 1)].min() / max(within, 1e-12)


def jax_edges(S):
    """The JAX fit's edge arrays from a fuzzy graph (``UMAP.fit_transform``)."""

    S = S.tocoo()
    keep = S.data > 1e-8
    h = S.row[keep].astype(np.int32)
    t = S.col[keep].astype(np.int32)
    tperm = np.argsort(t, kind="stable").astype(np.int32)
    w = S.data[keep]
    return (jnp.asarray(h), jnp.asarray(t), jnp.asarray((w / w.max()).astype(np.float32)),
            jnp.asarray(tperm), jnp.asarray(t[tperm]))


def jax_layout_draws(key, weights, m, n, neg_rate):
    """One JAX layout epoch's draws, as ``_layout_chunk`` makes them."""

    key, k1, k2 = jax.random.split(key, 3)
    active = jax.random.uniform(k1, (m,)) < weights
    negs = jax.random.randint(k2, (m, neg_rate), 0, n)
    return key, torch.from_numpy(np.array(active)), torch.from_numpy(np.array(negs, np.int64))


def test_fit_ab_is_the_jax_fit():
    for spread, md in ((1.0, 0.1), (1.5, 0.5), (0.8, 0.01)):
        np.testing.assert_allclose(tu._fit_ab(spread, md), ju._fit_ab(spread, md), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_smooth_knn_matches_jax(seed):
    x, _ = blobs(seed=seed)
    d, _ = ju._knn_graph(jnp.asarray(x), k=15, block=64)
    d = np.array(d)
    d[3] = 0.0  # a point with all neighbors coincident: rho 0, sigma floored
    rho, sigma = tu._smooth_knn(torch.from_numpy(d))
    jrho, jsigma = (np.asarray(a) for a in ju._smooth_knn(jnp.asarray(d)))
    np.testing.assert_allclose(rho.numpy(), jrho, rtol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), jsigma, rtol=1e-5)


def test_fuzzy_connectivities_from_the_same_knn(monkeypatch):
    x, _ = blobs(seed=2)

    def jax_knn(X, *, k, block):
        d, i = ju._knn_graph(jnp.asarray(X.numpy()), k=k, block=block)
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(i))

    monkeypatch.setattr(tu, "_knn_graph", jax_knn)
    S = tu.fuzzy_connectivities(x, 10, block=64, method="exact", device="cpu")
    jS = ju.fuzzy_connectivities(jnp.asarray(x), 10, block=64, method="exact")
    S.sort_indices(), jS.sort_indices()
    np.testing.assert_array_equal(S.indptr, jS.indptr)
    np.testing.assert_array_equal(S.indices, jS.indices)
    np.testing.assert_allclose(S.data, jS.data, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graph():
    x, labels = blobs(seed=3)
    S = jnb.connectivities(x, 10)
    n = len(x)
    return x, labels, S, tu._edges_of(S, n, "cpu"), jax_edges(S)


def test_one_layout_epoch_matches_jax(graph):
    x, _, S, ed, (h, t, w, tperm, ts) = graph
    n, m = len(x), len(ed.heads)
    a, b = ju._fit_ab(1.0, 0.1)
    Y0 = np.random.default_rng(4).standard_normal((n, 2)).astype(np.float32) * 5
    key = jax.random.PRNGKey(7)
    Y1 = ju._layout_chunk(jnp.array(Y0), h, t, w, tperm, ts, key, jnp.int32(0), jnp.int32(1),
                          n=n, n_epochs=200, neg_rate=5, a=a, b=b, lr=1.0)[0]
    _, active, negs = jax_layout_draws(key, w, m, n, 5)
    got = tu._layout_epoch(torch.from_numpy(Y0), ed, active, negs, 1.0, a, b)
    upd, jupd = got.numpy() - Y0, np.asarray(Y1) - Y0
    assert np.abs(upd - jupd).max() <= 1e-5 * np.abs(jupd).max()


def jax_start(x, seed):
    """The JAX fit's ``Y0``: its PCA init plus its noise."""

    X = jnp.asarray(x)
    Xc = X - X.mean(axis=0, keepdims=True)
    _, _, vt = jnp.linalg.svd(Xc[:4096], full_matrices=False)
    Y0 = Xc @ vt[:2].T
    Y0 = Y0 / (jnp.std(Y0) + 1e-9) * 10.0
    return np.array(Y0 + 0.1 * jax.random.normal(jax.random.PRNGKey(seed), Y0.shape))


def test_twenty_epochs_from_the_jax_start_match_jax(graph):
    """In float64: the layout amplifies a rounding difference about
    tenfold an epoch (each float32 epoch agrees to 2e-6 from the same
    start), and the JAX package's jitted float64 epoch differs from the
    same epoch evaluated op by op by up to 5e-7 on this data (the port
    agrees with the op-by-op evaluation to 2e-15)."""

    x, _, S, ed, (h, t, w, tperm, ts) = graph
    n, m = len(x), len(ed.heads)
    a, b = ju._fit_ab(1.0, 0.1)
    Y0 = jax_start(x, 42).astype(np.float64)
    key = jax.random.PRNGKey(43)
    want = np.asarray(ju._optimize_layout(jnp.array(Y0), h, t, w, tperm, ts, key, n=n,
                                          n_epochs=20, neg_rate=5, a=a, b=b, lr=1.0))
    Y = torch.from_numpy(Y0)
    for e in range(20):
        key, active, negs = jax_layout_draws(key, w, m, n, 5)
        Y = tu._layout_epoch(Y, ed, active, negs, tu._alpha(1.0, e, 20), a, b)
    assert np.abs(Y.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_pca_init_matches_jax_up_to_signs():
    x, _ = blobs(n=300, seed=6)
    Y0 = tu._pca_init(torch.from_numpy(x), 2).numpy()
    X = jnp.asarray(x)
    Xc = X - X.mean(axis=0, keepdims=True)
    _, _, vt = jnp.linalg.svd(Xc, full_matrices=False)
    jY = np.asarray(Xc @ vt[:2].T)
    jY = jY / (jY.std() + 1e-9) * 10.0
    signs = np.sign((Y0 * jY).sum(axis=0))
    assert np.abs(Y0 - jY * signs).max() <= 1e-5 * np.abs(jY).max()
    again = tu._pca_init(torch.from_numpy(-x), 2).numpy()  # the sign rule: fixed signs
    np.testing.assert_allclose(again, -Y0, rtol=1e-5, atol=1e-4)


def test_transform_from_jax_state_matches_jax(monkeypatch):
    x, _ = blobs(seed=7)
    xn = blobs(n=30, seed=8)[0]
    cfg = UMAPConfig(n_epochs=30, random_seed=3)
    jm = ju.UMAP(ju.UMAPConfig(n_epochs=30, random_seed=3))
    jm.fit_transform(x)
    want = np.asarray(jm.transform(xn, epochs=12))

    def replay(Ynew, Ytrain, idx, w, gen, *, epochs, neg_rate, a, b, lr):
        key = jax.random.PRNGKey(cfg.random_seed + 2)
        m, k = w.shape
        Y = Ynew
        for e in range(epochs):
            key, k1, k2 = jax.random.split(key, 3)
            active = torch.from_numpy(np.array(jax.random.uniform(k1, (m, k))
                                               < jnp.asarray(w.numpy())))
            negs = torch.from_numpy(np.array(
                jax.random.randint(k2, (m, neg_rate), 0, Ytrain.shape[0]), np.int64))
            Y = tu._transform_epoch(Y, Ytrain, idx, active, negs, tu._alpha(lr, e, epochs),
                                   a, b)
        return Y

    monkeypatch.setattr(tu, "_transform_layout", replay)
    m = UMAP.from_state(np.asarray(jm.embedding_), jm._train_X, cfg, device="cpu")
    got = m.transform(xn, epochs=12).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_fit_transform_separates_and_repeats(metric):
    x, labels = blobs(n=300, seed=9)
    cfg = UMAPConfig(n_epochs=120, metric=metric, random_seed=1)
    Y = UMAP(cfg, device="cpu").fit_transform(x)
    assert tuple(Y.shape) == (300, 2) and torch.isfinite(Y).all()
    assert separation(Y.numpy(), labels) > 2.0
    again = UMAP(cfg, device="cpu").fit_transform(x)
    assert torch.equal(Y, again)
    Yn = UMAP(cfg, device="cpu")
    Yn.fit_transform(x)
    placed = Yn.transform(x[:20], epochs=10)
    assert tuple(placed.shape) == (20, 2) and torch.isfinite(placed).all()


def test_more_components_than_input_dims():
    x, _ = blobs(n=80, d=2, seed=10)
    Y = UMAP(n_components=3, n_epochs=10, device="cpu").fit_transform(x)
    assert tuple(Y.shape) == (80, 3) and torch.isfinite(Y).all()
    with pytest.raises(RuntimeError, match="fitted"):
        UMAP(device="cpu").transform(x)
    with pytest.raises(ValueError, match="metric"):
        UMAPConfig(metric="manhattan")
