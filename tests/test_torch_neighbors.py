"""``neighbors.py`` of the torch port against the JAX package.

Exact kNN (``knn``, ``cross_knn``, euclidean and cosine, and the
``mesh=`` branch on a 4-entry CPU mesh against the JAX 4-device mesh):
distances within 1e-5 (relative), index sets identical except among
neighbors whose distances lie within 1e-4 (relative) of the k-th (a tie
may be broken either way). ``ivf_knn`` from the JAX index's centroids:
the same neighbor sets; alone: recall at least 0.95 against exact; its
exact resolution of rows short of k candidates is reached and held.
``connectivities``: the identical CSR pattern, values within 1e-5 from
the same kNN (the JAX kNN injected). From each package's own kNN the
values are held to 1e-3: the smooth-kNN calibration divides distance
differences by sigma, so the kNN tiles' float32 rounding (distances
within 1.5e-5, from two GEMMs that add in different orders) reaches the
weights amplified (4.6e-4 relative in sigma on this data); the
calibration itself agrees to 3.4e-7 on equal input
(``tests/test_torch_umap.py``).
"""

import numpy as np
import pytest
import torch

import jax
from single_algebra_tpu import neighbors as jnb
from single_algebra_tpu.models.kmeans import KMeans as JKMeans
from single_algebra_tpu_torch import neighbors as tnb
from single_algebra_tpu_torch.parallel import make_mesh

TIE = 1e-4


def blobs(n=400, d=8, k=6, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 5.0
    labels = rng.integers(0, k, n)
    return (centers[labels] + spread * rng.standard_normal((n, d))).astype(np.float32), labels


def assert_knn(got, want, rel=1e-5):
    d, i = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in got)
    jd, ji = (np.asarray(a) for a in want)
    assert d.shape == jd.shape == i.shape
    np.testing.assert_allclose(d, jd, rtol=rel, atol=rel * np.abs(jd).max())
    # rows' id sets, among the neighbors clearly inside the k-th distance
    kth = jd[:, -1:]
    sure = jd < kth * (1 - TIE)
    assert sure.mean() > 0.5
    for row in range(len(d)):
        s = sure[row]
        assert set(i[row][d[row] < kth[row, 0] * (1 - TIE)]) == set(ji[row][s]), row


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("block", [64, 2048])
def test_knn_matches_jax(metric, block):
    x, _ = blobs(seed=1)
    got = tnb.knn(x, 10, block=block, metric=metric, device="cpu")
    assert_knn(got, jnb.knn(x, 10, block=block, metric=metric))
    idx = tnb.knn(x, 10, return_distances=False, device="cpu")
    assert not (idx.numpy() == np.arange(len(x))[:, None]).any()
    with pytest.raises(ValueError, match="k="):
        tnb.knn(x, len(x), device="cpu")


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_knn_mesh_matches_the_jax_mesh(metric):
    from jax.sharding import Mesh as JMesh

    x, _ = blobs(n=333, seed=2)
    jmesh = JMesh(np.array(jax.devices()[:4]), ("rows",))
    mesh = make_mesh(4, device="cpu")
    got = tnb.knn(x, 9, block=32, metric=metric, mesh=mesh)
    assert_knn(got, jnb.knn(x, 9, block=32, metric=metric, mesh=jmesh))
    single = tnb.knn(x, 9, metric=metric, device="cpu")
    np.testing.assert_allclose(got[0].numpy(), single[0].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("approx", [False, True])
def test_cross_knn_matches_jax(metric, approx):
    x, _ = blobs(seed=3)
    q, _ = blobs(n=90, seed=4)
    got = tnb.cross_knn(q, x, 12, block=32, metric=metric, approx=approx, device="cpu")
    assert_knn(got, jnb.cross_knn(q, x, 12, block=32, metric=metric))
    with pytest.raises(ValueError, match="feature counts"):
        tnb.cross_knn(q[:, :3], x, 2, device="cpu")


def jax_centroids(x, L, seed):
    """The centroids ``jnb.ivf_knn`` builds (its sample and KMeans)."""

    n = len(x)
    rng = np.random.default_rng(seed)
    sample = x[rng.choice(n, min(n, 50 * L), replace=False)]
    km = JKMeans(n_clusters=L, n_init=1, max_iter=15, random_seed=seed).fit(sample)
    return np.array(km.cluster_centers_, np.float32)


@pytest.mark.parametrize("query", [False, True])
@pytest.mark.parametrize("n_probe", [3, None])
def test_ivf_from_the_same_centroids_matches_jax(query, n_probe):
    x, _ = blobs(n=600, seed=5)
    q = blobs(n=70, seed=6)[0] if query else None
    L, npr = tnb._ivf_plan(len(x), 12, n_probe)
    cent = jax_centroids(x, L, seed=2)
    index = tnb._IvfIndex(torch.from_numpy(x), torch.from_numpy(cent))
    got = tnb._ivf_query(index, None if q is None else torch.from_numpy(q), 10, npr, 512)
    want = jnb.ivf_knn(x, 10, query=q, n_lists=12, n_probe=n_probe, seed=2)
    assert_knn(got, want)
    assert index.cap == np.bincount(np.asarray(_jax_assign(x, cent)), minlength=L).max()


def _jax_assign(x, cent):
    km = JKMeans(len(cent))
    km.cluster_centers_ = cent
    return km.predict(x)


def test_ivf_short_rows_resolved_exactly_as_jax():
    """One probe into lists of a handful of rows: many queries see fewer
    than k candidates and take the exact resolution (the JAX package's
    sentinel branch)."""

    x, _ = blobs(n=120, d=4, seed=7, spread=3.0)
    L, npr = tnb._ivf_plan(len(x), 40, 1)
    cent = jax_centroids(x, L, seed=0)
    index = tnb._IvfIndex(torch.from_numpy(x), torch.from_numpy(cent))
    raw_d, raw_i = index.search(torch.from_numpy(x), torch.arange(len(x)), k=6, n_probe=npr)
    short = (raw_i < 0).any(dim=1).numpy()
    assert short.sum() > 10  # the branch is reached
    assert np.isinf(raw_d.numpy()[raw_i.numpy() < 0]).all()
    got = tnb._ivf_query(index, None, 6, npr, 512)
    want = jnb.ivf_knn(x, 6, n_lists=40, n_probe=1, seed=0)
    assert_knn(got, want)
    exact = tnb.knn(x, 6, device="cpu")
    np.testing.assert_allclose(got[0].numpy()[short], exact[0].numpy()[short], rtol=1e-5)
    assert (got[1].numpy() >= 0).all()
    assert not (got[1].numpy() == np.arange(len(x))[:, None]).any()


def test_ivf_knn_recall_against_exact():
    x, _ = blobs(n=3000, d=10, k=20, seed=8)
    d, i = tnb.ivf_knn(x, 15, device="cpu")
    ed, ei = tnb.knn(x, 15, device="cpu")
    hits = [len(set(a) & set(b)) for a, b in zip(i.numpy(), ei.numpy())]
    assert np.sum(hits) / ei.numel() >= 0.95
    assert (np.diff(d.numpy(), axis=1) >= 0).all()
    again = tnb.ivf_knn(x, 15, device="cpu")
    np.testing.assert_array_equal(again[1].numpy(), i.numpy())


def assert_graph(S, jS, tol=1e-3):
    S, jS = S.tocsr(), jS.tocsr()
    S.sort_indices(), jS.sort_indices()
    np.testing.assert_array_equal(S.indptr, jS.indptr)
    np.testing.assert_array_equal(S.indices, jS.indices)
    np.testing.assert_allclose(S.data, jS.data, rtol=tol, atol=tol)
    assert abs(S - S.T).max() == 0


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_connectivities_match_jax(metric):
    x, _ = blobs(n=300, seed=9)
    S = tnb.connectivities(x, 12, metric=metric, device="cpu")
    assert_graph(S, jnb.connectivities(x, 12, metric=metric))


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_connectivities_from_the_jax_knn_match_jax(metric, monkeypatch):
    import jax.numpy as jnp

    from single_algebra_tpu.models import umap as ju
    from single_algebra_tpu_torch.models import umap as tu

    def jax_knn(X, *, k, block):
        d, i = ju._knn_graph(jnp.asarray(X.numpy()), k=k, block=block)
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(i))

    monkeypatch.setattr(tu, "_knn_graph", jax_knn)
    x, _ = blobs(n=300, seed=9)
    S = tnb.connectivities(x, 12, metric=metric, device="cpu")
    assert_graph(S, jnb.connectivities(x, 12, metric=metric), tol=1e-5)


def test_connectivities_mesh_match_the_jax_mesh_and_the_single_card():
    from jax.sharding import Mesh as JMesh

    x, _ = blobs(n=250, seed=10)
    jmesh = JMesh(np.array(jax.devices()[:4]), ("rows",))
    S = tnb.connectivities(x, 10, block=16, mesh=make_mesh(4, device="cpu"))
    assert_graph(S, jnb.connectivities(x, 10, block=16, mesh=jmesh))
    assert_graph(S, tnb.connectivities(x, 10, device="cpu"))


def test_connectivities_ivf_method():
    x, _ = blobs(n=500, seed=11)
    S = tnb.connectivities(x, 10, method="ivf", device="cpu")
    E = tnb.connectivities(x, 10, method="exact", device="cpu")
    # recall 1 on these blobs: the exact graph, distances computed per list
    assert_graph(S, E)
    with pytest.raises(ValueError, match="Unknown kNN method"):
        tnb.connectivities(x, 10, method="annoy", device="cpu")


@pytest.mark.parametrize("trim", [None, 5])
def test_bbknn_matches_jax(trim):
    x, _ = blobs(n=240, seed=12)
    b = np.random.default_rng(13).choice(["p", "q", "r"], len(x))
    S = tnb.bbknn(x, b, neighbors_within_batch=3, trim=trim, device="cpu")
    assert_graph(S, jnb.bbknn(x, b, neighbors_within_batch=3, trim=trim))
