"""t-SNE of the torch port against the JAX package (``models/tsne.py``).

t-SNE is chaotic: coordinates of two correct implementations part ways
after a few dozen epochs. So each function is held at a fixed input, a
short descent from the JAX package's start ``y0`` is held in float64,
and whole runs by how well they separate planted clusters. Tolerances:
kNN distances 1e-5 relative (float32 tiles), the calibrations 1e-10 in
float64 and 1e-5 in float32 (of the largest probability), gradients
1e-10 of max |g| in float64, 20 epochs of descent 1e-8 in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from single_algebra_tpu.models import tsne as jt
from single_algebra_tpu.models.umap import _knn_graph as j_knn_graph
from single_algebra_tpu_torch.models import tsne
from single_algebra_tpu_torch.models.umap import _knn_graph


def make_clusters(n_per=40, n_clusters=3, d=10, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)) * 12.0
    pts = [centers[c] + rng.standard_normal((n_per, d)) for c in range(n_clusters)]
    return np.vstack(pts).astype(np.float32), np.repeat(np.arange(n_clusters), n_per)


def separation(y, labels):
    """Closest pair of cluster centroids over the mean within-cluster
    radius."""

    cs = np.unique(labels)
    cents = np.stack([y[labels == c].mean(0) for c in cs])
    within = np.mean([np.linalg.norm(y[labels == c] - cents[i], axis=1).mean()
                      for i, c in enumerate(cs)])
    d = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1)
    return d[np.triu_indices(len(cs), 1)].min() / max(within, 1e-12)


def jax_y0(n, config, dtype):
    key = jax.random.PRNGKey(config.seed)
    return np.array(1e-4 * jax.random.normal(key, (n, config.output_dim), dtype))


def rel_max(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def random_knn(n, k, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(np.delete(np.arange(n), i), size=k, replace=False)
                    for i in range(n)]).astype(np.int32)
    p = rng.random((n, k))
    return p / p.sum(1, keepdims=True), idx


@pytest.mark.parametrize("n,k,block", [(200, 9, 64), (200, 9, 2048), (97, 30, 16)])
def test_knn_graph_matches_jax(n, k, block):
    x = np.random.default_rng(n).standard_normal((n, 12)).astype(np.float32)
    d, idx = _knn_graph(torch.from_numpy(x), k=k, block=block)
    dj, ij = (np.asarray(a) for a in j_knn_graph(jnp.asarray(x), k=k, block=block))
    d, idx = d.numpy(), idx.numpy()
    assert idx.dtype == np.int32 and d.shape == (n, k)
    np.testing.assert_allclose(d, dj, rtol=1e-5)
    # ids where the order is unambiguous: the distance differs from both
    # neighbours in the sorted row (ties may be ordered differently)
    gap = np.diff(dj, axis=1) > 1e-4 * dj[:, 1:]
    clear = np.ones_like(gap[:, :1])
    sure = np.concatenate([clear, gap], 1) & np.concatenate([gap, clear], 1)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(idx[sure], ij[sure])
    assert not (idx == np.arange(n)[:, None]).any()  # self excluded


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_calibrate_p_matches_jax(dtype, tol):
    x, _ = make_clusters(n_per=30, seed=1)
    x = x.astype(dtype)
    d2 = tsne._sq_dists(torch.from_numpy(x))
    d2j = jt._sq_dists(jnp.asarray(x))
    assert rel_max(d2.numpy(), d2j) <= tol
    p = tsne._calibrate_p(d2, 10.0).numpy()
    pj = np.asarray(jt._calibrate_p(jnp.asarray(d2.numpy()), jnp.asarray(10.0, dtype)))
    assert p.dtype == dtype
    assert rel_max(p, pj) <= tol
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=10 * tol)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_calibrate_p_knn_matches_jax(dtype, tol):
    x, _ = make_clusters(n_per=30, seed=2)
    d, _ = _knn_graph(torch.from_numpy(x), k=24, block=32)
    d2 = (d.to(torch.float64 if dtype == np.float64 else torch.float32)) ** 2
    p = tsne._calibrate_p_knn(d2, 8.0).numpy()
    pj = np.asarray(jt._calibrate_p_knn(jnp.asarray(d2.numpy()), jnp.asarray(8.0, dtype)))
    assert p.dtype == dtype
    assert rel_max(p, pj) <= tol


def test_symmetrize_knn_matches_jax():
    p, idx = random_knn(57, 9, seed=0)
    got = tsne._symmetrize_knn(p, idx, 57)
    want = jt._symmetrize_knn(p, idx, 57)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    src = got[0]
    assert len(src) % 4096 == 0 and (np.diff(src) >= 0).all()


@pytest.mark.parametrize("block", [16, 57, 128])
def test_knn_grad_matches_jax(block):
    """The edge attraction plus blocked repulsion, at block sizes that do
    and do not divide n, against the JAX function in float64."""

    n, dim = 57, 2
    p, idx = random_knn(n, 9, seed=0)
    src, dst, val = jt._symmetrize_knn(p, idx, n)
    y = np.random.default_rng(1).standard_normal((n, dim))
    g = tsne._knn_grad(
        torch.from_numpy(y), torch.from_numpy(src.astype(np.int64)),
        torch.from_numpy(dst.astype(np.int64)), torch.from_numpy(val), 3.0, block=block,
    ).numpy()
    gj = np.asarray(jt._knn_grad(y, src, dst, val, np.float64(3.0), block=block))
    assert rel_max(g, gj) <= 1e-10


def test_exact_grad_matches_dense_formula():
    """The exact-mode gradient (a closure inside the JAX program, so held
    to the formula here) against a direct numpy evaluation in float64."""

    rng = np.random.default_rng(3)
    n = 40
    P = rng.random((n, n))
    P = (P + P.T) / (2 * n * n)
    np.fill_diagonal(P, 1e-12)
    y = rng.standard_normal((n, 2))
    g = tsne._exact_grad(torch.from_numpy(y), torch.from_numpy(P), 12.0).numpy()
    d2 = ((y[:, None] - y[None]) ** 2).sum(-1)
    num = 1.0 / (1.0 + d2)
    np.fill_diagonal(num, 0.0)
    q = np.maximum(num / num.sum(), 1e-12)
    ref = 4 * (((12.0 * P - q) * num)[:, :, None] * (y[:, None] - y[None])).sum(1)
    assert rel_max(g, ref) <= 1e-10


def test_exact_affinities_match_jax():
    x, _ = make_clusters(n_per=20, seed=4)
    x = x.astype(np.float64)
    cfg = tsne.TSNEConfig(perplexity=9.0)
    p = tsne._exact_affinities(torch.from_numpy(x), cfg).numpy()
    pc = np.asarray(jt._calibrate_p(jt._sq_dists(jnp.asarray(x)), jnp.asarray(9.0)))
    pj = np.maximum((pc + pc.T) / (2.0 * len(x)), 1e-12)
    assert rel_max(p, pj) <= 1e-10


def test_exact_descent_matches_jax_from_its_start():
    """20 epochs of the exact program from the JAX package's y0, inside
    the early-exaggeration phase and past its switch (epoch 10). At 60
    points the two part by 3e-6 after 20 epochs from 2e-15 after one (the
    dynamics amplify roundoff ~10x an epoch there); at 180 they stay
    within 1e-10."""

    x, _ = make_clusters(n_per=60, seed=5)
    x = x.astype(np.float64)
    cfg = tsne.TSNEConfig(perplexity=15.0, epochs=20, exaggeration_epochs=10)
    jcfg = jt.TSNEConfig(perplexity=15.0, epochs=20, exaggeration_epochs=10)
    y0 = jax_y0(len(x), jcfg, jnp.float64)
    y = tsne._run_exact(torch.from_numpy(x), cfg, torch.from_numpy(y0)).numpy()
    yj = np.asarray(jt._tsne_jit(jnp.asarray(x), jcfg))
    assert rel_max(y, yj) <= 1e-8


def test_knn_descent_matches_jax_from_its_start():
    """20 epochs of the knn-mode descent over one edge list from the JAX
    package's y0 (the JAX epoch-chunk program, two chunks), across the
    exaggeration switch."""

    n = 120
    p, idx = random_knn(n, 12, seed=6)
    src, dst, val = jt._symmetrize_knn(p, idx, n)
    cfg = tsne.TSNEConfig(epochs=20, exaggeration_epochs=7)
    jcfg = jt.TSNEConfig(epochs=0, exaggeration_epochs=7)
    y0 = jax_y0(n, jcfg, jnp.float64)
    state = (jnp.asarray(y0), jnp.zeros_like(y0), jnp.ones_like(y0))
    for i0, i1 in ((0, 13), (13, 20)):
        state = jt._knn_epoch_chunk(state, jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(val), jnp.int32(i0), jnp.int32(i1), jcfg)
    block = tsne._knn_block(n, cfg)
    assert block == 128
    ts, td, tv = (torch.from_numpy(a.astype(np.int64 if a.dtype == np.int32 else a.dtype))
                  for a in (src, dst, val))
    y = tsne._descent(lambda yy, exag: tsne._knn_grad(yy, ts, td, tv, exag, block=block),
                      torch.from_numpy(y0), cfg).numpy()
    assert rel_max(y, state[0]) <= 1e-8


def test_knn_affinities_match_jax():
    """The whole knn-mode setup (graph, calibration, symmetrization)
    against the JAX package's pieces on the same data."""

    x = np.random.default_rng(7).standard_normal((90, 12))
    cfg = tsne.TSNEConfig(perplexity=8.0)
    src, dst, val, lengths = tsne._knn_affinities(torch.from_numpy(x), cfg)
    k = 24
    dj, ij = j_knn_graph(jnp.asarray(x, jnp.float32), k=k, block=min(2048, len(x)))
    pj = jt._calibrate_p_knn(jnp.asarray(dj, jnp.float64) ** 2, jnp.asarray(8.0))
    sj, dj_, vj = jt._symmetrize_knn(np.asarray(pj), np.asarray(ij), len(x))
    np.testing.assert_array_equal(src.numpy(), sj)
    np.testing.assert_array_equal(dst.numpy(), dj_)
    assert val.dtype == torch.float64
    # float32 distances underneath (1e-5 relative, see the kNN graph
    # test), which the calibration's beta amplifies
    assert rel_max(val.numpy(), vj) <= 1e-4
    np.testing.assert_array_equal(lengths.numpy(), np.bincount(sj, minlength=len(x)))


@pytest.mark.parametrize("mode", ["exact", "knn"])
def test_run_separates_clusters(mode):
    """300 epochs: neither package separates these blobs by this measure
    within 50 (both stay near 1 there)."""

    x, labels = make_clusters(n_per=60, n_clusters=3)
    cfg = tsne.TSNEConfig(perplexity=15.0, epochs=300, exaggeration_epochs=100, mode=mode)
    y = tsne.run(x, cfg, device="cpu")
    assert y.device.type == "cpu" and tuple(y.shape) == (180, 2)
    assert torch.isfinite(y).all()
    assert separation(y.numpy(), labels) > 3.0


def test_run_is_deterministic_and_auto_picks_exact():
    x, _ = make_clusters(n_per=15, n_clusters=2)
    cfg = tsne.TSNEConfig(perplexity=6.0, epochs=30)
    y1 = tsne.run(x, cfg, device="cpu")
    torch.testing.assert_close(y1, tsne.run(x, cfg, device="cpu"), rtol=0, atol=0)
    y_exact = tsne.run(x, tsne.TSNEConfig(perplexity=6.0, epochs=30, mode="exact"),
                       device="cpu")
    torch.testing.assert_close(y1, y_exact, rtol=0, atol=0)
    y_knn = tsne.run(x, tsne.TSNEConfig(perplexity=6.0, epochs=30, exact_max_n=16),
                     device="cpu")
    torch.testing.assert_close(
        y_knn, tsne.run(x, tsne.TSNEConfig(perplexity=6.0, epochs=30, mode="knn"),
                        device="cpu"), rtol=0, atol=0)


def test_run_f32_f64_entry_points():
    x, _ = make_clusters(n_per=20, n_clusters=2)
    cfg = tsne.TSNEConfig(perplexity=8.0, epochs=20)
    assert tsne.run_f32(x, cfg, device="cpu").dtype == torch.float32
    y64 = tsne.run_f64(x.astype(np.float64), cfg, device="cpu")
    assert y64.dtype == torch.float64 and torch.isfinite(y64).all()
    knn = tsne.TSNEConfig(perplexity=8.0, epochs=20, mode="knn")
    assert tsne.run_f64(x, knn, device="cpu").dtype == torch.float64


def test_run_validation():
    x = np.random.default_rng(0).standard_normal((20, 5)).astype(np.float32)
    with pytest.raises(ValueError, match="perplexity"):
        tsne.run(x, tsne.TSNEConfig(perplexity=30.0), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tsne.run(x.ravel(), device="cpu")
    y, _ = make_clusters(n_per=40, n_clusters=2)
    with pytest.raises(ValueError, match="mode"):
        tsne.run(y, tsne.TSNEConfig(perplexity=10.0, mode="bogus"), device="cpu")
    with pytest.raises(ValueError, match="knn_k"):
        tsne.run(y, tsne.TSNEConfig(perplexity=20.0, mode="knn", knn_k=10), device="cpu")


def test_config_carries_every_jax_field():
    import dataclasses

    names = [f.name for f in dataclasses.fields(tsne.TSNEConfig)]
    assert names == [f.name for f in dataclasses.fields(jt.TSNEConfig)]
    assert tsne.TSNEConfig() == tsne.TSNEConfig(**dataclasses.asdict(jt.TSNEConfig()))


def test_run_defaults_to_the_card():
    x, _ = make_clusters(n_per=20, n_clusters=2)
    if torch.cuda.is_available():
        assert tsne.run(x, tsne.TSNEConfig(perplexity=8.0, epochs=5)).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tsne.run(x, tsne.TSNEConfig(perplexity=8.0, epochs=5))


# -- the mesh mode -------------------------------------------------------------


def _mesh_layout(ndev, n, cfg):
    """The JAX mesh mode's slab rows and repulsion block (``_run_knn``)."""

    rs = max(-(-n // ndev), 8)
    block = min(cfg.repulsion_block, max(rs // 8 // 8 * 8, 8))
    return -(-rs // block) * block, block


def test_partition_edges_by_slab_matches_jax():
    from single_algebra_tpu.models.draw_graph import partition_edges_by_slab as jpart
    from single_algebra_tpu_torch.models.draw_graph import partition_edges_by_slab

    p, idx = random_knn(150, 10, seed=3)
    src, dst, val = jt._symmetrize_knn(p, idx, 150)
    for ndev, rs in ((1, 152), (3, 56), (8, 24)):
        got = partition_edges_by_slab(src, dst, val, len(src), ndev, rs)
        for a, b in zip(got, jpart(src, dst, val, len(src), ndev, rs)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_knn_mesh_descent_matches_jax_from_its_start(ndev):
    """20 epochs of the mesh mode from the JAX package's y0 over one edge
    list, against the JAX mesh program (two epoch chunks across the
    exaggeration switch) on the JAX 8-device CPU mesh."""

    from single_algebra_tpu.models.draw_graph import partition_edges_by_slab as jpart
    from single_algebra_tpu.parallel import make_mesh as jmake_mesh
    from single_algebra_tpu_torch.parallel import make_mesh

    n = 210
    p, idx = random_knn(n, 12, seed=6)
    src, dst, val = jt._symmetrize_knn(p, idx, n)
    cfg = tsne.TSNEConfig(epochs=20, exaggeration_epochs=7)
    jcfg = jt.TSNEConfig(epochs=0, exaggeration_epochs=7)
    rs, block = _mesh_layout(ndev, n, cfg)
    es, ed, ev = jpart(src, dst, val, len(src), ndev, rs)
    y0 = jax_y0(n, jcfg, jnp.float64)
    state = (jnp.pad(jnp.asarray(y0), ((0, ndev * rs - n), (0, 0))),
             jnp.zeros((ndev, rs, 2)), jnp.ones((ndev, rs, 2)))
    for i0, i1 in ((0, 13), (13, 20)):
        state = jt._knn_epoch_chunk_mesh(
            state, jnp.asarray(es), jnp.asarray(ed), jnp.asarray(ev), jnp.int32(i0),
            jnp.int32(i1), jcfg, block, rs, n, jmake_mesh(ndev), "rows")
    lay = tsne._KnnMesh.build(src, dst, val, n, make_mesh(ndev, device="cpu"), cfg,
                              torch.float64)
    assert (lay.rs, lay.block) == (rs, block)
    y = tsne._descent_mesh(lay, torch.from_numpy(y0), cfg).numpy()
    assert rel_max(y, state[0][:n]) <= 1e-8


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_knn_mesh_grad_matches_single_device(ndev):
    """The mesh gradient (slab attraction, masked slab repulsion, Z
    reduced over the slabs) is the single-device knn gradient, to 1e-10 of
    max |g| in float64, and repeats bit for bit."""

    from single_algebra_tpu_torch.parallel import make_mesh

    n = 200
    p, idx = random_knn(n, 9, seed=2)
    src, dst, val = jt._symmetrize_knn(p, idx, n)
    cfg = tsne.TSNEConfig()
    lay = tsne._KnnMesh.build(src, dst, val, n, make_mesh(ndev, device="cpu"), cfg,
                              torch.float64)
    y = torch.from_numpy(np.random.default_rng(4).standard_normal((n, 2)) * 5.0)
    g = tsne._knn_grad_mesh(lay, y, 12.0)
    ts, td = (torch.from_numpy(a.astype(np.int64)) for a in (src, dst))
    g1 = tsne._knn_grad(y, ts, td, torch.from_numpy(val), 12.0, block=64)
    assert rel_max(g.numpy(), g1.numpy()) <= 1e-10
    assert torch.equal(g, tsne._knn_grad_mesh(lay, y, 12.0))


@pytest.mark.parametrize("ndev", [1, 8])
def test_knn_mode_mesh_matches_local(ndev):
    """``run(mesh=)`` separates the clusters as the single-device run does,
    and the two agree over short runs, before float32 drift compounds."""

    from single_algebra_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(31)
    X = np.concatenate([rng.normal(c * 12, 1.0, size=(70, 6)) for c in range(3)]).astype(
        np.float32)
    labels = np.repeat(np.arange(3), 70)
    cfg = tsne.TSNEConfig(mode="knn", perplexity=12.0, epochs=300, exaggeration_epochs=40,
                          dispatch_chunk=75)
    mesh = make_mesh(ndev, device="cpu")
    y_local = tsne.run(X, cfg, device="cpu")
    y_mesh = tsne.run(X, cfg, mesh=mesh)
    assert y_mesh.shape == y_local.shape and y_mesh.device == mesh.home
    assert torch.isfinite(y_mesh).all()
    assert separation(y_mesh.numpy(), labels) > 3.0
    cfg5 = tsne.TSNEConfig(mode="knn", perplexity=12.0, epochs=5, exaggeration_epochs=40)
    np.testing.assert_allclose(tsne.run(X, cfg5, device="cpu").numpy(),
                               tsne.run(X, cfg5, mesh=mesh).numpy(), rtol=5e-3, atol=1e-5)
    # a mesh forces the knn mode (this n would take 'exact' under 'auto')
    y = tsne.run(X, tsne.TSNEConfig(perplexity=12.0, epochs=3), mesh=mesh)
    y_knn = tsne.run(X, tsne.TSNEConfig(perplexity=12.0, epochs=3, mode="knn"), mesh=mesh)
    assert torch.equal(y, y_knn)
