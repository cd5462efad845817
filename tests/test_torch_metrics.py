"""``metrics.py`` of the torch port against the JAX package.

The same seeded numpy inputs go through both packages (the port on the
CPU). Float32 device outputs (silhouettes, Moran's I / Geary's C, the
densities) agree within 1e-5 of the largest |JAX| value; ARI and NMI
within 1e-10 relative; the kBET acceptance and the batch silhouette
within their float32 rounding; LISI within 1e-5 from the JAX kNN and
1e-4 from each package's own (see its test). The mesh silhouette (four
CPU slabs) is the JAX 4-device mesh's.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import metrics as jm
from single_algebra_tpu.neighbors import connectivities as jconn
from single_algebra_tpu_torch import metrics as tm
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.parallel import make_mesh


def blobs(n=400, d=8, k=4, seed=0, spread=5.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    labels = rng.integers(0, k, n)
    return (centers[labels] + rng.standard_normal((n, d))).astype(np.float32), labels


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("block", [64, 2048])
def test_silhouette_samples_matches_jax(block):
    x, labels = blobs()
    got = tm.silhouette_samples(x, labels, block=block, device="cpu")
    want = np.asarray(jm.silhouette_samples(x, labels, block=block))
    assert got.dtype == torch.float32 and got.shape == (400,)
    assert rel(got.numpy(), want) <= 1e-5
    assert tm.silhouette_score(x, labels, device="cpu") == pytest.approx(
        jm.silhouette_score(x, labels), abs=1e-6)


def test_silhouette_singletons_and_errors():
    x, labels = blobs(n=60, k=3, seed=2)
    labels = labels.copy()
    labels[0] = 9  # a singleton cluster: s = 0 there
    got = tm.silhouette_samples(x, labels, device="cpu").numpy()
    want = np.asarray(jm.silhouette_samples(x, labels))
    assert got[0] == 0.0 and rel(got, want) <= 1e-5
    with pytest.raises(ValueError, match="at least 2 clusters"):
        tm.silhouette_samples(x, np.zeros(60), device="cpu")
    with pytest.raises(ValueError, match="n_samples > n_clusters"):
        tm.silhouette_samples(x[:3], [0, 1, 2], device="cpu")


@pytest.mark.parametrize("n_slabs", [1, 4])
def test_mesh_silhouette_matches_the_jax_mesh(n_slabs):
    from jax.sharding import Mesh as JMesh

    x, labels = blobs(n=333, seed=3)
    jmesh = JMesh(np.array(jax.devices()[:n_slabs]), ("rows",))
    want = np.asarray(jm.silhouette_samples(x, labels, block=64, mesh=jmesh))
    got = tm.silhouette_samples(x, labels, block=64, mesh=make_mesh(n_slabs, device="cpu"))
    single = tm.silhouette_samples(x, labels, block=64, device="cpu")
    assert rel(got.numpy(), want) <= 1e-5
    assert rel(got.numpy(), single.numpy()) <= 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_ari_and_nmi_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, 500)
    b = np.where(rng.random(500) < 0.7, a, rng.integers(0, 6, 500))
    assert tm.adjusted_rand_index(a, b) == pytest.approx(jm.adjusted_rand_index(a, b), rel=1e-10)
    assert tm.normalized_mutual_info(a, b) == pytest.approx(
        jm.normalized_mutual_info(a, b), rel=1e-10)
    assert tm.adjusted_rand_index(a, a) == 1.0
    assert tm.adjusted_rand_index(torch.from_numpy(a), a) == 1.0
    with pytest.raises(ValueError, match="same length"):
        tm.adjusted_rand_index(a, b[:-1])


@pytest.mark.parametrize("as_matrix", [False, True])
def test_morans_i_and_gearys_c_match_jax(as_matrix):
    x, labels = blobs(n=300, seed=4)
    S = jconn(x, 10)
    rng = np.random.default_rng(4)
    vals = np.column_stack([labels + 0.1 * rng.standard_normal(300),
                            rng.standard_normal((300, 5))]).astype(np.float32)
    graph = SparseMatrix.from_scipy(S.astype(np.float32), device="cpu") if as_matrix else S
    for fn, jfn in ((tm.morans_i, jm.morans_i), (tm.gearys_c, jm.gearys_c)):
        got = fn(graph, vals, block=4, device="cpu")
        want = jfn(S, vals, block=4)
        assert rel(got, want) <= 1e-5
        one = fn(graph, vals[:, 0], device="cpu")
        assert np.ndim(one) == 0 and one == pytest.approx(float(jfn(S, vals[:, 0])), rel=1e-5)
    assert tm.morans_i(graph, vals[:, 0], device="cpu") > 0.9  # labels are autocorrelated
    with pytest.raises(ValueError, match="square"):
        tm.morans_i(sp.random(5, 4, density=0.5, format="csr"), np.ones(5), device="cpu")


@pytest.mark.parametrize("grouped", [False, True])
def test_embedding_density_matches_jax(grouped):
    x, labels = blobs(n=300, d=2, seed=5)
    groups = labels if grouped else None
    got = tm.embedding_density(x, groups=groups, block=50, device="cpu")
    want = jm.embedding_density(x, groups=groups, block=50)
    assert np.abs(got - want).max() <= 1e-5


def mixed_and_separated(seed=6):
    x, types = blobs(n=400, d=6, k=3, seed=seed)
    rng = np.random.default_rng(seed)
    mixed = rng.integers(0, 2, 400)  # batches mixed inside every type
    sep = (x[:, 0] > np.median(x[:, 0])).astype(int)  # batches split in space
    return x, types, mixed, sep


@pytest.mark.parametrize("which", ["mixed", "separated", "types"])
def test_lisi_matches_jax(which):
    """From the JAX kNN, the calibrated index agrees within 1e-5; from
    each package's own kNN within 1e-4 (the float32 kNN distances differ
    by ~3e-5 of the largest, which the perplexity bisection carries)."""

    import jax.numpy as jnp

    from single_algebra_tpu.neighbors import knn as jknn

    x, types, mixed, sep = mixed_and_separated()
    lab = {"mixed": mixed, "separated": sep, "types": types}[which]
    _, inv = np.unique(lab, return_inverse=True)
    d, idx = jknn(jnp.asarray(x), 30)
    codes = np.asarray(inv, np.int64)[np.asarray(idx)]
    want = np.asarray(jm._lisi_device(d.astype(jnp.float32) ** 2, jnp.asarray(codes, jnp.int32),
                                      jnp.asarray(10.0, jnp.float32), len(np.unique(lab))))
    d_t = torch.tensor(np.asarray(d, np.float32))
    got = tm._lisi_device(d_t ** 2, torch.from_numpy(codes), 10.0, len(np.unique(lab)))
    assert rel(got.numpy(), want) <= 1e-5
    full = tm.lisi(x, lab, perplexity=10, device="cpu")
    assert rel(full, np.asarray(jm.lisi(x, lab, perplexity=10))) <= 1e-4
    if which == "mixed":
        assert full.mean() > 1.7


@pytest.mark.parametrize("k", [10, 25])
def test_kbet_and_silhouette_batch_match_jax(k):
    x, types, mixed, sep = mixed_and_separated(seed=7)
    for b in (mixed, sep):
        assert tm.kbet(x, b, k=k, device="cpu") == pytest.approx(jm.kbet(x, b, k=k), abs=1e-12)
        assert tm.silhouette_batch(x, b, types, device="cpu") == pytest.approx(
            jm.silhouette_batch(x, b, types), abs=1e-6)
    assert tm.kbet(x, mixed, k=k, device="cpu") > tm.kbet(x, sep, k=k, device="cpu")
    with pytest.raises(ValueError, match="at least 2 batches"):
        tm.kbet(x, np.zeros(400), device="cpu")
    with pytest.raises(ValueError, match="no group"):
        tm.silhouette_batch(x, np.zeros(400), types, device="cpu")
