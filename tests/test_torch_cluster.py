"""``cluster.py`` of the torch port against the JAX package.

Leiden runs on the host in both packages, from the same C++ source (the
port keeps its own copy, built into its own build directory): labels
identical to the JAX package's native run and the quality within 1e-12,
over several seeds and resolutions. The Python Leiden, which runs when
the native library is missing, is identical to the JAX package's.
``modularity``, ``paga`` and ``dendrogram`` match the JAX functions.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import cluster as jcl
from single_algebra_tpu.neighbors import connectivities as jconn
from single_algebra_tpu_torch import SparseMatrix, cluster, leiden
from single_algebra_tpu_torch.native import build as nbuild


def blobs(n=300, d=6, k=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 6.0
    labels = rng.integers(0, k, n)
    return (centers[labels] + rng.standard_normal((n, d))).astype(np.float32), labels


@pytest.fixture(scope="module")
def graph():
    x, labels = blobs()
    return jconn(x, 12), labels, x


def test_leiden_native_builds_into_the_ports_build_dir():
    lib = nbuild.get_leiden_lib()
    assert lib is not None
    src_tag = nbuild.source_tag(nbuild._LEIDEN_SRC)
    assert os.path.exists(os.path.join(nbuild.build_dir("native"), f"leiden_{src_tag}.so"))
    with open(nbuild._LEIDEN_SRC, "rb") as f, open(
            os.path.join(os.path.dirname(jcl.__file__), "native", "leiden.cpp"), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("resolution", [0.3, 1.0, 2.0])
def test_leiden_matches_the_jax_native_run(graph, seed, resolution):
    S, _, _ = graph
    got = leiden(S, resolution=resolution, seed=seed)
    want = jcl.leiden(S, resolution=resolution, seed=seed)
    assert got.backend == want.backend == "native"
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_communities == want.n_communities
    assert abs(got.quality - want.quality) <= 1e-12
    assert abs(cluster.modularity(S, got.labels, resolution=resolution)
               - jcl.modularity(S, want.labels, resolution=resolution)) <= 1e-12


def test_leiden_recovers_blobs_and_takes_a_sparse_matrix(graph):
    S, labels, _ = graph
    out = leiden(SparseMatrix.from_scipy(S, device="cpu"), resolution=0.5)
    want = jcl.leiden(S, resolution=0.5)
    np.testing.assert_array_equal(out.labels, want.labels)
    assert out.n_communities == len(np.unique(labels))
    with pytest.raises(TypeError, match="scipy sparse"):
        leiden(np.eye(3))


@pytest.mark.parametrize("seed", [0, 3])
def test_python_leiden_matches_the_jax_python_leiden(graph, seed, monkeypatch):
    S, _, _ = graph
    a = cluster._as_sym_csr(S)
    args = (a.indptr.astype(np.int64), a.indices.astype(np.int64),
            a.data.astype(np.float64), a.shape[0], 1.0, seed, 10)
    np.testing.assert_array_equal(cluster._leiden_py(*args), jcl._leiden_py(*args))
    # without the native library, leiden says so and runs the Python one
    monkeypatch.setattr(nbuild, "get_leiden_lib", lambda: None)
    out = leiden(S, seed=seed)
    assert out.backend == "python"
    np.testing.assert_array_equal(out.labels, jcl._leiden_py(*args))


def test_directed_input_is_symmetrized_as_jax():
    rng = np.random.default_rng(1)
    A = sp.random(60, 60, density=0.1, random_state=rng, format="csr")
    got, want = cluster._as_sym_csr(A), jcl._as_sym_csr(A)
    assert abs(got - want).max() == 0
    with pytest.raises(ValueError, match="non-negative"):
        cluster._as_sym_csr(-A - A.T)
    with pytest.raises(ValueError, match="square"):
        cluster._as_sym_csr(sp.csr_matrix((3, 4)))


def test_paga_and_dendrogram_match_jax(graph):
    S, labels, x = graph
    np.testing.assert_array_equal(cluster.paga(S, labels), jcl.paga(S, labels))
    got, want = cluster.dendrogram(x, labels), jcl.dendrogram(x, labels)
    np.testing.assert_array_equal(got["linkage"], want["linkage"])
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(got["group_means"], want["group_means"])
    with pytest.raises(ValueError, match="2 groups"):
        cluster.dendrogram(x, np.zeros(len(x)))
