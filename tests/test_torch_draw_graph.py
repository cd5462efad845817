"""``models/draw_graph.py`` (ForceAtlas2) of the torch port against the JAX
package.

- ``_forces`` with every option, float64, from the same positions:
  1e-10 of max |F| (the port forms the distances from direct coordinate
  differences, the JAX package by a GEMM: the same values in float64).
- In float32 the port is held to float64 (1e-5 of max |F|) and the JAX
  float32 forces to the port's within the JAX package's own float32
  error (its ``|a|^2 + |b|^2 - 2 a.b`` form leaves ~1e-3 at these radii).
- The controller: 5 float64 iterations of ``_fa2_chunk`` from the same
  state, 1e-8 of max |y| (the descent is chaotic: a rounding difference
  grows quickly, so longer runs are held by structure, as the JAX tests
  hold them).
- The mesh mode on ``make_mesh(8, device="cpu")``: float64 iterations
  within 1e-10 of the single device, float32 layouts bit for bit equal to
  the single device's (the sums accumulate in float64), and the JAX
  test's bars (5 float32 iterations within rtol 5e-3, atol 1e-2; SBM
  separation above 2).
- The JAX tests' structure bars (SBM separation, chain unrolling, lin_log
  at scale, 3D), determinism and validation.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch import neighbors as tneighbors
from single_algebra_tpu_torch.models import draw_graph
from single_algebra_tpu_torch.parallel import make_mesh
from tests.test_draw_graph import _sbm, _separation

jdg = importlib.import_module("single_algebra_tpu.models.draw_graph")
tdg = importlib.import_module("single_algebra_tpu_torch.models.draw_graph")

OPTIONS = [
    dict(strong_gravity=False, lin_log=False, outbound=False),
    dict(strong_gravity=True, lin_log=False, outbound=False),
    dict(strong_gravity=False, lin_log=True, outbound=False),
    dict(strong_gravity=False, lin_log=False, outbound=True),
    dict(strong_gravity=True, lin_log=True, outbound=True),
]
OPT_IDS = ["plain", "strong", "linlog", "outbound", "all"]


def graph_arrays(A, weight_influence=1.0):
    n = A.shape[0]
    w = A.data if weight_influence == 1.0 else np.power(A.data, weight_influence)
    src, dst, val = jdg._edge_list(sp.csr_matrix((w, A.indices, A.indptr), shape=A.shape), n)
    mass = (1.0 + A.getnnz(axis=1)).astype(np.float64)
    return src, dst, val, mass


def t_args(src, dst, val, mass, dtype):
    return (torch.as_tensor(mass, dtype=dtype), torch.from_numpy(src.astype(np.int64)),
            torch.from_numpy(dst.astype(np.int64)), torch.as_tensor(val, dtype=dtype))


def j_args(src, dst, val, mass, dtype):
    return (jnp.asarray(mass, dtype), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(val, dtype))


@pytest.fixture(scope="module")
def sbm():
    return _sbm([50, 50, 50], seed=11)


def start(n, dim=2, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(size=(n, dim)) * np.sqrt(n) * scale


@pytest.mark.parametrize("opts", OPTIONS, ids=OPT_IDS)
@pytest.mark.parametrize("dim,block", [(2, 128), (3, 64), (2, 512)])
def test_forces_float64_match_jax(sbm, opts, dim, block):
    A, _ = sbm
    src, dst, val, mass = graph_arrays(A, 0.5 if opts["outbound"] else 1.0)
    y = start(A.shape[0], dim)
    kw = dict(scaling=2.0, gravity=1.0, block=block, **opts)
    want = np.asarray(jdg._forces(jnp.asarray(y), *j_args(src, dst, val, mass, jnp.float64), **kw))
    got = tdg._forces(torch.from_numpy(y), *t_args(src, dst, val, mass, torch.float64), **kw)
    assert np.abs(got.numpy() - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_forces_float32_against_float64(sbm, scale):
    A, _ = sbm
    src, dst, val, mass = graph_arrays(A)
    y = start(A.shape[0], scale=scale)
    kw = dict(scaling=2.0, gravity=1.0, block=128, strong_gravity=False, lin_log=False,
              outbound=False)
    truth = tdg._forces(torch.from_numpy(y), *t_args(src, dst, val, mass, torch.float64),
                        **kw).numpy()
    got = tdg._forces(torch.as_tensor(y, dtype=torch.float32),
                      *t_args(src, dst, val, mass, torch.float32), **kw).numpy()
    jax32 = np.asarray(jdg._forces(jnp.asarray(y, jnp.float32),
                                   *j_args(src, dst, val, mass, jnp.float32), **kw))
    top = np.abs(truth).max()
    port_err = np.abs(got - truth).max() / top
    jax_err = np.abs(jax32 - truth).max() / top
    assert port_err <= 1e-5
    # the port and the JAX package agree within the JAX package's own error
    assert np.abs(got - jax32).max() / top <= jax_err + port_err


@pytest.mark.parametrize("opts", OPTIONS, ids=OPT_IDS)
def test_five_float64_iterations_match_jax(sbm, opts):
    A, _ = sbm
    n = A.shape[0]
    src, dst, val, mass = graph_arrays(A)
    y = start(n)
    state = (jnp.asarray(y), jnp.zeros((n, 2)), jnp.asarray(1.0), jnp.asarray(1.0))
    want = jdg._fa2_chunk(state, *j_args(src, dst, val, mass, jnp.float64), 0, 5,
                          jnp.asarray(2.0), jnp.asarray(1.0), jnp.asarray(1.0),
                          opts["strong_gravity"], opts["lin_log"], opts["outbound"], 64)
    one = torch.ones((), dtype=torch.float64)
    tstate = (torch.from_numpy(y), torch.zeros((n, 2), dtype=torch.float64), one, one.clone())
    got = tdg._fa2_chunk(tstate, *t_args(src, dst, val, mass, torch.float64), 0, 5, 2.0, 1.0,
                         1.0, block=64, **opts)
    wy = np.asarray(want[0])
    assert np.abs(got[0].numpy() - wy).max() <= 1e-8 * np.abs(wy).max()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(want[1])).max())
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-10)


def test_public_layout_from_the_same_init_matches_jax(sbm):
    A, _ = sbm
    init = start(A.shape[0]).astype(np.float32)
    # one float32 iteration: the JAX float32 forces carry ~1e-3 at this radius
    want = jdg.draw_graph(A, n_iter=1, init=init)
    got = draw_graph(A, n_iter=1, init=init, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    # a SparseMatrix input keeps its device; chunking changes nothing
    m = SparseMatrix.from_scipy(A, device="cpu")
    np.testing.assert_array_equal(draw_graph(m, n_iter=1, init=init), got)
    np.testing.assert_array_equal(
        draw_graph(A, n_iter=7, init=init, dispatch_chunk=3, device="cpu"),
        draw_graph(A, n_iter=7, init=init, device="cpu"))


def test_layout_separates_blocks():
    A, labels = _sbm([60, 60, 60], seed=1)
    y = draw_graph(A, n_iter=300, seed=3, device="cpu")
    assert y.shape == (180, 2) and np.isfinite(y).all()
    assert _separation(y, labels) > 2.0
    # the JAX package's layout of the same graph meets the same bar
    assert _separation(jdg.draw_graph(A, n_iter=300, seed=3), labels) > 2.0


def test_chain_graph_unrolls():
    from scipy.stats import spearmanr

    n = 40
    rows = np.arange(n - 1)
    A = sp.coo_matrix((np.ones(n - 1, np.float32), (rows, rows + 1)), shape=(n, n)).tocsr()
    y = draw_graph(A, n_iter=400, seed=0, device="cpu")
    d_graph = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    d_emb = np.linalg.norm(y[:, None] - y[None, :], axis=-1)
    iu = np.triu_indices(n, k=1)
    assert spearmanr(d_graph[iu], d_emb[iu]).statistic > 0.8


def test_deterministic_and_seed_sensitive():
    A, _ = _sbm([40, 40], seed=2)
    y1 = draw_graph(A, n_iter=50, seed=7, device="cpu")
    y2 = draw_graph(A, n_iter=50, seed=7, device="cpu")
    y3 = draw_graph(A, n_iter=50, seed=8, device="cpu")
    np.testing.assert_array_equal(y1, y2)
    assert np.abs(y1 - y3).max() > 1e-3


def test_seeded_start_scale():
    y0 = tdg._start(4000, 2, 5, "cpu")
    assert abs(float(y0.std()) / np.sqrt(4000) - 1.0) < 0.05
    assert torch.equal(y0, tdg._start(4000, 2, 5, "cpu"))


def test_init_and_options():
    A, labels = _sbm([50, 50], seed=4)
    n = A.shape[0]
    init = np.random.default_rng(0).normal(size=(n, 2)).astype(np.float32)
    y = draw_graph(A, n_iter=250, init=init, strong_gravity=True, dispatch_chunk=37,
                   device="cpu")
    assert np.isfinite(y).all()
    assert _separation(y, labels) > 1.5
    y2 = draw_graph(A, n_iter=60, lin_log=True, outbound_attraction_distribution=True,
                    edge_weight_influence=0.5, device="cpu")
    assert np.isfinite(y2).all()
    y3 = draw_graph(A, n_iter=5, init=init, edge_weight_influence=0.0, device="cpu")
    want = jdg.draw_graph(A, n_iter=5, init=init, edge_weight_influence=0.0)
    assert np.abs(y3 - want).max() <= 1e-2 * np.abs(want).max()
    with pytest.raises(ValueError, match="init shape"):
        draw_graph(A, init=init[:10], device="cpu")


def test_connectivities_chain_and_3d():
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(c * 8, 1.0, size=(40, 5)) for c in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 40)
    S = tneighbors.connectivities(X, n_neighbors=10, device="cpu")
    y = draw_graph(S, n_iter=250, dim=3, seed=1, device="cpu")
    assert y.shape == (120, 3)
    assert _separation(y, labels) > 2.0


def test_validation():
    with pytest.raises(TypeError):
        draw_graph(np.zeros((4, 4)), device="cpu")
    A = sp.eye(5, format="csr")
    with pytest.raises(ValueError, match="n_iter"):
        draw_graph(A, n_iter=0, device="cpu")
    with pytest.raises(ValueError, match="dim"):
        draw_graph(A, dim=0, device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        draw_graph(sp.csr_matrix((1, 1), dtype=np.float32), device="cpu")


def test_lin_log_separates_at_scale():
    A, labels = _sbm([300, 300, 300], p_in=0.04, p_out=0.0008, seed=9)
    y = draw_graph(A, n_iter=1200, seed=0, lin_log=True, device="cpu")
    assert _separation(y, labels) > 3.0


@pytest.mark.parametrize("opts", OPTIONS, ids=OPT_IDS)
def test_mesh_float64_matches_single_device(sbm, opts):
    A, _ = sbm
    n = A.shape[0]
    src, dst, val, mass = graph_arrays(A)
    y = start(n)
    one = torch.ones((), dtype=torch.float64)
    single = tdg._fa2_chunk((torch.from_numpy(y), torch.zeros((n, 2), dtype=torch.float64), one,
                             one.clone()), *t_args(src, dst, val, mass, torch.float64), 0, 5,
                            2.0, 1.0, 1.0, block=64, **opts)
    lay = tdg._FA2Mesh(src, dst, val, int(A.nnz), mass, n, make_mesh(8, device="cpu"), 2048,
                       dtype=torch.float64)
    yp = torch.zeros((lay.npad, 2), dtype=torch.float64)
    yp[:n] = torch.from_numpy(y)
    got = lay.run((yp, torch.zeros_like(yp), one, one.clone()), 0, 5, 2.0, 1.0, 1.0, **opts)
    sy = single[0].numpy()
    assert np.abs(got[0][:n].numpy() - sy).max() <= 1e-10 * np.abs(sy).max()
    assert not got[0][n:].any()  # padding rows stay at the origin


@pytest.mark.parametrize("ndev", [1, 8])
def test_mesh_layout_matches_single_device(sbm, ndev):
    A, labels = _sbm([50, 50, 50], seed=11)
    mesh = make_mesh(ndev, device="cpu")
    y_mesh = draw_graph(A, n_iter=60, seed=3, mesh=mesh)
    assert y_mesh.shape == (150, 2) and np.isfinite(y_mesh).all()
    assert _separation(y_mesh, labels) > 2.0
    y1 = draw_graph(A, n_iter=5, seed=3, device="cpu")
    y2 = draw_graph(A, n_iter=5, seed=3, mesh=mesh)
    np.testing.assert_allclose(y1, y2, rtol=5e-3, atol=1e-2)


def test_mesh_rounds_like_the_single_device():
    """The sums accumulate in float64 and round once, so the mesh's float32
    layout equals the single device's bit for bit, whatever the slab split
    (the descent is chaotic: a rounding difference would spread through
    the layout within a few iterations)."""

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(c * 10, 1.0, (200, 8)) for c in range(5)]).astype(np.float32)
    S = tneighbors.connectivities(x, n_neighbors=15, device="cpu")
    init = start(1000).astype(np.float32)
    single = draw_graph(S, n_iter=5, init=init, device="cpu")
    for nd in (3, 8):
        np.testing.assert_array_equal(
            draw_graph(S, n_iter=5, init=init, mesh=make_mesh(nd, device="cpu")), single)


def test_mesh_matches_the_jax_mesh_from_the_same_init(sbm):
    from single_algebra_tpu.parallel import make_mesh as jmake_mesh

    A, _ = sbm
    init = start(A.shape[0]).astype(np.float32)
    want = jdg.draw_graph(A, n_iter=1, init=init, mesh=jmake_mesh(8))
    got = draw_graph(A, n_iter=1, init=init, mesh=make_mesh(8, device="cpu"))
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()


def test_mesh_layout_options_smoke():
    A, _ = _sbm([40, 40], seed=12)
    y = draw_graph(A, n_iter=30, seed=1, mesh=make_mesh(8, device="cpu"), lin_log=True,
                   strong_gravity=True, outbound_attraction_distribution=True, dispatch_chunk=13)
    assert y.shape == (80, 2) and np.isfinite(y).all()


def test_default_device_is_the_card(sbm):
    A, _ = sbm
    if torch.cuda.is_available():
        assert draw_graph(A, n_iter=2).shape == (150, 2)
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            draw_graph(A, n_iter=2)
