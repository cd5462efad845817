"""``parallel/`` of the torch port against the JAX package's mesh layer.

The port's mesh is one process: ``make_mesh(8, device="cpu")`` holds 8
row slabs on the host, beside the JAX package's 8-device CPU mesh (the
Pallas kernels in interpret mode, as its own tests run them). The cases
mirror ``tests/test_sharding.py`` and ``tests/test_sharded_gram.py`` one
for one, then hold the port to the JAX mesh on the same numpy inputs:

- float64 products and statistics: rtol 1e-10;
- sharded PCA / Gram explained variances against the JAX sharded fit
  with the JAX sketch injected: 1e-10 in float64, 1e-5 in float32;
- sharded against single-card port: the same bounds;
- the host-built slab payloads: equal to the JAX arrays.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu import parallel as JP
from single_algebra_tpu.linalg import randomized_svd as j_randomized_svd
from single_algebra_tpu.types import PowerIterationNormalizer as JPIN
from single_algebra_tpu.types import SVDMethod as JSVD
from single_algebra_tpu_torch import MaskedSparsePCABuilder, SparseMatrix, SparsePCABuilder
from single_algebra_tpu_torch import parallel as P
from single_algebra_tpu_torch.linalg import (
    CenteredOperator, SparseOperator, lanczos_svd, randomized_svd,
)
from single_algebra_tpu_torch.linalg import gram as tgram
from single_algebra_tpu_torch.linalg import svd as tsvd
from single_algebra_tpu_torch.linalg.operators import DensifiedOperator, TiledSparseOperator
from single_algebra_tpu_torch.parallel import pca as ppca
from single_algebra_tpu_torch.types import PowerIterationNormalizer as PIN
from single_algebra_tpu_torch.types import SVDMethod

from tests.conftest import cluster_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tmesh(n):
    return P.make_mesh(n, device="cpu")


def cpu(X, **kw):
    return SparseMatrix.from_scipy(X, device="cpu", **kw)


def np_(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def jax_normal(shape, seed, dtype):
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return np.array(jax.random.normal(key, shape, dtype=dtype))


def inject_sketch(monkeypatch, omega):
    """The port's seeded sketch becomes ``omega`` (the JAX package's)."""

    def sketch(p, l, seed, *, dtype, device):
        assert omega.shape == (p, l)
        return torch.from_numpy(omega).to(device=device, dtype=dtype)

    monkeypatch.setattr(tsvd, "gaussian_sketch", sketch)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = sp.random(403, 97, density=0.2, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random)
    return X, cpu(X, dtype=np.float64), JMatrix.from_scipy(X, dtype=np.float64)


def operands(n, p, k, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((p, k)).astype(dtype), rng.standard_normal((n, k)).astype(dtype)


# -- the mesh ------------------------------------------------------------------


def test_mesh_reads_as_the_jax_mesh():
    mesh = tmesh(8)
    assert mesh.shape == {"rows": 8} and mesh.axis_names == ("rows",)
    assert mesh.size == 8 and mesh.home == torch.device("cpu")
    assert mesh.distinct == (torch.device("cpu"),)
    assert mesh.shape[mesh.axis_names[0]] == JP.make_mesh(8).shape["rows"]
    assert tmesh(None).size == 1
    assert P.Mesh(("cpu", "cpu"), axis_name="cells").shape == {"cells": 2}
    with pytest.raises(ValueError, match="at least one"):
        P.Mesh(())
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            P.make_mesh(2, device="cuda")


def test_psum_adds_in_slab_order_and_writes_no_part():
    parts = [torch.tensor([1e16, 1.0]), torch.tensor([-1e16, 1.0]), torch.tensor([1.0, 1.0])]
    kept = [p.clone() for p in parts]
    out = P.sharded._psum(iter(parts), torch.device("cpu"))
    assert out.tolist() == [1.0, 3.0]  # ((a + b) + c), not (a + (b + c))
    assert all(torch.equal(p, k) for p, k in zip(parts, kept))


# -- tests/test_sharding.py, case for case ----------------------------------------


def test_sharded_products_match(problem):
    X, m, jm = problem
    op = P.ShardedSpMM.from_matrix(m, tmesh(8))
    jop = JP.ShardedSpMM.from_matrix(jm, JP.make_mesh(8))
    B, C = operands(403, 97, 6, 1)
    mv, rmv = np_(op.mv(torch.from_numpy(B))), np_(op.rmv(torch.from_numpy(C)))
    np.testing.assert_allclose(mv, X @ B, rtol=1e-10)
    np.testing.assert_allclose(rmv, X.T @ C, rtol=1e-10)
    np.testing.assert_allclose(mv, np.asarray(jop.mv(B)), rtol=1e-10)
    np.testing.assert_allclose(rmv, np.asarray(jop.rmv(C)), rtol=1e-10)
    assert op.n_padded == jop.n_padded and op.rows_per_shard == jop.rows_per_shard


def test_sharded_col_stats(problem):
    X, m, jm = problem
    s, sq, cnt = P.ShardedSpMM.from_matrix(m, tmesh(8)).col_stats()
    js, jsq, jcnt = JP.ShardedSpMM.from_matrix(jm, JP.make_mesh(8)).col_stats()
    dense = X.toarray()
    np.testing.assert_allclose(np_(s), dense.sum(0), rtol=1e-10)
    np.testing.assert_allclose(np_(sq), (dense**2).sum(0), rtol=1e-10)
    np.testing.assert_array_equal(np_(cnt), (dense != 0).sum(0))
    np.testing.assert_allclose(np_(s), np.asarray(js), rtol=1e-10)
    np.testing.assert_allclose(np_(sq), np.asarray(jsq), rtol=1e-10)
    np.testing.assert_array_equal(np_(cnt), np.asarray(jcnt))


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_svd_matches_single_device(problem, ndev):
    X, m, jm = problem
    res1 = randomized_svd(SparseOperator.from_matrix(m), 5, 10, 4, PIN.QR, seed=3)
    opn = P.ShardedSpMM.from_matrix(m, tmesh(ndev))
    resn = randomized_svd(opn, 5, 10, 4, PIN.QR, seed=3)
    np.testing.assert_allclose(np_(resn.s), np_(res1.s), rtol=1e-10)
    np.testing.assert_allclose(np.abs(np_(resn.u)), np.abs(np_(res1.u)), atol=1e-7)
    # the JAX sharded solve from its own sketch
    jres = j_randomized_svd(JP.ShardedSpMM.from_matrix(jm, JP.make_mesh(ndev)), 5, 10, 4,
                            JPIN.QR, seed=3)
    omega = torch.from_numpy(jax_normal((97, 15), 3, jnp.float64))
    resj = randomized_svd(opn, 5, 10, 4, PIN.QR, omega=omega)
    np.testing.assert_allclose(np_(resj.s), np.asarray(jres.s), rtol=1e-10)


def test_sharded_pca_matches_sklearn(monkeypatch):
    from sklearn.decomposition import PCA as SkPCA

    X = cluster_counts(500, 120, n_clusters=10, seed=2)
    res = P.sharded_pca_fit_transform(X, n_components=6, mesh=tmesh(8),
                                      svd_method=SVDMethod.random(10, 7, PIN.QR), seed=42)
    sk = SkPCA(n_components=6, svd_solver="full").fit(X.toarray())
    rel = np.abs(np_(res.explained_variance) - sk.explained_variance_) / sk.explained_variance_
    assert rel[:5].max() < 1e-6
    np.testing.assert_allclose(res.total_variance, X.toarray().var(0, ddof=1).sum(), rtol=1e-10)
    T = np_(res.transformed)
    np.testing.assert_allclose(T[:, :5], sk.transform(X.toarray())[:, :5], rtol=1e-3,
                               atol=1e-5 * np.abs(T).max())
    # the JAX sharded fit, and the port's from the same (JAX) sketch: float64
    jres = JP.sharded_pca_fit_transform(X, n_components=6, mesh=JP.make_mesh(8),
                                        svd_method=JSVD.random(10, 7, JPIN.QR), seed=42)
    inject_sketch(monkeypatch, jax_normal((120, 16), 42, jnp.float64))
    res = P.sharded_pca_fit_transform(X, n_components=6, mesh=tmesh(8),
                                      svd_method=SVDMethod.random(10, 7, PIN.QR), seed=42)
    np.testing.assert_allclose(np_(res.explained_variance), np.asarray(jres.explained_variance),
                               rtol=1e-10)
    assert rel_max(np_(res.transformed), np.asarray(jres.transformed)) < 1e-9
    assert res.total_variance == pytest.approx(jres.total_variance, rel=1e-12)


@pytest.mark.parametrize("n_rows", [5, 20, 100])
def test_sharded_small_row_counts(n_rows):
    """Fewer rows than, or not a multiple of, the mesh size: slab bounds
    clamp to n (trailing slabs are empty)."""

    rng = np.random.default_rng(7)
    X = sp.random(n_rows, 33, density=0.4, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random)
    op = P.ShardedSpMM.from_matrix(cpu(X, dtype=np.float64), tmesh(8))
    B, C = rng.standard_normal((33, 4)), rng.standard_normal((n_rows, 4))
    np.testing.assert_allclose(np_(op.mv(torch.from_numpy(B))), X @ B, rtol=1e-10)
    np.testing.assert_allclose(np_(op.rmv(torch.from_numpy(C))), X.T @ C, rtol=1e-10)


def test_sharded_lanczos_matches_single_device(problem):
    from single_algebra_tpu.linalg import lanczos_svd as j_lanczos_svd

    X, m, jm = problem
    res1 = lanczos_svd(SparseOperator.from_matrix(m), 5, steps=60, seed=3)
    opn = P.ShardedSpMM.from_matrix(m, tmesh(8))
    resn = lanczos_svd(opn, 5, steps=60, seed=3)
    np.testing.assert_allclose(np_(resn.s), np_(res1.s), rtol=1e-10)
    np.testing.assert_allclose(np.abs(np_(resn.u)), np.abs(np_(res1.u)), atol=1e-6)
    jres = j_lanczos_svd(JP.ShardedSpMM.from_matrix(jm, JP.make_mesh(8)), 5, steps=60, seed=3)
    v0 = torch.from_numpy(jax_normal((97,), 3, jnp.float64))
    resj = lanczos_svd(opn, 5, steps=60, v0=v0)
    np.testing.assert_allclose(np_(resj.s), np.asarray(jres.s), rtol=1e-10)


def test_sharded_pca_lanczos_path():
    """Both SVD methods on the mesh; Lanczos against the single-card fit
    from the same start vector."""

    X = cluster_counts(300, 80, n_clusters=6, seed=4)
    res = P.sharded_pca_fit_transform(X, n_components=5, mesh=tmesh(8),
                                      svd_method=SVDMethod.lanczos(), seed=42, lanczos_steps=60)
    single = (SparsePCABuilder().n_components(5).svd_method(SVDMethod.lanczos())
              .engine("sparse").lanczos_steps(60).build())
    T1 = single.fit_transform(cpu(X))
    np.testing.assert_allclose(np_(res.explained_variance), single.explained_variance_,
                               rtol=1e-10)
    assert rel_max(np_(res.transformed), np_(T1)) < 1e-9


def test_sharded_masked_pca_matches_masked_model(monkeypatch):
    X = cluster_counts(300, 90, n_clusters=6, seed=9)
    rng = np.random.default_rng(1)
    mask = rng.random(90) < 0.4
    mask[:5] = True
    method = SVDMethod.random(8, 5, PIN.QR)
    res = P.sharded_pca_fit_transform(X, n_components=4, mesh=tmesh(8), svd_method=method,
                                      seed=42, mask=mask)
    single = MaskedSparsePCABuilder().mask(mask).n_components(4).svd_method(method).build()
    T1 = single.fit_transform(cpu(X))
    assert tuple(res.components.shape) == (4, int(mask.sum()))
    assert res.mean.shape == (90,)
    np.testing.assert_allclose(np_(res.explained_variance), single.explained_variance_,
                               rtol=1e-10)
    np.testing.assert_allclose(np_(res.transformed), np_(T1), rtol=1e-6, atol=1e-9)
    jres = JP.sharded_pca_fit_transform(X, n_components=4, mesh=JP.make_mesh(8),
                                        svd_method=JSVD.random(8, 5, JPIN.QR), seed=42, mask=mask)
    inject_sketch(monkeypatch, jax_normal((int(mask.sum()), 12), 42, jnp.float64))
    res = P.sharded_pca_fit_transform(X, n_components=4, mesh=tmesh(8), svd_method=method,
                                      seed=42, mask=mask)
    np.testing.assert_allclose(np_(res.explained_variance), np.asarray(jres.explained_variance),
                               rtol=1e-10)
    assert res.total_variance == pytest.approx(jres.total_variance, rel=1e-12)
    with pytest.raises(ValueError, match="mask vector length"):
        P.sharded_pca_fit_transform(X, n_components=2, mesh=tmesh(2), mask=mask[:-1])


def test_sharded_centered_operator(problem):
    X, m, _ = problem
    mu = np.asarray(X.mean(axis=0)).ravel()
    cop = CenteredOperator(P.ShardedSpMM.from_matrix(m, tmesh(4)), torch.from_numpy(mu))
    B, C = operands(403, 97, 3, 2)
    Xc = X.toarray() - mu
    assert rel_max(np_(cop.mv(torch.from_numpy(B))), Xc @ B) < 1e-10
    assert rel_max(np_(cop.rmv(torch.from_numpy(C))), Xc.T @ C) < 1e-10


def test_sharded_tiled_products(problem):
    """The tiled kernels' plain versions per slab == scipy on both
    directions, and the column statistics (exact host moments)."""

    X, m, jm = problem
    op = P.ShardedTiled.from_matrix(m, tmesh(8))
    jop = JP.ShardedTiled.from_matrix(jm, JP.make_mesh(8))
    B, C = operands(403, 97, 6, 1)
    mv, rmv = np_(op.mv(torch.from_numpy(B))), np_(op.rmv(torch.from_numpy(C)))
    np.testing.assert_allclose(mv, X @ B, rtol=1e-10)
    np.testing.assert_allclose(rmv, X.T @ C, rtol=1e-10)
    np.testing.assert_allclose(mv, np.asarray(jop.mv(B)), rtol=1e-10)
    np.testing.assert_allclose(rmv, np.asarray(jop.rmv(C)), rtol=1e-10)
    s, sq, cnt = op.col_stats()
    dense = X.toarray()
    np.testing.assert_allclose(np_(s), dense.sum(0), rtol=1e-10)
    np.testing.assert_allclose(np_(sq), (dense**2).sum(0), rtol=1e-10)
    np.testing.assert_array_equal(np_(cnt), (dense != 0).sum(0))


def test_sharded_tiled_overflow_rows():
    """A few ultra-dense rows land in the overflow side arrays of the
    global width plan and still give exact products on every slab."""

    rng = np.random.default_rng(3)
    X = sp.random(300, 500, density=0.02, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random).tolil()
    X[7, :] = rng.random(500)
    X[205, ::2] = rng.random(250)
    X = X.tocsr()
    op = P.ShardedTiled.from_matrix(cpu(X, dtype=np.float64), tmesh(8))
    jop = JP.ShardedTiled.from_matrix(JMatrix.from_scipy(X, dtype=np.float64), JP.make_mesh(8))
    assert op.meta[4] > 0, "expected mv-side overflow entries"
    assert op.meta[5] > 0, "expected rmv-side overflow entries"
    assert op.meta == jop.meta and op.rows_per_shard == jop.rows_per_shard
    B, C = rng.standard_normal((500, 5)), rng.standard_normal((300, 5))
    np.testing.assert_allclose(np_(op.mv(torch.from_numpy(B))), X @ B, rtol=1e-10)
    np.testing.assert_allclose(np_(op.rmv(torch.from_numpy(C))), X.T @ C, rtol=1e-10)
    for name in ("ov_data", "ov_ids", "ovt_data", "ovt_ids"):
        got = np.stack([np_(getattr(s, name)) for s in op.slabs])
        np.testing.assert_array_equal(got, np.asarray(getattr(jop, name)), err_msg=name)


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_tiled_mesh_invariance(problem, ndev):
    X, m, _ = problem
    res1 = randomized_svd(SparseOperator.from_matrix(m), 5, 10, 4, PIN.QR, seed=3)
    resn = randomized_svd(P.ShardedTiled.from_matrix(m, tmesh(ndev)), 5, 10, 4, PIN.QR, seed=3)
    np.testing.assert_allclose(np_(resn.s), np_(res1.s), rtol=1e-10)
    np.testing.assert_allclose(np.abs(np_(resn.u)), np.abs(np_(res1.u)), atol=1e-7)


def test_sharded_tiled_pca_matches_sklearn():
    from sklearn.decomposition import PCA as SkPCA

    X = cluster_counts(500, 120, n_clusters=10, seed=2)
    res = P.sharded_pca_fit_transform(X, n_components=6, mesh=tmesh(8),
                                      svd_method=SVDMethod.random(10, 7, PIN.QR), seed=42,
                                      engine="tiled")
    sk = SkPCA(n_components=6, svd_solver="full").fit(X.toarray())
    rel = np.abs(np_(res.explained_variance) - sk.explained_variance_) / sk.explained_variance_
    assert rel[:5].max() < 1e-6
    T = np_(res.transformed)
    np.testing.assert_allclose(T[:, :5], sk.transform(X.toarray())[:, :5], rtol=1e-3,
                               atol=1e-5 * np.abs(T).max())


@pytest.mark.parametrize("n_rows", [5, 20, 100])
def test_sharded_tiled_small_row_counts(n_rows):
    rng = np.random.default_rng(7)
    X = sp.random(n_rows, 33, density=0.4, format="csr", dtype=np.float64,
                  random_state=rng, data_rvs=rng.random)
    op = P.ShardedTiled.from_matrix(cpu(X, dtype=np.float64), tmesh(8))
    B, C = rng.standard_normal((33, 4)), rng.standard_normal((n_rows, 4))
    np.testing.assert_allclose(np_(op.mv(torch.from_numpy(B))), X @ B, rtol=1e-10)
    np.testing.assert_allclose(np_(op.rmv(torch.from_numpy(C))), X.T @ C, rtol=1e-10)


def test_sharded_densified_products():
    X = cluster_counts(400, 96, n_clusters=6, seed=5).astype(np.float32)
    op = P.ShardedDensified.from_matrix(cpu(X), tmesh(8))
    jop = JP.ShardedDensified.from_matrix(JMatrix.from_scipy(X, device=False), JP.make_mesh(8))
    B, C = operands(400, 96, 5, 0, np.float32)
    X64 = X.astype(np.float64)
    mv = np_(op.mv_precise(torch.from_numpy(B)))
    rmv = np_(op.rmv_precise(torch.from_numpy(C)))
    assert rel_max(mv, X64 @ B) < 1e-6 and rel_max(rmv, X64.T @ C) < 1e-6
    assert rel_max(mv, np.asarray(jop.mv_precise(B))) < 1e-6
    assert rel_max(rmv, np.asarray(jop.rmv_precise(C))) < 1e-6
    assert rel_max(np_(op.mv(torch.from_numpy(B))), np.asarray(jop.mv(B))) < 1e-6
    s, sq = op.col_stats()
    np.testing.assert_allclose(np_(s), X.toarray().sum(0), rtol=1e-5)
    np.testing.assert_allclose(np_(sq), (X.toarray() ** 2).sum(0), rtol=1e-5)
    hi = np.concatenate([np_(sl.hi.view(torch.int16)) for sl in op.slabs])
    np.testing.assert_array_equal(hi, np.asarray(jop.hi).view(np.int16))
    assert all(sl.lo is None for sl in op.slabs) and jop.lo is None


def test_sharded_densified_pca(monkeypatch):
    from sklearn.decomposition import PCA as SkPCA

    X = cluster_counts(500, 120, n_clusters=10, seed=2).astype(np.float32)
    method = SVDMethod.random(10, 7, PIN.QR)
    res = P.sharded_pca_fit_transform(X, n_components=6, mesh=tmesh(8), svd_method=method,
                                      seed=42, engine="dense")
    sk = SkPCA(n_components=6, svd_solver="full").fit(X.toarray())
    rel = (np.abs(np_(res.explained_variance) - sk.explained_variance_.astype(np.float32))
           / sk.explained_variance_)
    assert rel[:5].max() < 1e-5
    jres = JP.sharded_pca_fit_transform(X, n_components=6, mesh=JP.make_mesh(8),
                                        svd_method=JSVD.random(10, 7, JPIN.QR), seed=42,
                                        engine="dense")
    inject_sketch(monkeypatch, jax_normal((120, 16), 42, jnp.float32))
    res = P.sharded_pca_fit_transform(cpu(X), n_components=6, mesh=tmesh(8), svd_method=method,
                                      seed=42, engine="dense")
    np.testing.assert_allclose(np_(res.explained_variance), np.asarray(jres.explained_variance),
                               rtol=1e-5)


def test_choose_sharded_engine_dtype_gate(problem, monkeypatch):
    """'dense' and 'tiled' are float32 engines on CUDA meshes: a float64
    matrix, or a CPU mesh, takes the gather engine."""

    X, m, _ = problem
    m32 = cpu(X.astype(np.float32))
    assert P.choose_sharded_engine(m32, tmesh(8)) == "sparse"  # a CPU mesh
    monkeypatch.setattr(ppca, "_on_cuda", lambda mesh: True)
    assert P.choose_sharded_engine(m, tmesh(8)) == "sparse"
    assert P.choose_sharded_engine(m32, tmesh(8)) != "sparse"


def test_sharded_tiled_bf16_payload_products():
    """float32 matrices take the bf16 hi/lo payload in the sharded engine
    too (under the width gate): precise products f32-class, fast ones
    bf16-class."""

    rng = np.random.default_rng(5)
    X32 = sp.random(403, 600, density=0.02, format="csr", dtype=np.float64,
                    random_state=rng, data_rvs=rng.random).astype(np.float32)
    op = P.ShardedTiled.from_matrix(cpu(X32), tmesh(8))
    assert all(s.tdata.dtype == torch.bfloat16 and s.tdata_lo is not None for s in op.slabs)
    B, C = operands(403, 600, 6, 5, np.float32)
    ref_mv, ref_rv = X32.astype(np.float64) @ B, X32.T.astype(np.float64) @ C
    tb, tc = torch.from_numpy(B), torch.from_numpy(C)
    assert rel_max(np_(op.mv(tb)), ref_mv) < 1e-5 and rel_max(np_(op.rmv(tc)), ref_rv) < 1e-5
    assert rel_max(np_(op.mv_fast(tb)), ref_mv) < 3e-2
    assert rel_max(np_(op.rmv_fast(tc)), ref_rv) < 3e-2
    # the single-card engine's products of the same payload values
    single = TiledSparseOperator.from_matrix(cpu(X32))
    for name, arg in (("mv", tb), ("rmv", tc), ("mv_fast", tb), ("rmv_fast", tc)):
        assert rel_max(np_(getattr(op, name)(arg)), np_(getattr(single, name)(arg))) < 1e-6


# -- the slab layouts against the JAX package's arrays -----------------------------


def test_sharded_spmm_layout_matches_jax(problem):
    _, m, jm = problem
    op = P.ShardedSpMM.from_matrix(m, tmesh(8))
    jop = JP.ShardedSpMM.from_matrix(jm, JP.make_mesh(8))
    for mine, theirs in (("row_data", "row_data"), ("row_ids", "row_ids")):
        got = np.concatenate([np_(getattr(s, mine)) for s in op.slabs])
        np.testing.assert_array_equal(got, np.asarray(getattr(jop, theirs)))
    for mine, theirs in (("col_data", "tr_data"), ("col_ids", "tr_ids")):
        got = np.stack([np_(getattr(s, mine)) for s in op.slabs])
        np.testing.assert_array_equal(got, np.asarray(getattr(jop, theirs)))
    np.testing.assert_array_equal(np.stack([np_(t) for t in op.tr_nnz]), np.asarray(jop.tr_nnz))


def test_sharded_tiled_payload_matches_jax(problem):
    _, m, jm = problem
    op = P.ShardedTiled.from_matrix(m, tmesh(4))
    jop = JP.ShardedTiled.from_matrix(jm, JP.make_mesh(4))
    assert op.meta == jop.meta and op.rows_natural == jop.rows_natural
    np.testing.assert_array_equal(np.stack([np_(s.tdata) for s in op.slabs]),
                                  np.asarray(jop.tdata))
    np.testing.assert_array_equal(np.stack([np_(s.tlocal) for s in op.slabs]),
                                  np.asarray(jop.tlocal))


# -- tests/test_sharded_gram.py, case for case -------------------------------------


@pytest.fixture(scope="module")
def data():
    return cluster_counts(600, 120, n_clusters=8, seed=4).astype(np.float32)


def _truth(X, k):
    D = X.toarray().astype(np.float64)
    s = np.linalg.svd(D - D.mean(axis=0), compute_uv=False)
    return s[:k] ** 2 / (X.shape[0] - 1)


def _jax_gram_pca(X, ndev, **kw):
    return JP.sharded_gram_pca(JMatrix.from_scipy(X), JP.make_mesh(ndev), **kw)


@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_sharded_gram_matches_truth(data, ndev):
    res = P.sharded_gram_pca(cpu(data), tmesh(ndev), n_components=5, seed=0)
    ev = np_(res.explained_variance).astype(np.float64)
    ev_ref = _truth(data, 5)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    T = np_(res.transformed)
    assert T.shape == (data.shape[0], 5)
    D = data.toarray().astype(np.float64)
    T_ref = (D - D.mean(axis=0)) @ np_(res.components).astype(np.float64).T
    assert np.abs(np.abs(T) - np.abs(T_ref)).max() < 1e-3 * np.abs(T_ref).max()
    jres = _jax_gram_pca(data, ndev, n_components=5, seed=0)
    np.testing.assert_allclose(ev, np.asarray(jres.explained_variance), rtol=1e-5)
    assert rel_max(T, np.asarray(jres.transformed)) < 1e-5
    assert rel_max(np_(res.components), np.asarray(jres.components)) < 1e-5
    np.testing.assert_allclose(np_(res.mean), np.asarray(jres.mean), rtol=1e-6)
    assert res.total_variance == pytest.approx(jres.total_variance, rel=1e-10)


def test_sharded_gram_mesh_invariance(data):
    r1 = P.sharded_gram_pca(cpu(data), tmesh(1), n_components=4, seed=3)
    r8 = P.sharded_gram_pca(cpu(data), tmesh(8), n_components=4, seed=3)
    np.testing.assert_allclose(np_(r1.explained_variance), np_(r8.explained_variance), rtol=1e-5)
    np.testing.assert_allclose(np_(r1.transformed), np_(r8.transformed), rtol=1e-3, atol=1e-4)
    # and against the single-card Gram engine
    single = SparsePCABuilder().n_components(4).engine("gram").svd_method(
        SVDMethod.random(10, 7, PIN.QR)).random_seed(3).build()
    T1 = single.fit_transform(cpu(data))
    np.testing.assert_allclose(np_(r8.explained_variance), single.explained_variance_, rtol=1e-5)
    assert rel_max(np_(r8.transformed), np_(T1)) < 1e-5


def test_sharded_gram_masked(data):
    p = data.shape[1]
    mask = np.zeros(p, bool)
    mask[::2] = True
    res = P.sharded_gram_pca(cpu(data), tmesh(4), n_components=3, mask=mask, seed=1)
    assert tuple(res.components.shape) == (3, int(mask.sum()))
    ev = np_(res.explained_variance).astype(np.float64)
    ev_ref = _truth(data[:, mask].tocsr(), 3)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    jres = _jax_gram_pca(data, 4, n_components=3, mask=mask, seed=1)
    np.testing.assert_allclose(ev, np.asarray(jres.explained_variance), rtol=1e-5)
    assert res.total_variance == pytest.approx(jres.total_variance, rel=1e-10)
    with pytest.raises(ValueError, match="mask vector length"):
        P.sharded_gram_pca(cpu(data), tmesh(2), n_components=2, mask=mask[:-1])


def test_sharded_gram_uncentered(data):
    res = P.sharded_gram_pca(cpu(data), tmesh(4), n_components=3, center=False, seed=2)
    s_ref = np.linalg.svd(data.toarray().astype(np.float64), compute_uv=False)
    ev_ref = s_ref[:3] ** 2 / (data.shape[0] - 1)
    ev = np_(res.explained_variance).astype(np.float64)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    jres = _jax_gram_pca(data, 4, n_components=3, center=False, seed=2)
    np.testing.assert_allclose(ev, np.asarray(jres.explained_variance), rtol=1e-5)


def test_sharded_gram_odd_slab_granularity():
    """n / ndev between 1,024 and 8,192 off the 1,024 grid: every class's
    sub-slab is a whole number of 1,024-row blocks."""

    X = cluster_counts(10_000, 60, n_clusters=4, seed=9).astype(np.float32)
    op = P.ShardedGram.from_matrix(cpu(X), tmesh(8))
    assert all(s <= 1024 or s % 1024 == 0 for _, _, s in op.bwidths)
    res = P.sharded_gram_pca(cpu(X), tmesh(8), n_components=3, seed=0)
    ev = np_(res.explained_variance).astype(np.float64)
    ev_ref = _truth(X, 3)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    assert tuple(res.transformed.shape) == (10_000, 3)


def test_sharded_gram_bucketed_payload_tracks_row_structure():
    """On power-law rows the bucketed payload is far smaller than one
    global-width layout, and the engine stays exact, in natural row
    order."""

    rng = np.random.default_rng(13)
    n, p = 4000, 96
    X = sp.random(n, p, density=0.02, format="csr", dtype=np.float32, random_state=rng,
                  data_rvs=lambda s: rng.poisson(2, s) + 1.0).tolil()
    X[7] = rng.poisson(3, p) + 1.0  # one dense row
    X = X.tocsr().astype(np.float32)
    mesh = tmesh(4)
    op = P.ShardedGram.from_matrix(cpu(X), mesh)
    assert len(op.bwidths) >= 2
    assert op.payload_bytes < 0.55 * op.unbucketed_payload_bytes, (
        op.payload_bytes, op.unbucketed_payload_bytes, op.bwidths)
    res = P.sharded_gram_pca(cpu(X), mesh, n_components=3, seed=0)
    ev = np_(res.explained_variance).astype(np.float64)
    ev_ref = _truth(sp.csr_matrix(X), 3)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 1e-4
    D = X.toarray().astype(np.float64)
    T_ref = (D - D.mean(axis=0)) @ np_(res.components).astype(np.float64).T
    T = np_(res.transformed)
    assert np.abs(np.abs(T) - np.abs(T_ref)).max() < 1e-3 * np.abs(T_ref).max()


def test_sharded_gram_rejects_bad_slab(data):
    with pytest.raises(ValueError, match="slab"):
        P.ShardedGram.from_matrix(cpu(data), tmesh(2), slab=1500)


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_sharded_gram_payload_matches_jax(ndev):
    """The host build: class plan, payloads and the position map are the
    JAX engine's arrays (the JAX ``pos_local`` as int32)."""

    rng = np.random.default_rng(21)
    X = sp.random(700, 80, density=0.05, format="csr", dtype=np.float32, random_state=rng,
                  data_rvs=lambda s: rng.poisson(2, s) + 1.0).tolil()
    X[3] = rng.poisson(3, 80) + 1.0
    X = X.tocsr().astype(np.float32)
    op = P.ShardedGram.from_matrix(cpu(X), tmesh(ndev))
    jop = JP.ShardedGram.from_matrix(JMatrix.from_scipy(X), JP.make_mesh(ndev))
    assert op.bwidths == tuple(tuple(int(v) for v in b) for b in jop.bwidths)
    assert op.meta == tuple(jop.meta) and op.payload_bytes == jop.payload_bytes
    for b in range(len(op.bwidths)):
        np.testing.assert_array_equal(np.stack([np_(d[b]) for d in op.bdata]),
                                      np.asarray(jop.bdata[b]))
        np.testing.assert_array_equal(np.stack([np_(d[b]) for d in op.blocal]),
                                      np.asarray(jop.blocal[b]))
    np.testing.assert_array_equal(np.stack([np_(p) for p in op.pos_local]),
                                  np.asarray(jop.pos_local))
    G, Gj = np_(op.gram()), np.asarray(jop.gram())
    assert rel_max(G, Gj) == 0.0  # int8 tier: exact products, exact sums


# -- the budget of a mesh that repeats a device ------------------------------------


def test_mesh_budget_counts_each_device_once(monkeypatch):
    """Four entries on one device plan for that device's budget, not four
    times it: the ladder must not take 'dense' for a matrix whose dense
    form needs more than one device holds, and the Gram engine plans its
    column tile for one device's budget."""

    budget = 60_000
    monkeypatch.setattr(DensifiedOperator, "hbm_budget_bytes", staticmethod(lambda device: budget))
    monkeypatch.setattr(ppca, "_on_cuda", lambda mesh: True)
    mesh = tmesh(4)
    assert P.mesh_budget_bytes(mesh, DensifiedOperator.hbm_budget_bytes) == budget
    X = cluster_counts(200, 100, n_clusters=4, seed=1).astype(np.float32)  # dense bf16 40 kB
    assert P.choose_sharded_engine(cpu(X), mesh) == "dense"
    X = cluster_counts(400, 100, n_clusters=4, seed=1).astype(np.float32)  # 80 kB: 1x < it < 4x
    assert P.choose_sharded_engine(cpu(X), mesh) != "dense"
    seen = []
    choose = tgram.GramPCAEngine.choose_col_tile.__func__

    def spy(cls, m, budget_bytes=None):
        seen.append(budget_bytes)
        return choose(cls, m, budget_bytes)

    monkeypatch.setattr(tgram.GramPCAEngine, "choose_col_tile", classmethod(spy))
    P.ShardedGram.from_matrix(cpu(X), mesh)
    assert seen == [budget]


# -- the entry points ------------------------------------------------------------


def test_sharded_fits_are_deterministic_and_cached(data):
    m = cpu(data)
    mesh = tmesh(4)
    a = P.sharded_pca_fit_transform(m, n_components=4, mesh=mesh, engine="tiled")
    b = P.sharded_pca_fit_transform(m, n_components=4, mesh=mesh, engine="tiled")
    assert torch.equal(a.transformed, b.transformed)
    assert torch.equal(a.explained_variance, b.explained_variance)
    assert isinstance(m._operator_cache[("sharded", "tiled", mesh)], P.ShardedTiled)
    g1 = P.sharded_gram_pca(m, mesh, n_components=4)
    g2 = P.sharded_gram_pca(m, mesh, n_components=4)
    assert torch.equal(g1.transformed, g2.transformed)
    op = m._operator_cache[("sharded", "gram", mesh)]
    assert torch.equal(op.gram(), op.gram_cached())
    # 'auto' on a CPU mesh is the gather engine; a prebuilt engine is taken as is
    c = P.sharded_pca_fit_transform(m, n_components=4, mesh=mesh, engine="auto")
    assert isinstance(m._operator_cache[("sharded", "sparse", mesh)], P.ShardedSpMM)
    d = P.sharded_pca_fit_transform(m._operator_cache[("sharded", "sparse", mesh)],
                                    n_components=4)
    assert torch.equal(c.transformed, d.transformed)
    with pytest.raises(ValueError, match="engine"):
        P.sharded_pca_fit_transform(m, n_components=4, mesh=mesh, engine="bogus")


def test_sharded_uncentered_pca_matches_jax(monkeypatch):
    X = cluster_counts(300, 70, n_clusters=5, seed=8)
    jres = JP.sharded_pca_fit_transform(X, n_components=4, mesh=JP.make_mesh(2),
                                        svd_method=JSVD.random(10, 7, JPIN.QR), center=False)
    inject_sketch(monkeypatch, jax_normal((70, 14), 42, jnp.float64))
    res = P.sharded_pca_fit_transform(X, n_components=4, mesh=tmesh(2), center=False)
    np.testing.assert_allclose(np_(res.explained_variance), np.asarray(jres.explained_variance),
                               rtol=1e-10)
    assert res.total_variance == pytest.approx(jres.total_variance, rel=1e-10)
    assert not np_(res.mean).any()


def test_parallel_imports_no_jax():
    code = (
        "import sys, numpy as np, scipy.sparse as sp\n"
        "from single_algebra_tpu_torch import SparseMatrix, parallel as P\n"
        "X = sp.random(300, 40, density=0.2, format='csr', random_state=0, dtype=np.float32)\n"
        "m = SparseMatrix.from_scipy(X, device='cpu')\n"
        "mesh = P.make_mesh(3, device='cpu')\n"
        "for e in ('sparse', 'tiled', 'dense'):\n"
        "    assert P.sharded_pca_fit_transform(m, 3, mesh=mesh, engine=e).transformed.shape"
        " == (300, 3)\n"
        "assert P.sharded_gram_pca(m, mesh, 3).transformed.shape == (300, 3)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'single_algebra_tpu', 'ml_dtypes', 'sklearn'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
