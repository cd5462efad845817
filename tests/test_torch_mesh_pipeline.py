"""``parallel/pipeline.py`` of the torch port against the JAX package.

Each of the eleven mesh stages runs on the port's ``ShardedSpMM`` over
``make_mesh(8, device="cpu")`` and on the JAX ``ShardedSpMM`` over the
JAX 8-device CPU mesh, from the same float32 cluster counts
(``tests/test_mesh_pipeline.py``'s fixture), and is held to the JAX
stage and to the port's single-device counterpart:

- counts (nonzeros, QC counts, ``pts``) exactly;
- float32 sums and moments within 1e-6 relative (the slab order of the
  reductions may differ from XLA's), variances 1e-5;
- mapped payloads (normalize, log1p, scale, a map of both ids) within
  1e-6 relative of the JAX payload as dense products ``A @ I``;
- HVG: the same mask, ``dispersions_norm`` within 1e-5 of the largest
  |value| for 'seurat' (the smoke's bar), 1e-4 for 'cell_ranger';
- grouped moments and t-tests: float64 sums in the port, so 1e-12 from
  the port's single device and 1e-5 from the JAX package's float32 sums.
"""

import numpy as np
import pytest
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu import parallel as JP
from single_algebra_tpu.parallel import pipeline as jpipe
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch import de as tde
from single_algebra_tpu_torch import parallel as P
from single_algebra_tpu_torch.feature_selection import highly_variable_genes
from single_algebra_tpu_torch.preprocess import normalize_total
from single_algebra_tpu_torch.qc import calculate_qc_metrics
from tests.conftest import cluster_counts


@pytest.fixture(scope="module")
def data():
    X = cluster_counts(600, 120, n_clusters=8, seed=3).astype(np.float32)
    m = SparseMatrix.from_scipy(X, device="cpu")
    op = P.ShardedSpMM.from_matrix(m, P.make_mesh(8, device="cpu"))
    jop = JP.ShardedSpMM.from_matrix(JMatrix.from_scipy(X), JP.make_mesh(8))
    return X, m, op, jop


def dense(op):
    """The port's sharded operator materialized: A @ I."""

    return op.mv(torch.eye(op.shape[1], dtype=op.dtype)).numpy()


def jdense(jop):
    return np.asarray(jop.mv(np.eye(jop.shape[1], dtype=np.float32)))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_the_eleven_names_are_exported():
    assert set(jpipe.__all__) == set(P.pipeline.__all__)
    for name in jpipe.__all__:
        assert getattr(P, name) is getattr(P.pipeline, name)


def test_mesh_row_stats_match(data):
    X, m, op, jop = data
    s, nz = P.mesh_row_stats(op)
    js, jnz = jpipe.mesh_row_stats(jop)
    assert s.dtype == torch.float32 and nz.dtype == torch.int32
    assert rel(s, js) <= 1e-6 and rel(s, m.sum_row()) <= 1e-6
    np.testing.assert_array_equal(nz.numpy(), np.asarray(jnz))
    np.testing.assert_array_equal(nz.numpy(), m.nonzero_row().numpy())


def test_mesh_sum_row_masked_matches(data):
    X, m, op, jop = data
    mask = np.zeros(X.shape[1], bool)
    mask[::3] = True
    got = P.mesh_sum_row_masked(op, mask)
    assert rel(got, jpipe.mesh_sum_row_masked(jop, mask)) <= 1e-6
    assert rel(got, m.sum_row_masked(mask)) <= 1e-6
    with pytest.raises(ValueError, match="bool mask"):
        P.mesh_sum_row_masked(op, mask[:-1])
    with pytest.raises(ValueError, match="bool mask"):
        P.mesh_sum_row_masked(op, mask.astype(np.float32))


@pytest.mark.parametrize("expm1", [False, True])
def test_mesh_col_moments_match(data, expm1):
    X, m, op, jop = data
    src, jsrc = (P.mesh_log1p(op), jpipe.mesh_log1p(jop)) if expm1 else (op, jop)
    mean, var = P.mesh_col_moments(src, expm1=expm1)
    jmean, jvar = jpipe.mesh_col_moments(jsrc, expm1=expm1)
    assert mean.dtype == np.float64 and mean.shape == (X.shape[1],)
    np.testing.assert_allclose(mean, jmean, rtol=1e-6)
    np.testing.assert_allclose(var, jvar, rtol=1e-5, atol=1e-8)
    if not expm1:
        np.testing.assert_allclose(mean, m.sum_col().numpy() / X.shape[0], rtol=1e-6)
        np.testing.assert_allclose(var, m.var_col().numpy(), rtol=1e-5, atol=1e-8)


def test_mesh_qc_matches_jax_and_single_device(data):
    X, m, op, jop = data
    mito = np.zeros(X.shape[1], bool)
    mito[:7] = True
    obs_s, var_s = calculate_qc_metrics(m, qc_vars={"mito": mito})
    obs_m, var_m = P.mesh_qc_metrics(op, qc_vars={"mito": mito})
    obs_j, var_j = jpipe.mesh_qc_metrics(jop, qc_vars={"mito": mito})
    assert set(obs_m) == set(obs_s) == set(obs_j) and set(var_m) == set(var_s) == set(var_j)
    for ref in (obs_s, obs_j):
        for k in ref:
            np.testing.assert_allclose(obs_m[k], ref[k], rtol=1e-6, atol=1e-9)
    for ref in (var_s, var_j):
        for k in ref:
            np.testing.assert_allclose(var_m[k], ref[k], rtol=1e-6, atol=1e-9)
    for k in ("n_genes_by_counts",):
        np.testing.assert_array_equal(obs_m[k], obs_s[k])
    np.testing.assert_array_equal(var_m["n_cells_by_counts"], var_s["n_cells_by_counts"])
    with pytest.raises(ValueError, match="empty"):
        P.mesh_qc_metrics(P.ShardedSpMM.from_matrix(
            SparseMatrix.from_scipy(X[:, :0].tocsr(), device="cpu"), P.make_mesh(2, device="cpu")))


def test_mesh_normalize_log1p_matches(data):
    X, m, op, jop = data
    m_nl = normalize_total(m, target_sum=1e4)[0].log1p_normalize()
    op_n, sf = P.mesh_normalize_total(op, target_sum=1e4)
    jop_n, jsf = jpipe.mesh_normalize_total(jop, target_sum=1e4)
    np.testing.assert_allclose(sf, jsf, rtol=1e-12)
    op_nl, jop_nl = P.mesh_log1p(op_n), jpipe.mesh_log1p(jop_n)
    assert rel(dense(op_nl), jdense(jop_nl)) <= 1e-6
    assert rel(dense(op_nl), m_nl.to_dense()) <= 1e-6
    # the transposed layout was rewritten consistently too (column sums ride it)
    mean, _ = P.mesh_col_moments(op_nl)
    np.testing.assert_allclose(mean, m_nl.sum_col().numpy() / X.shape[0], rtol=1e-5)
    assert op_nl is not op_n and rel(dense(op), X.toarray()) == 0  # functional


def test_mesh_normalize_median_default_and_zero_rows():
    import scipy.sparse as sp

    X = sp.csr_matrix(np.array([[1, 0, 3], [0, 0, 0], [2, 2, 0], [0, 5, 0]], np.float32))
    m = SparseMatrix.from_scipy(X, device="cpu")
    op = P.ShardedSpMM.from_matrix(m, P.make_mesh(4, device="cpu"))
    jop = JP.ShardedSpMM.from_matrix(JMatrix.from_scipy(X), JP.make_mesh(4))
    m_n, sf_s = normalize_total(m)
    op_n, sf_m = P.mesh_normalize_total(op)
    jop_n, sf_j = jpipe.mesh_normalize_total(jop)
    np.testing.assert_allclose(sf_m, sf_s, rtol=1e-6)
    np.testing.assert_allclose(sf_m, sf_j, rtol=1e-12)
    d = dense(op_n)
    np.testing.assert_allclose(d, m_n.to_dense(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(d, jdense(jop_n), rtol=1e-6, atol=1e-7)
    assert not d[1].any()  # zero-sum row untouched, not NaN


def test_mesh_scale_matches(data):
    X, m, op, jop = data
    from single_algebra_tpu_torch.preprocess import scale

    got = dense(P.mesh_scale(op, max_value=3.0))
    assert rel(got, jdense(jpipe.mesh_scale(jop, max_value=3.0))) <= 1e-6
    assert rel(got, scale(m, zero_center=False, max_value=3.0).to_dense()) <= 1e-5
    assert rel(dense(P.mesh_scale(op)), jdense(jpipe.mesh_scale(jop))) <= 1e-6
    with pytest.raises(ValueError, match="zero_center"):
        P.mesh_scale(op, zero_center=True)


def test_mesh_map_stored_row_col_ids(data):
    X, m, op, jop = data
    op2 = P.mesh_map_stored(op, lambda v, r, c: v * (r + 1).to(v.dtype) + 0.0 * c)
    jop2 = jpipe.mesh_map_stored(jop, lambda v, r, c: v * (r + 1).astype(v.dtype) + 0.0 * c)
    ref = X.toarray() * (np.arange(X.shape[0]) + 1)[:, None]
    assert rel(dense(op2), ref) <= 1e-6 and rel(dense(op2), jdense(jop2)) <= 1e-6
    mean2, _ = P.mesh_col_moments(op2)
    np.testing.assert_allclose(mean2, ref.sum(0) / X.shape[0], rtol=1e-5)
    # the column ids, through the transposed layout's moments
    op3 = P.mesh_map_stored(op, lambda v, r, c: v * (c + 1).to(v.dtype))
    mean3, _ = P.mesh_col_moments(op3)
    np.testing.assert_allclose(mean3, (X.toarray() * (np.arange(120) + 1)).sum(0) / 600,
                               rtol=1e-5)


def test_mesh_map_stored_probe_and_remask(data, monkeypatch):
    X, m, op, jop = data
    bad = lambda v, r, c: v + 1.0
    # the transposed layout is re-masked whatever fn does to padding
    mean, _ = P.mesh_col_moments(P.mesh_map_stored(op, bad))
    jmean, _ = jpipe.mesh_col_moments(jpipe.mesh_map_stored(jop, lambda v, r, c: v + 1.0))
    np.testing.assert_allclose(mean, jmean, rtol=1e-6)
    monkeypatch.setenv("SINGLE_ALGEBRA_TPU_DEBUG", "1")
    with pytest.raises(ValueError, match="zero values to zero"):
        P.mesh_map_stored(op, bad)
    with pytest.raises(ValueError, match="zero values to zero"):
        jpipe.mesh_map_stored(jop, lambda v, r, c: v + 1.0)
    P.mesh_log1p(op)  # a zero-preserving map passes the probe


# cell_ranger standardizes by the bin's median absolute deviation, which
# amplifies the float32 moment rounding more (1.8e-5 measured): 1e-4
@pytest.mark.parametrize("flavor,kw,tol", [("seurat", dict(n_top_genes=25), 1e-5),
                                           ("cell_ranger", dict(n_top_genes=20), 1e-4),
                                           ("seurat", dict(min_mean=0.05, min_disp=0.3), 1e-5)])
def test_mesh_hvg_matches(data, flavor, kw, tol):
    X, m, op, jop = data
    m_nl = normalize_total(m, target_sum=1e4)[0].log1p_normalize()
    op_nl = P.mesh_log1p(P.mesh_normalize_total(op, target_sum=1e4)[0])
    jop_nl = jpipe.mesh_log1p(jpipe.mesh_normalize_total(jop, target_sum=1e4)[0])
    hm = P.mesh_highly_variable_genes(op_nl, flavor=flavor, **kw)
    hj = jpipe.mesh_highly_variable_genes(jop_nl, flavor=flavor, **kw)
    hs = highly_variable_genes(m_nl, flavor=flavor, **kw)
    for ref in (hj, hs):
        np.testing.assert_array_equal(hm.mask, ref.mask)
        np.testing.assert_allclose(hm.means, ref.means, rtol=1e-5)
        # the per-bin standardization amplifies float32 moment noise near
        # zero-dispersion bins: held to a share of the largest |value|
        assert rel(hm.dispersions_norm, ref.dispersions_norm) <= tol
    with pytest.raises(ValueError, match="not supported on the mesh"):
        P.mesh_highly_variable_genes(op_nl, flavor="seurat_v3", n_top_genes=5)


def test_mesh_grouped_moments_match(data):
    X, m, op, jop = data
    codes = np.random.default_rng(0).integers(0, 5, X.shape[0])
    sz, mean, var = P.mesh_grouped_moments(op, codes, 5)
    sz_s, mean_s, var_s = tde._full_moments(m, codes, 5)
    sz_j, mean_j, var_j = jpipe.mesh_grouped_moments(jop, codes.astype(np.int32), 5)
    np.testing.assert_array_equal(sz, sz_s)
    np.testing.assert_array_equal(sz, sz_j)
    assert rel(mean, mean_s) <= 1e-12 and rel(var, var_s) <= 1e-12
    np.testing.assert_allclose(mean, mean_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(var, var_j, rtol=1e-4, atol=1e-6)


def test_mesh_grouped_counts_match(data):
    X, m, op, jop = data
    codes = np.random.default_rng(2).integers(0, 4, X.shape[0])
    view = P.pipeline._MeshDEView(op)
    for kind in ("sum", "sumsq", "count"):
        got = view._batch_spmm("col", codes, kind).numpy()
        want = m._batch_spmm("col", codes, kind).numpy()
        assert got.shape == (120, 4)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(view._batch_spmm("col", codes, "count").numpy(),
                                  m._batch_spmm("col", codes, "count").numpy())
    with pytest.raises(ValueError, match="axis='col'"):
        view._batch_spmm("row", codes, "sum")


@pytest.mark.parametrize("method", ["t-test", "t-test_overestim_var"])
@pytest.mark.parametrize("reference", ["rest", "c1"])
def test_mesh_rank_genes_groups_matches(data, method, reference):
    X, m, op, jop = data
    labels = [f"c{i}" for i in np.random.default_rng(1).integers(0, 4, X.shape[0])]
    rm = P.mesh_rank_genes_groups(op, labels, method=method, reference=reference, pts=True)
    rs = tde.rank_genes_groups(m, labels, method=method, reference=reference, pts=True)
    rj = jpipe.mesh_rank_genes_groups(jop, labels, method=method, reference=reference, pts=True)
    assert set(rm.names) == set(rs.names) == set(rj.names)
    for g in rs.names:
        # the port's own single device: the same float64 sums
        np.testing.assert_array_equal(rm.names[g], rs.names[g])
        np.testing.assert_allclose(rm.scores[g], rs.scores[g], rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(rm.pts[g], rs.pts[g])
        np.testing.assert_array_equal(rm.pts_rest[g], rs.pts_rest[g])
        # the JAX mesh (float32 grouped sums there)
        np.testing.assert_array_equal(rm.names[g], rj.names[g])
        np.testing.assert_allclose(rm.scores[g], rj.scores[g], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(rm.pvals[g], rj.pvals[g], rtol=1e-4, atol=1e-12)
        np.testing.assert_allclose(rm.logfoldchanges[g], rj.logfoldchanges[g], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(rm.pts[g], rj.pts[g], rtol=1e-6)


def test_mesh_de_rejects_entrywise_methods(data):
    _, _, op, _ = data
    labels = ["a"] * 300 + ["b"] * 300
    for bad in ("wilcoxon", "logreg"):
        with pytest.raises(ValueError, match="not supported on the mesh"):
            P.mesh_rank_genes_groups(op, labels, method=bad)


def test_mesh_size_invariance(data):
    X, m, op8, _ = data
    op1 = P.ShardedSpMM.from_matrix(m, P.make_mesh(1, device="cpu"))
    mean8, var8 = P.mesh_col_moments(op8)
    mean1, var1 = P.mesh_col_moments(op1)
    np.testing.assert_allclose(mean8, mean1, rtol=1e-6)
    np.testing.assert_allclose(var8, var1, rtol=1e-5, atol=1e-8)
    n8, sf8 = P.mesh_normalize_total(op8, target_sum=1e4)
    n1, sf1 = P.mesh_normalize_total(op1, target_sum=1e4)
    np.testing.assert_allclose(sf8, sf1, rtol=1e-6)
    np.testing.assert_allclose(dense(n8), dense(n1), rtol=1e-6, atol=1e-7)


def test_single_card_de_is_unchanged_by_the_seam(data):
    """``de._full_moments`` of a SparseMatrix takes its own layout, as
    before the mesh seam (the JAX package's moments at float32)."""

    from single_algebra_tpu import de as jde

    X, m, _, _ = data
    codes = np.random.default_rng(3).integers(0, 3, X.shape[0])
    got = tde._full_moments(m, codes, 3)
    want = jde._full_moments(JMatrix.from_scipy(X), codes.astype(np.int32), 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)
