"""Differential fuzz of the port against the JAX package.

The JAX suite's three fuzz files, each case run on both packages from the
same numpy inputs (the port on the CPU) and held to the numpy / scipy
mirror as the JAX files hold it, and to the JAX package's result:

* ``tests/test_fuzz_stats.py``: every statistic over shape, density,
  format and dtype. Against JAX: float32 within 1e-5 of the largest value,
  float64 within 1e-9 of it; counts and min / max exact.
* ``tests/test_fuzz_structural.py``: random chains of value maps,
  selections and transposes (the JAX list plus a one-way transpose),
  checked after every step: ``to_dense``, ``sum_row``, ``sum_col``,
  ``var_col`` and ``nonzero_col`` within 1e-5 of the largest value, the
  same ``format`` and dtype; then a mapped, selected matrix into
  ``SparsePCABuilder`` from the JAX package's sketch.
* ``tests/test_fuzz_pipeline.py``: QC, ``normalize_total``, ``scale``,
  ``aggregate`` and the t-test ``rank_genes_groups`` over odd shapes,
  within 1e-5 of the largest value of the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import single_algebra_tpu as jsat
import single_algebra_tpu.models as jmodels
import single_algebra_tpu_torch as tsat
from single_algebra_tpu.de import rank_genes_groups as j_rank_genes_groups
from single_algebra_tpu.preprocess import aggregate as j_aggregate
from single_algebra_tpu.preprocess import normalize_total as j_normalize_total
from single_algebra_tpu.preprocess import scale as j_scale
from single_algebra_tpu.types import Direction as JDirection
from single_algebra_tpu.types import SVDMethod as JSVDMethod
from single_algebra_tpu_torch.de import rank_genes_groups
from single_algebra_tpu_torch.linalg import svd as tsvd
from single_algebra_tpu_torch.preprocess import aggregate, normalize_total, scale
from single_algebra_tpu_torch.types import Direction, SVDMethod
from tests.test_fuzz_pipeline import CASES as PIPELINE_CASES
from tests.test_fuzz_pipeline import _mk
from tests.test_fuzz_stats import CASES as STATS_CASES


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, rel):
    """``got`` (port) within ``rel`` of the largest |value| of ``want`` (JAX)."""

    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale_ = max(float(np.abs(want[np.isfinite(want)]).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale_, equal_nan=True)


# -- every statistic -----------------------------------------------------------


@pytest.mark.parametrize("n,p,density,fmt,dtype,seed", STATS_CASES)
def test_stats_sweep_matches_jax(n, p, density, fmt, dtype, seed):
    rng = np.random.default_rng(seed)
    X = sp.random(
        n, p, density=density, format="csr", dtype=np.float64,
        random_state=rng, data_rvs=lambda s: rng.standard_normal(s),
    ).astype(dtype)
    m = tsat.SparseMatrix.from_scipy(X, fmt=fmt, dtype=dtype, device="cpu")
    jm = jsat.SparseMatrix.from_scipy(X, fmt=fmt, dtype=dtype)
    dense = X.toarray()
    f32 = dtype == np.float32
    tol = dict(rtol=2e-4, atol=1e-4) if f32 else dict(rtol=1e-9, atol=1e-12)
    rel = 1e-5 if f32 else 1e-9
    assert m.format == jm.format == fmt

    def check(name, got, want, mirror):
        assert _np(got).dtype == _np(want).dtype, name
        _same(got, want, rel)
        np.testing.assert_allclose(_np(got), mirror, **tol, err_msg=name)

    check("sum_row", m.sum_row(), jm.sum_row(), dense.sum(1))
    check("sum_col", m.sum_col(), jm.sum_col(), dense.sum(0))
    check("sum_row_squared", m.sum_row_squared(), jm.sum_row_squared(), (dense**2).sum(1))
    for got, want, mirror in ((m.nonzero_row(), jm.nonzero_row(), (dense != 0).sum(1)),
                              (m.nonzero_col(), jm.nonzero_col(), (dense != 0).sum(0))):
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(got), mirror)
    if n > 1:
        check("var_col", m.var_col(), jm.var_col(), dense.var(0, ddof=1))
    (mins, maxs), (jmins, jmaxs) = m.min_max_row(), jm.min_max_row()
    np.testing.assert_array_equal(_np(mins), _np(jmins))
    np.testing.assert_array_equal(_np(maxs), _np(jmaxs))
    for i in range(n):
        nz = dense[i][dense[i] != 0]
        if nz.size:
            assert _np(mins)[i] == nz.min() and _np(maxs)[i] == nz.max()

    mask = rng.random(n) < 0.5
    check("sum_col_masked", m.sum_col_masked(mask), jm.sum_col_masked(mask),
          dense[mask].sum(0))
    check("sum_row_n_top", m.sum_row_n_top(3), jm.sum_row_n_top(3),
          [np.sort(dense[i][dense[i] != 0])[::-1][:3].sum() for i in range(n)])

    B = rng.standard_normal((p, 4)).astype(dtype)
    got, want = m.matmul_dense(B), jm.matmul_dense(B)
    _same(got, want, rel)
    np.testing.assert_allclose(_np(got), dense @ B, rtol=1e-3 if f32 else 1e-9,
                               atol=1e-3 if f32 else 1e-9)


# -- structural chains ---------------------------------------------------------

OPS = ["log1p", "normalize_row", "normalize_col", "map_rc", "select_rows",
       "select_cols", "transpose_roundtrip", "transpose"]


def _chain_check(m, jm, D):
    """The port's matrix against the JAX package's and the dense mirror."""

    assert m.shape == tuple(jm.shape) == D.shape
    assert m.format == jm.format
    dense, jdense = m.to_dense(), jm.to_dense()
    assert dense.dtype == jdense.dtype == np.dtype(str(jm.dtype))
    assert str(m.dtype).split(".")[-1] == str(jm.dtype)
    _same(dense, jdense, 1e-5)
    np.testing.assert_allclose(dense, D, rtol=2e-5, atol=1e-5)
    for name, mirror in (("sum_row", D.sum(1)), ("sum_col", D.sum(0))):
        got = getattr(m, name)()
        _same(got, getattr(jm, name)(), 1e-5)
        np.testing.assert_allclose(_np(got), mirror, rtol=2e-5, atol=1e-4, err_msg=name)
    got = m.nonzero_col()
    np.testing.assert_array_equal(_np(got), _np(jm.nonzero_col()))
    np.testing.assert_array_equal(_np(got), (D != 0).sum(0))
    if D.shape[0] > 1:
        got = m.var_col()
        _same(got, jm.var_col(), 1e-5)
        np.testing.assert_allclose(_np(got), D.var(0, ddof=1), rtol=2e-4, atol=1e-4)


def _take(t, i):
    return t[i.long().clamp(0, t.shape[0] - 1)]


def _apply_random_op(rng, m, jm, D):
    """One random op applied to the port's matrix, the JAX package's and the
    dense mirror; returns the three results."""

    op = rng.choice(OPS)
    if op == "log1p":
        return m.log1p_normalize(), jm.log1p_normalize(), np.log1p(D)
    if op in ("normalize_row", "normalize_col"):
        row = op == "normalize_row"
        target = 50.0 if row else 25.0
        sums = _np(m.sum_row() if row else m.sum_col())
        jsums = _np(jm.sum_row() if row else jm.sum_col())
        mm = m.normalize(sums.astype(np.float32), target,
                         Direction.ROW if row else Direction.COLUMN)
        jmm = jm.normalize(jsums.astype(np.float32), target,
                           JDirection.ROW if row else JDirection.COLUMN)
        s = np.where(jsums > 0, target / np.where(jsums > 0, jsums, 1), 1.0)
        return mm, jmm, D * (s[:, None] if row else s[None, :])
    if op == "map_rc":
        rf = rng.uniform(0.5, 1.5, m.shape[0]).astype(np.float32)
        cf = rng.uniform(0.5, 1.5, m.shape[1]).astype(np.float32)
        rft, cft = torch.from_numpy(rf), torch.from_numpy(cf)
        rfd, cfd = jnp.asarray(rf), jnp.asarray(cf)
        mm = m.map_stored(lambda v, r, c: v * _take(rft, r).to(v.dtype)
                          * _take(cft, c).to(v.dtype))
        jmm = jm.map_stored(lambda v, r, c: v * jnp.take(rfd, r, mode="clip")
                            * jnp.take(cfd, c, mode="clip"))
        return mm, jmm, D * rf[:, None] * cf[None, :] * (D != 0)
    if op == "select_rows":
        k = rng.integers(1, m.shape[0] + 1)
        rows = rng.choice(m.shape[0], size=k, replace=False)
        return m.select_rows(rows), jm.select_rows(rows), D[rows]
    if op == "select_cols":
        mask = rng.random(m.shape[1]) < 0.6
        if not mask.any():
            mask[rng.integers(0, m.shape[1])] = True
        return m.select_cols(mask), jm.select_cols(mask), D[:, mask]
    if op == "transpose":  # the same logical matrix, stored along the other axis
        return m.transpose(), jm.transpose(), D
    return m.transpose().transpose(), jm.transpose().transpose(), D


@pytest.mark.filterwarnings("ignore:map_stored received a lambda")
@pytest.mark.parametrize("seed", range(8))
def test_random_chains_match_jax(seed):
    """Seeds 0-3 draw the JAX file's float64 matrices; 4-7 the same recipe
    in float32."""

    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 80))
    p = int(rng.integers(8, 80))
    density = float(rng.uniform(0.05, 0.5))
    fmt = "csr" if rng.random() < 0.5 else "csc"
    A = sp.random(n, p, density=density, random_state=int(seed) + 100, format="csr")
    A.data = rng.uniform(0.25, 3.0, A.nnz).astype(np.float64)
    dtype = np.float64 if seed < 4 else np.float32
    A = A.astype(dtype)
    m = tsat.SparseMatrix.from_scipy(A.asformat(fmt), dtype=dtype, device="cpu")
    jm = jsat.SparseMatrix.from_scipy(A.asformat(fmt), dtype=dtype)
    D = A.toarray().astype(np.float64)
    if rng.random() < 0.5:
        m.sum_col()  # pre-build the twin on some chains
        jm.sum_col()
    _chain_check(m, jm, D)
    for _ in range(int(rng.integers(3, 7))):
        m, jm, D = _apply_random_op(rng, m, jm, D)
        _chain_check(m, jm, D)


def test_chain_ends_with_engine_fit(monkeypatch):
    """A normalized, log1p'd, column-selected matrix into ``SparsePCABuilder``:
    the port's fit from the JAX package's sketch gives the JAX fit's
    explained variance within 1e-5, and a host rebuild's within 1e-4 (the
    JAX file's bar)."""

    def jax_sketch(p, l, seed, *, dtype, device):
        key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        omega = np.array(jax.random.normal(key, (p, l), dtype=jnp.float32))
        return torch.from_numpy(omega).to(device=device, dtype=dtype)

    monkeypatch.setattr(tsvd, "gaussian_sketch", jax_sketch)
    rng = np.random.default_rng(42)
    lam = rng.gamma(0.5, 2.0, (6, 120)).astype(np.float32)
    lab = rng.integers(0, 6, 900)
    X = sp.csr_matrix(rng.poisson(lam[lab]).astype(np.float32))
    cols = np.arange(120) % 3 != 0

    def chain(pkg, direction, **kw):
        m = pkg.SparseMatrix.from_scipy(X, **kw)
        sums = _np(m.sum_row())
        return m.normalize(sums.astype(np.float32), 100.0, direction).log1p_normalize() \
            .select_cols(cols), sums

    ms, sums = chain(tsat, Direction.ROW, device="cpu")
    jms, _ = chain(jsat, JDirection.ROW)
    assert ms._h_data is None and jms._h_data is None

    def fit(pkg, method, mat):
        return (pkg.SparsePCABuilder().n_components(5).svd_method(method.random(10, 7))
                .build().fit(mat))

    ev = np.asarray(fit(tsat, SVDMethod, ms).explained_variance_, np.float64)
    jev = np.asarray(fit(jmodels, JSVDMethod, jms).explained_variance_, np.float64)
    _same(ev, jev, 1e-5)

    D = np.asarray(X.todense(), np.float64)
    s = np.where(sums > 0, 100.0 / np.where(sums > 0, sums, 1), 1.0)
    ref = tsat.SparseMatrix.from_scipy(sp.csr_matrix(np.log1p(D * s[:, None])[:, cols]),
                                       dtype=np.float32, device="cpu")
    ev_ref = np.asarray(fit(tsat, SVDMethod, ref).explained_variance_, np.float64)
    np.testing.assert_allclose(ev, ev_ref, rtol=1e-4)


# -- the pipeline layer --------------------------------------------------------


def _both(X):
    return (tsat.SparseMatrix.from_scipy(X, device="cpu"), jsat.SparseMatrix.from_scipy(X))


@pytest.mark.parametrize("n,p,density,fmt", PIPELINE_CASES)
def test_fuzz_qc_and_normalize_match_jax(n, p, density, fmt):
    X, _ = _mk(n, p, density, fmt, seed=n * 31 + p)
    m, jm = _both(X)
    Xd = X.toarray().astype(np.float64)

    (obs, var), (jobs, jvar) = (tsat.calculate_qc_metrics(m, log1p=False),
                                jsat.calculate_qc_metrics(jm, log1p=False))
    for got, want in ((obs, jobs), (var, jvar)):
        assert set(got) == set(want)
        for key in want:
            _same(got[key], want[key], 1e-5)
    np.testing.assert_array_equal(obs["n_genes_by_counts"], (Xd > 0).sum(1))
    np.testing.assert_allclose(obs["total_counts"], Xd.sum(1), rtol=1e-6)
    np.testing.assert_array_equal(var["n_cells_by_counts"], (Xd > 0).sum(0))

    (out, sf), (jout, jsf) = (normalize_total(m, target_sum=100.0),
                              j_normalize_total(jm, target_sum=100.0))
    _same(sf, jsf, 1e-5)
    _same(out.to_dense(), jout.to_dense(), 1e-5)
    sums = Xd.sum(1)
    ref = Xd * np.where(sums > 0, 100.0 / np.where(sums > 0, sums, 1), 1.0)[:, None]
    np.testing.assert_allclose(out.to_dense(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,p,density,fmt", PIPELINE_CASES)
def test_fuzz_scale_and_aggregate_match_jax(n, p, density, fmt):
    X, rng = _mk(n, p, density, fmt, seed=n * 7 + p)
    m, jm = _both(X)
    Xd = X.toarray().astype(np.float64)

    Z = _np(scale(m))
    _same(Z, j_scale(jm), 1e-5)
    mean = Xd.mean(0)
    std = Xd.std(0, ddof=1) if n > 1 else np.ones(p)
    std = np.where(std > 0, std, 1.0)
    np.testing.assert_allclose(Z, (Xd - mean) / std, rtol=2e-4, atol=2e-4)

    labels = rng.choice(["u", "v"], n).tolist()
    labels[0] = "u"
    if n > 1:
        labels[1] = "v"
    funcs = ("mean", "count_nonzero")
    agg, jagg = aggregate(m, labels, funcs=funcs), j_aggregate(jm, labels, funcs=funcs)
    assert list(agg["groups"]) == list(jagg["groups"])
    _same(agg["mean"], jagg["mean"], 1e-5)
    np.testing.assert_array_equal(agg["count_nonzero"], jagg["count_nonzero"])
    lab = np.asarray(labels)
    for gi, g in enumerate(agg["groups"]):
        sel = Xd[lab == g]
        np.testing.assert_allclose(agg["mean"][gi], sel.mean(0), rtol=1e-5, atol=1e-8)
        np.testing.assert_array_equal(agg["count_nonzero"][gi], (sel > 0).sum(0))


@pytest.mark.parametrize("n,p,density,fmt", PIPELINE_CASES)
def test_fuzz_de_ttest_matches_jax(n, p, density, fmt):
    """The JAX file runs the cases of 17 rows and more; the two smaller ones
    run here too, held to the JAX package alone."""

    from scipy import stats

    X, rng = _mk(n, p, density, fmt, seed=n * 13 + p)
    m, jm = _both(X)
    Xd = X.toarray().astype(np.float64)
    lab = rng.choice(["a", "b"], n)
    lab[: n // 2] = "a"
    lab[n // 2:] = "b"
    kw = dict(method="t-test", log1p_input=False)
    res, jres = rank_genes_groups(m, lab.tolist(), **kw), j_rank_genes_groups(
        jm, lab.tolist(), **kw)
    order, jorder = np.argsort(res.names["a"]), np.argsort(jres.names["a"])
    got_t = np.asarray(res.scores["a"])[order]
    _same(got_t, np.asarray(jres.scores["a"])[jorder], 1e-5)
    assert np.isfinite(got_t).all()
    if n < 17:
        return
    with np.errstate(divide="ignore", invalid="ignore"):
        ref_t, _ = stats.ttest_ind(Xd[lab == "a"], Xd[lab == "b"], equal_var=False)
    ok = np.isfinite(ref_t)
    np.testing.assert_allclose(got_t[ok], ref_t[ok], rtol=5e-3, atol=1e-4)
