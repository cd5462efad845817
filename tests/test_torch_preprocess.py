"""The port's value maps and device-valued matrices against the JAX package.

``normalize`` is held to JAX bit for bit (float32 division then
multiplication rounds the same in both); ``log1p_normalize`` and
``map_stored`` within 2 ULP of the JAX values (the JAX package uses its
own precise log1p, the port ``torch.log1p``); ``dense`` within the same
bounds. Selections, transposes and the carry-across of a JAX matrix whose
values live on the device only are exact.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import single_algebra_tpu.dense as jdense
from single_algebra_tpu import Direction as JDirection
from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu_torch import Direction, SparseMatrix, dense
from single_algebra_tpu_torch.sparse import csc_matrix, csr_matrix, random_sparse

DIRS = [(Direction.ROW, JDirection.ROW), (Direction.COLUMN, JDirection.COLUMN)]


def counts(n=40, p=30, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = sp.random(n, p, density=0.25, format="csr", random_state=rng,
                  data_rvs=lambda s: rng.integers(1, 50, s)).astype(dtype)
    X = X.tolil()
    X[3, :] = 0  # an empty row: zero sum
    X[:, 5] = 0  # an empty column
    return X.tocsr()


def both(X, fmt, dtype=np.float32):
    return (SparseMatrix.from_scipy(X, fmt=fmt, dtype=dtype, device="cpu"),
            JMatrix.from_scipy(X, fmt=fmt, dtype=dtype))


def line_sums(X, direction):
    axis = 1 if direction == Direction.ROW else 0
    s = np.asarray(X.sum(axis=axis)).ravel().astype(X.dtype)
    s[1] = -s[1]  # a negative sum: left untouched, as a zero one
    return s


def ulp_err(got, want):
    want = np.asarray(want, np.float32)
    return (np.abs(np.asarray(got, np.float64) - want)
            / np.spacing(np.maximum(np.abs(want), np.finfo(np.float32).tiny))).max(initial=0)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("tdir, jdir", DIRS, ids=["row", "column"])
@pytest.mark.parametrize("twin", [False, True], ids=["one_layout", "transpose_twin"])
def test_normalize_bit_for_bit(fmt, tdir, jdir, twin):
    X = counts()
    tm, jm = both(X, fmt)
    if twin:  # the other layout cached first: the map applies to both
        tm.transpose(), jm.transpose()
    sums = line_sums(X, tdir)
    tn, jn = tm.normalize(sums, 1e4, tdir), jm.normalize(sums, 1e4, jdir)
    assert (tn._transpose_cache is not None) == twin  # the map links the twins
    np.testing.assert_array_equal(tn.ell_data.numpy(), np.asarray(jn.ell_data))
    np.testing.assert_array_equal(tn.to_dense(), jn.to_dense())
    t_other, j_other = tn.transpose(), jn.transpose()
    np.testing.assert_array_equal(t_other.ell_data.numpy(), np.asarray(j_other.ell_data))
    # zero- and negative-sum lines are left as they were
    dense_in, dense_out = X.toarray(), tn.to_dense()
    # line 1 has a negative sum; row 3 and column 5 are empty (zero sum)
    for line in (1, 3) if tdir == Direction.ROW else (1, 5):
        sl = (line, slice(None)) if tdir == Direction.ROW else (slice(None), line)
        np.testing.assert_array_equal(dense_out[sl], dense_in[sl])


def test_normalize_sums_length_error():
    tm, jm = both(counts(), "csr")
    with pytest.raises(ValueError) as te:
        tm.normalize(np.ones(7), 1.0, Direction.ROW)
    with pytest.raises(ValueError) as je:
        jm.normalize(np.ones(7), 1.0, JDirection.ROW)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("twin", [False, True], ids=["one_layout", "transpose_twin"])
def test_log1p_within_2_ulp(fmt, twin):
    X = counts(seed=1)
    tm, jm = both(X, fmt)
    if twin:
        tm.transpose(), jm.transpose()
    tl = tm.normalize(tm.sum_row(), 1e4, Direction.ROW).log1p_normalize()
    jl = jm.normalize(tm.sum_row().numpy(), 1e4, JDirection.ROW).log1p_normalize()
    assert ulp_err(tl.to_dense(), jl.to_dense()) <= 2
    assert ulp_err(tl.transpose().to_dense(), jl.transpose().to_dense()) <= 2
    if twin:
        assert tl._transpose_cache._transpose_cache is tl


def _affine(v, r, c, scale):
    return v * scale + r.to(v.dtype) * 0.5 - c.to(v.dtype)


def _affine_jax(v, r, c, scale):
    return v * scale + r.astype(v.dtype) * 0.5 - c.astype(v.dtype)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_map_stored_matches_jax(fmt):
    X = counts(seed=2)
    tm, jm = both(X, fmt)
    tm.transpose(), jm.transpose()
    tout = tm.map_stored(_affine, np.float32(0.25))
    jout = jm.map_stored(_affine_jax, np.float32(0.25))
    assert ulp_err(tout.to_dense(), jout.to_dense()) <= 2
    # implicit zeros stay zero; the map saw (row, col) of each stored entry
    D = X.toarray()
    want = np.where(D != 0, D * 0.25 + np.arange(D.shape[0])[:, None] * 0.5
                    - np.arange(D.shape[1])[None, :], 0)
    np.testing.assert_allclose(tout.to_dense(), want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tout.transpose().to_dense(), want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("tdir, jdir", DIRS, ids=["row", "column"])
def test_dense_normalize_and_log1p(tdir, jdir):
    rng = np.random.default_rng(3)
    A = rng.random((6, 5)).astype(np.float32) * 10
    sums = A.sum(axis=1 if tdir == Direction.ROW else 0)
    got = dense.normalize(A, sums, 1e4, tdir, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jdense.normalize(A, sums, 1e4, jdir)))
    assert ulp_err(dense.log1p(got, device="cpu").numpy(), jdense.log1p(got)) <= 2
    # no zero guard, strict lengths, as the reference's dense impl
    z = sums.copy()
    z[0] = 0
    assert not np.isfinite(dense.normalize(A, z, 1.0, tdir, device="cpu").numpy()).all()
    with pytest.raises(ValueError, match="Length of sums"):
        dense.normalize(A, sums[:-1], 1.0, tdir, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        dense.normalize(A[0], sums, 1.0, tdir, device="cpu")
    t = torch.from_numpy(A)
    assert dense.normalize(t, sums, 1.0, tdir).device == t.device  # a tensor keeps its device


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_select_on_device_valued_matrix(fmt):
    X = counts(seed=4)
    tm, jm = both(X, fmt)
    tl = tm.normalize(tm.sum_row(), 1e4, Direction.ROW).log1p_normalize()
    jl = jm.normalize(tm.sum_row().numpy(), 1e4, JDirection.ROW).log1p_normalize()
    assert tl._h_data is None  # values on the device only
    rows = np.array([5, 0, 17, 17, 39])
    mask = np.zeros(X.shape[1], bool)
    mask[[2, 9, 11, 29]] = True
    for t_sel, j_sel in ((tl.select_rows(rows), jl.select_rows(rows)),
                         (tl.select_cols(mask), jl.select_cols(mask))):
        assert t_sel.format == fmt and t_sel.shape == j_sel.shape
        assert ulp_err(t_sel.to_dense(), j_sel.to_dense()) <= 2
    np.testing.assert_array_equal(tl.select_rows(rows).to_dense(), tl.to_dense()[rows])
    np.testing.assert_array_equal(tl.select_cols(mask).to_dense(), tl.to_dense()[:, mask])
    with pytest.raises(ValueError, match="Mask length"):
        tl.select_cols(mask[:-1])
    with pytest.raises(ValueError, match="indices must be in"):
        tl.select_rows([40])


def test_select_host_valued_matrix():
    X = counts(seed=5)
    tm, jm = both(X, "csr")
    np.testing.assert_array_equal(tm.select_rows([3, 1]).to_dense(),
                                  jm.select_rows([3, 1]).to_dense())
    np.testing.assert_array_equal(tm.select_cols([4, 0, 2]).to_dense(),
                                  jm.select_cols([4, 0, 2]).to_dense())


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("with_structure", [True, False])
def test_from_ell_arrays_of_a_jax_matrix(fmt, with_structure):
    """A JAX matrix after normalize (values on its device only) crosses into
    the port through its ELL arrays; its statistics and products agree."""

    X = counts(seed=6)
    jn = JMatrix.from_scipy(X, fmt=fmt).normalize(np.asarray(X.sum(axis=1)).ravel(), 1e4,
                                                  JDirection.ROW)
    assert jn._h_data is None
    kw = dict(h_indptr=jn._h_indptr, h_indices=jn._h_indices) if with_structure else {}
    tn = SparseMatrix.from_ell_arrays(np.asarray(jn.ell_data), np.asarray(jn.ell_ids),
                                      np.asarray(jn.row_nnz), jn.shape, jn.nnz, jn.format,
                                      device="cpu", **kw)
    np.testing.assert_array_equal(tn.to_dense(), jn.to_dense())
    np.testing.assert_allclose(tn.var_col().numpy(), np.asarray(jn.var_col()), rtol=1e-5)
    B = np.random.default_rng(0).random((X.shape[1], 3)).astype(np.float32)
    np.testing.assert_allclose(tn.matmul_dense(B).numpy(), np.asarray(jn.matmul_dense(B)),
                               rtol=1e-5, atol=1e-3)
    assert not tn.values_bf16_exact() and not tn.values_int8_exact()


def test_value_gates_and_pull_on_device_values():
    X = counts(seed=7)
    tm = SparseMatrix.from_scipy(X, device="cpu")
    assert tm.values_int8_exact() and tm.values_bf16_exact()
    scaled = tm.map_stored(lambda v, r, c: v * 2.5)  # halves: bf16-exact, not int8
    assert scaled._h_data is None
    assert scaled.values_bf16_exact() and not scaled.values_int8_exact()
    assert not tm.map_stored(lambda v, r, c: v * 1.01).values_bf16_exact()
    np.testing.assert_array_equal(scaled._csr_data_host(), X.data * 2.5)
    assert scaled._csr_data_host() is scaled._csr_data_host()  # pulled once
    assert scaled.pull_seconds >= 0


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_products_match_jax(fmt):
    X = counts(seed=8)
    tm, jm = both(X, fmt)
    rng = np.random.default_rng(1)
    B = rng.random((X.shape[1], 4)).astype(np.float32)
    C = rng.random((X.shape[0], 4)).astype(np.float32)
    np.testing.assert_allclose((tm @ B).numpy(), np.asarray(jm @ B), rtol=1e-6)
    np.testing.assert_allclose(tm.rmatmul_dense(C).numpy(), np.asarray(jm.rmatmul_dense(C)),
                               rtol=1e-6)


def test_constructors():
    X = counts(seed=9)
    assert csr_matrix(X, device="cpu").format == "csr"
    assert csc_matrix(X, device="cpu").format == "csc"
    d = SparseMatrix.from_dense(X.toarray(), fmt="csc", device="cpu")
    np.testing.assert_array_equal(d.to_dense(), X.toarray())
    coo = X.tocoo()
    c = SparseMatrix.from_coo(coo.row, coo.col, coo.data, X.shape, device="cpu")
    np.testing.assert_array_equal(c.to_dense(), X.toarray())
    from single_algebra_tpu import random_sparse as jrandom_sparse

    r = random_sparse(30, 20, 0.1, seed=3, device="cpu")
    np.testing.assert_array_equal(r.to_dense(), jrandom_sparse(30, 20, 0.1, seed=3).to_dense())
    assert SparseMatrix.from_scipy(X).device.type == "cuda"  # the default: the card


# -- preprocess.py ---------------------------------------------------------------

from single_algebra_tpu import preprocess as jpre  # noqa: E402
from single_algebra_tpu_torch import preprocess as tpre  # noqa: E402

REL = {np.float32: 1e-5, np.float64: 1e-6}


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if hasattr(x, "to_dense"):
        return np.asarray(x.to_dense())
    return np.asarray(x)


def assert_rel(got, want, rel):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def assert_of_max(got, want, tol=1e-5):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def batches(n, seed=0):
    return np.random.default_rng(seed).choice(["a", "b", "c"], n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kw", [dict(), dict(target_sum=1e4),
                                dict(exclude_highly_expressed=True, max_fraction=0.2)])
def test_normalize_total_matches_jax(dtype, kw):
    X = counts(n=60, p=40, seed=3, dtype=dtype)
    tm, jm = both(X, "csr", dtype)
    out, sf = tpre.normalize_total(tm, **kw)
    jout, jsf = jpre.normalize_total(jm, **kw)
    assert_rel(out, jout, REL[dtype])
    np.testing.assert_allclose(sf, np.asarray(jsf), rtol=1e-12)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("kw", [dict(), dict(log_idf=False),
                                dict(log_tf=False, log_idf=False, log_tfidf=True)])
def test_tfidf_matches_jax(fmt, kw):
    X = counts(seed=4)
    tm, jm = both(X, fmt)
    assert_rel(tpre.tfidf(tm, **kw), jpre.tfidf(jm, **kw), 1e-5)
    with pytest.raises(ValueError, match="log_tfidf"):
        tpre.tfidf(tm, log_tfidf=True)


def test_aggregate_matches_jax():
    X = counts(seed=5)
    tm, jm = both(X, "csr")
    labels = batches(X.shape[0])
    funcs = ("mean", "sum", "var", "frac_nonzero", "count_nonzero")
    got = tpre.aggregate(tm, labels, funcs=funcs)
    want = jpre.aggregate(jm, labels, funcs=funcs)
    np.testing.assert_array_equal(got["groups"], want["groups"])
    for f in funcs:
        assert_rel(got[f], want[f], 1e-6)
    with pytest.raises(ValueError, match="Unknown aggregate"):
        tpre.aggregate(tm, labels, funcs=("median",))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("zero_center", [True, False])
@pytest.mark.parametrize("max_value", [None, 2.5])
def test_scale_sparse_matches_jax(dtype, fmt, zero_center, max_value):
    X = counts(seed=6, dtype=dtype)
    tm, jm = both(X, fmt, dtype)
    got = tpre.scale(tm, zero_center=zero_center, max_value=max_value)
    want = jpre.scale(jm, zero_center=zero_center, max_value=max_value)
    assert isinstance(got, SparseMatrix) == (not zero_center)
    assert_rel(got, want, REL[dtype])


@pytest.mark.parametrize("zero_center", [True, False])
def test_scale_dense_matches_jax(zero_center):
    x = np.random.default_rng(7).standard_normal((50, 12)).astype(np.float32)
    x[:, 4] = 1.0  # zero variance: left unscaled
    got = tpre.scale(x, zero_center=zero_center, max_value=1.5, device="cpu")
    assert_rel(got, jpre.scale(x, zero_center=zero_center, max_value=1.5), 1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sparse_in", [True, False])
def test_regress_out_matches_jax(dtype, sparse_in):
    X = counts(seed=8, dtype=dtype)
    rng = np.random.default_rng(9)
    cov = np.stack([np.asarray(X.sum(axis=1)).ravel(), rng.random(X.shape[0])], 1)
    if sparse_in:
        tX, jX = both(X, "csr", dtype)
    else:
        tX = jX = X.toarray()
    got = tpre.regress_out(tX, cov, device="cpu")
    want = jpre.regress_out(jX, cov)
    assert_of_max(got, want)
    assert_of_max(tpre.regress_out(tX, cov[:, 0], add_intercept=False, device="cpu"),
                  jpre.regress_out(jX, cov[:, 0], add_intercept=False))
    with pytest.raises(ValueError, match="covariates rows"):
        tpre.regress_out(tX, cov[1:], device="cpu")


@pytest.mark.parametrize("sparse_in", [True, False])
@pytest.mark.parametrize("eb", [True, False])
def test_combat_matches_jax(sparse_in, eb):
    X = counts(n=90, seed=10)
    b = batches(X.shape[0], seed=11)
    X = sp.csr_matrix(X.toarray() + np.where(b == "b", 3.0, 0.0)[:, None]
                      * (X.toarray() > 0)).astype(np.float32)
    if sparse_in:
        tX, jX = both(X, "csr")
    else:
        tX = jX = X.toarray()
    assert_of_max(tpre.combat(tX, b, eb=eb, device="cpu"), jpre.combat(jX, b, eb=eb))


def test_combat_single_batch_and_singletons():
    X = counts(seed=12)
    tm, _ = both(X, "csr")
    np.testing.assert_array_equal(np_of(tpre.combat(tm, ["a"] * X.shape[0])), X.toarray())
    b = np.array(["a"] * (X.shape[0] - 1) + ["z"])
    with pytest.raises(ValueError, match="singletons"):
        tpre.combat(tm, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kw", [dict(), dict(theta=10.0, clip=3.0), dict(theta=np.inf)])
def test_pearson_residuals_matches_jax(dtype, kw):
    X = counts(seed=13, dtype=dtype)
    tm, jm = both(X, "csc", dtype)
    assert_of_max(tpre.normalize_pearson_residuals(tm, **kw),
                  jpre.normalize_pearson_residuals(jm, **kw))
    with pytest.raises(ValueError, match="theta"):
        tpre.normalize_pearson_residuals(tm, theta=0.0)


def test_subsample_same_draws():
    X = counts(seed=14)
    tm, jm = both(X, "csr")
    for kw in (dict(fraction=0.3, seed=5), dict(n_obs=17, seed=2)):
        sub, idx = tpre.subsample(tm, **kw)
        jsub, jidx = jpre.subsample(jm, **kw)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(sub.to_dense(), np.asarray(jsub.to_dense()))
    with pytest.raises(ValueError, match="exactly one"):
        tpre.subsample(tm)


def test_downsample_counts_same_draws():
    X = counts(seed=15)
    tm, jm = both(X, "csr")
    got = tpre.downsample_counts(tm, 300, seed=3)
    want = jpre.downsample_counts(jm, 300, seed=3)
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.to_dense(), np.asarray(want.to_dense()))
    assert (got.to_dense().sum(axis=1) <= 300).all()
    with pytest.raises(ValueError, match="integer count"):
        tpre.downsample_counts(SparseMatrix.from_scipy(X * 0.5, device="cpu"), 10)
