"""``feature_selection.py`` of the torch port against the JAX package.

Every flavor, with and without batches: ``means``, ``dispersions`` and
``dispersions_norm`` within 1e-5 (relative to each vector's largest
|value|), the masks identical. Both packages reduce float32 values on
their devices in different orders, so a gene within float32 rounding of
a cutoff could fall either way: each case first checks that its data
keeps every gene more than 1e-4 from the cutoff it is ranked or boxed
against (the n-th and n+1-th scores of a ranking, each bound of the
cutoff box), so that an identical mask is a real requirement.

Also the ``expm1`` / ``log`` decision: ``torch.expm1`` and ``torch.log``
in float32 against float64 over the log-normalized value range, within
the 3-ULP bound ``tests/test_precise_math.py`` holds the JAX package's
musl ports to.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu import feature_selection as jfs
from single_algebra_tpu_torch import SparseMatrix, feature_selection as tfs
from single_algebra_tpu_torch.sparse.matrix import _expm1_fn

MARGIN = 1e-4
ULP_BOUND = 3.0


def ulp_max(approx, ref64):
    a = np.asarray(approx, np.float64)
    ok = np.isfinite(ref64) & (np.abs(ref64) > 0)
    spacing = np.spacing(np.abs(ref64[ok]).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(a[ok] - ref64[ok]) / spacing))


def test_torch_expm1_within_3_ulp_over_the_log_normalized_range():
    rng = np.random.default_rng(0)
    # log1p of normalized counts spans [0, ~12]; the tiny end exercises
    # the small-argument branch
    xs = np.concatenate([np.linspace(0, 12, 200_000), rng.uniform(0, 12, 100_000),
                         np.logspace(-30, 1.1, 20_000)]).astype(np.float32)
    got = _expm1_fn(torch.from_numpy(xs), None, None).numpy()
    assert ulp_max(got, np.expm1(xs.astype(np.float64))) <= ULP_BOUND


def test_torch_log_within_3_ulp():
    rng = np.random.default_rng(1)
    xs = np.concatenate([np.logspace(-37.9, 38, 40_000),
                         rng.uniform(1e-6, 1e6, 20_000)]).astype(np.float32)
    got = torch.log(torch.from_numpy(xs)).numpy()
    assert ulp_max(got, np.log(xs.astype(np.float64))) <= ULP_BOUND


def raw_counts(n=400, p=300, seed=0):
    """Poisson counts around 6 cluster programs, gene means spread over
    three decades (every flavor's binning sees many bins)."""

    rng = np.random.default_rng(seed)
    base = rng.lognormal(-1.0, 1.5, p)
    prog = rng.gamma(0.6, 1.0, (6, p))
    lam = base[None, :] * prog[rng.integers(0, 6, n)]
    return sp.csr_matrix(rng.poisson(lam).astype(np.float32))


def log_normalized(X):
    """log1p(1e4 * x / rowsum) in float64, stored as float32."""

    rs = np.asarray(X.sum(axis=1), np.float64).ravel()
    Y = sp.diags(1e4 / np.where(rs > 0, rs, 1.0)) @ X.astype(np.float64)
    Y = Y.tocsr()
    Y.data = np.log1p(Y.data)
    return Y.astype(np.float32)


def both(X):
    return SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)


def batches(n, seed=2):
    return np.random.default_rng(seed).choice(["b0", "b1", "b2"], n)


def assert_margin_rank(score, n_top):
    s = np.sort(np.asarray(score, np.float64)[np.isfinite(score)])[::-1]
    assert s[n_top - 1] - s[n_top] > MARGIN, "ranking cutoff within the margin"


def assert_margin_box(values, bounds):
    for v, bs in zip(values, bounds):
        v = np.asarray(v, np.float64)
        for b in bs:
            if np.isfinite(b):
                gap = np.abs(v[np.isfinite(v)] - b).min()
                assert gap > MARGIN, f"a gene within {MARGIN} of {b}"


def assert_hvg(got, want):
    np.testing.assert_array_equal(got.mask, want.mask)
    for f in ("means", "dispersions", "dispersions_norm"):
        g, w = np.asarray(getattr(got, f), np.float64), np.asarray(getattr(want, f), np.float64)
        assert g.shape == w.shape, f
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=f)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5,
                                   atol=1e-5 * np.abs(w[fin]).max(), err_msg=f)
    if want.n_batches_selected is None:
        assert got.n_batches_selected is None
    else:
        np.testing.assert_array_equal(got.n_batches_selected, want.n_batches_selected)


@pytest.mark.parametrize("flavor", ["seurat", "cell_ranger"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n_top", [60, None])
def test_dispersion_flavors_match_jax(flavor, batched, n_top):
    X = raw_counts(seed=3)
    Xin = log_normalized(X) if flavor == "seurat" else X
    tm, jm = both(Xin)
    b = batches(X.shape[0]) if batched else None
    kw = dict(flavor=flavor, n_top_genes=n_top, batches=b)
    if n_top is None:
        # raw-count means are multiples of 1/n: bounds off that lattice; the
        # expm1'd means of log-normalized values reach past 3
        kw.update(dict(cell_ranger=dict(min_mean=0.0513, max_mean=2.9937, min_disp=0.2),
                       seurat=dict(max_mean=50.37))[flavor])
    want = jfs.highly_variable_genes(jm, **kw)
    got = tfs.highly_variable_genes(tm, **kw)
    if n_top is not None and not batched:
        assert_margin_rank(want.dispersions_norm, n_top)
    if n_top is None and not batched:
        lo = kw.get("min_mean", 0.0125)
        assert_margin_box([want.means, want.dispersions_norm],
                          [(lo, kw.get("max_mean", 3.0)), (kw.get("min_disp", 0.5),)])
    assert 0 < want.mask.sum() < len(want.mask)
    assert_hvg(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_seurat_v3_matches_jax(batched):
    X = raw_counts(seed=4)
    tm, jm = both(X)
    b = batches(X.shape[0], seed=5) if batched else None
    want = jfs.highly_variable_genes(jm, flavor="seurat_v3", n_top_genes=50, batches=b)
    got = tfs.highly_variable_genes(tm, flavor="seurat_v3", n_top_genes=50, batches=b)
    if not batched:
        assert_margin_rank(want.dispersions_norm, 50)
    assert_hvg(got, want)
    with pytest.raises(ValueError, match="RAW counts"):
        tfs.highly_variable_genes(tm, flavor="seurat_v3", n_top_genes=5, assume_logged=True)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(theta=10.0, clip=4.0)])
def test_pearson_residuals_flavor_matches_jax(batched, kw, monkeypatch):
    X = raw_counts(seed=6)
    tm, jm = both(X)
    b = batches(X.shape[0], seed=7) if batched else None
    # small tiles: several gene blocks and row blocks in both packages
    monkeypatch.setattr(tfs, "_PEARSON_TILE", 4096)
    want = jfs.highly_variable_genes(jm, flavor="pearson_residuals", n_top_genes=40,
                                     batches=b, **kw)
    got = tfs.highly_variable_genes(tm, flavor="pearson_residuals", n_top_genes=40,
                                    batches=b, **kw)
    if not batched:
        assert_margin_rank(want.dispersions_norm, 40)
    assert_hvg(got, want)


def test_pearson_variance_equals_dense_residual_variance():
    """The blocked variance against ``np.var`` of the dense residuals."""

    from single_algebra_tpu_torch import preprocess as tpre

    X = raw_counts(n=120, p=70, seed=8)
    tm, _ = both(X)
    dense = tpre.normalize_pearson_residuals(tm).numpy().astype(np.float64)
    got = tfs._pearson_residual_variance(tm, 100.0, None, gene_block=16)
    np.testing.assert_allclose(got, dense.var(axis=0), rtol=1e-5, atol=1e-6)


def test_from_moments_matches_jax():
    rng = np.random.default_rng(9)
    mean = rng.lognormal(-1, 1.2, 500)
    var = mean * rng.lognormal(0.5, 0.8, 500)
    for flavor in ("seurat", "cell_ranger"):
        for n_top in (100, None):
            got = tfs.highly_variable_genes_from_moments(mean, var, flavor=flavor,
                                                         n_top_genes=n_top)
            want = jfs.highly_variable_genes_from_moments(mean, var, flavor=flavor,
                                                          n_top_genes=n_top)
            assert_hvg(got, want)
    with pytest.raises(ValueError, match="Unknown flavor"):
        tfs.highly_variable_genes_from_moments(mean, var, flavor="nope")


def test_loess_is_the_jax_loess():
    rng = np.random.default_rng(10)
    x = rng.uniform(-2, 2, 700)
    y = np.sin(x) + 0.1 * rng.standard_normal(700)
    np.testing.assert_array_equal(tfs._loess_fit(x, y), jfs._loess_fit(x, y))
