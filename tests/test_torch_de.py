"""``de.py`` of the torch port against the JAX package.

The same seeded log-normalized counts go through both packages (the port
on the CPU). t statistics (from float32 grouped sums in the JAX package,
float64 sums in the port) agree within 1e-5 of the largest |t|; the
Wilcoxon rank sums are exact in both at these sizes, so z, the p-values
and Benjamini-Hochberg agree within 1e-10 relative; logreg from the JAX
start ``W0`` within 1e-5 of the largest |coefficient|. Names, rankings
and ``pts`` are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu import de as jde
from single_algebra_tpu_torch import SparseMatrix, de, rank_genes_groups


def lognorm_counts(n=240, p=60, k=4, seed=0, negatives=False):
    """Log-normalized counts of k groups with planted markers; stored
    zeros and (optionally) negative values exercise the zero tie group."""

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    lam = rng.gamma(1.0, 0.5, (k, p))
    for g in range(k):
        lam[g, g * 3:(g + 1) * 3] += 4.0  # markers
    X = rng.poisson(lam[labels]).astype(np.float64)
    X = np.log1p(X / np.maximum(X.sum(1, keepdims=True), 1) * 1e4)
    X[rng.random(X.shape) < 0.3] = 0.0
    m = sp.csr_matrix(X.astype(np.float32))
    # stored zeros: keep a few explicit 0.0 slots
    m.data[::17] = 0.0
    if negatives:
        m.data[5::23] *= -1.0
    return m, np.asarray([f"g{c}" for c in labels])


def pair(X):
    return SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def assert_tables(got, want, score_tol, p_tol):
    assert list(got.names) == list(want.names)
    for g in want.names:
        np.testing.assert_array_equal(got.names[g], want.names[g])
        assert rel(got.scores[g], want.scores[g]) <= score_tol
        if not np.isnan(want.pvals[g]).all():
            np.testing.assert_allclose(got.pvals[g], want.pvals[g], rtol=p_tol, atol=0)
            np.testing.assert_allclose(got.pvals_adj[g], want.pvals_adj[g], rtol=p_tol, atol=0)
        np.testing.assert_allclose(got.logfoldchanges[g], want.logfoldchanges[g],
                                   rtol=1e-5, atol=1e-5)
        if want.pts is not None:
            np.testing.assert_array_equal(got.pts[g], want.pts[g])
            np.testing.assert_array_equal(got.pts_rest[g], want.pts_rest[g])


@pytest.mark.parametrize("negatives", [False, True])
def test_rank_block_matches_jax(negatives):
    X, labels = lognorm_counts(negatives=negatives)
    tmx, jmx = pair(X)
    codes = np.unique(labels, return_inverse=True)[1]
    mc, jc = tmx._layout_for("col"), jmx._layout_for("col")
    rng = np.random.default_rng(1)
    member = rng.random(len(labels)) < 0.8
    col_map = np.where(member, codes, 4).astype(np.int64)
    n1 = np.asarray([((codes == c) & member).sum() for c in range(4)], np.float64)
    got = de._rank_block_sparse(mc.ell_data[:40], mc.ell_ids[:40], mc.row_nnz[:40],
                                torch.from_numpy(member), torch.from_numpy(col_map),
                                torch.from_numpy(n1), int(member.sum()), 4)
    want = jde._rank_block_sparse(jc.ell_data[:40], jc.ell_ids[:40], jc.row_nnz[:40],
                                  jnp.asarray(member), jnp.asarray(col_map.astype(np.int32)),
                                  jnp.asarray(n1, jnp.float32),
                                  jnp.asarray(float(member.sum()), jnp.float32), 4)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float64))
    f32 = de._rank_block_sparse(mc.ell_data[:40], mc.ell_ids[:40], mc.row_nnz[:40],
                                torch.from_numpy(member), torch.from_numpy(col_map),
                                torch.from_numpy(n1), int(member.sum()), 4, acc=torch.float32)
    np.testing.assert_array_equal(f32[0].numpy(), np.asarray(want[0]))


def test_full_moments_match_jax():
    X, labels = lognorm_counts(seed=2)
    tmx, jmx = pair(X)
    codes = np.unique(labels, return_inverse=True)[1]
    got = de._full_moments(tmx, codes, 4)
    want = jde._full_moments(jmx, codes.astype(np.int32), 4)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert rel(a, b) <= 1e-6


@pytest.mark.parametrize("method", ["t-test", "t-test_overestim_var"])
@pytest.mark.parametrize("reference", ["rest", "g1"])
def test_ttests_match_jax(method, reference):
    X, labels = lognorm_counts(seed=3)
    tmx, jmx = pair(X)
    got = rank_genes_groups(tmx, labels, method=method, reference=reference, pts=True)
    want = jde.rank_genes_groups(jmx, labels, method=method, reference=reference, pts=True)
    assert_tables(got, want, 1e-5, 1e-4)


@pytest.mark.parametrize("tie_correct", [True, False])
@pytest.mark.parametrize("reference", ["rest", "g2"])
@pytest.mark.parametrize("negatives", [False, True])
def test_wilcoxon_matches_jax(tie_correct, reference, negatives):
    X, labels = lognorm_counts(seed=4, negatives=negatives)
    tmx, jmx = pair(X)
    kw = dict(method="wilcoxon", reference=reference, tie_correct=tie_correct, block=16)
    got = rank_genes_groups(tmx, labels, **kw)
    want = jde.rank_genes_groups(jmx, labels, **kw)
    assert_tables(got, want, 1e-10, 1e-10)


def test_wilcoxon_matches_scipy_and_finds_markers():
    from scipy.stats import mannwhitneyu

    X, labels = lognorm_counts(seed=5)
    res = rank_genes_groups(SparseMatrix.from_scipy(X, device="cpu"), labels,
                            method="wilcoxon", n_genes=3)
    D = X.toarray()
    for g in ("g0", "g3"):
        c = int(g[1])
        assert set(res.names[g]) == {c * 3, c * 3 + 1, c * 3 + 2}
        j = res.names[g][0]
        stat = mannwhitneyu(D[labels == g, j], D[labels != g, j], use_continuity=False,
                            method="asymptotic")
        assert res.pvals[g][0] == pytest.approx(stat.pvalue, rel=1e-8)


@pytest.mark.parametrize("reference", ["rest", "g0"])
def test_logreg_from_the_jax_start_matches_jax(reference, monkeypatch):
    X, labels = lognorm_counts(n=160, p=40, seed=6)
    tmx, jmx = pair(X)
    seen = []

    def w0(p, g, seed, device):
        seen.append((p, g))
        key = jax.random.PRNGKey(seed)
        return torch.from_numpy(np.array(
            0.01 * jax.random.normal(key, (p, g), jnp.float32))).to(device)

    monkeypatch.setattr(de, "_logreg_w0", w0)
    got = rank_genes_groups(tmx, labels, method="logreg", reference=reference)
    want = jde.rank_genes_groups(jmx, labels, method="logreg", reference=reference)
    assert seen == [(40, 4)]  # p genes x the fitted groups (3 + the reference)
    for g in want.names:
        assert rel(got.scores[g], want.scores[g]) <= 1e-5
        assert np.isnan(got.pvals[g]).all()


def test_logreg_private_start_and_generator():
    X, labels = lognorm_counts(n=100, p=30, seed=7)
    tmx = SparseMatrix.from_scipy(X, device="cpu")
    codes = np.unique(labels, return_inverse=True)[1]
    W0 = 0.01 * np.random.default_rng(0).standard_normal((30, 4)).astype(np.float32)
    got = de._logreg_scores(tmx, codes, 4, lam=1e-4, iters=50, lr=1.0, seed=0, _W0=W0)
    assert got.shape == (30, 4) and np.isfinite(got).all()
    a = de._logreg_w0(30, 4, 3, "cpu")
    np.testing.assert_array_equal(a.numpy(), de._logreg_w0(30, 4, 3, "cpu").numpy())


def test_groups_subset_var_names_n_genes_and_filter():
    X, labels = lognorm_counts(seed=8)
    tmx, jmx = pair(X)
    names = np.asarray([f"gene{i}" for i in range(60)])
    kw = dict(method="t-test", groups=["g3", "g1"], var_names=names, n_genes=7, pts=True)
    got = rank_genes_groups(tmx, labels, **kw)
    want = jde.rank_genes_groups(jmx, labels, **kw)
    assert list(got.names) == ["g3", "g1"]
    assert_tables(got, want, 1e-5, 1e-4)
    f, jf = got.filter(min_fold_change=1.5), want.filter(min_fold_change=1.5)
    for g in jf.names:
        np.testing.assert_array_equal(f.names[g], jf.names[g])
    assert set(got.group("g3")) == set(want.group("g3"))
    markers = {"typeA": ["gene9", "gene10", "gene11"], "typeB": ["gene3"]}
    for method in ("overlap_count", "overlap_coef", "jaccard"):
        assert de.marker_gene_overlap(got, markers, top_n=5, method=method) == \
            jde.marker_gene_overlap(want, markers, top_n=5, method=method)


def test_bh_and_fold_change_helpers_match_jax():
    p = np.random.default_rng(9).random(50)
    np.testing.assert_allclose(de._bh_adjust(p), jde._bh_adjust(p), rtol=1e-15)
    a, b = np.linspace(0, 3, 7), np.linspace(1, 2, 7)
    for e in (True, False):
        np.testing.assert_allclose(de._log2_fold_change(a, b, e), jde._log2_fold_change(a, b, e),
                                   rtol=1e-15)


def test_errors():
    X, labels = lognorm_counts(n=40, p=10, seed=10)
    m = SparseMatrix.from_scipy(X, device="cpu")
    with pytest.raises(ValueError, match="Unknown method"):
        rank_genes_groups(m, labels, method="bogus")
    with pytest.raises(ValueError, match="not a label"):
        rank_genes_groups(m, labels, reference="nope")
    with pytest.raises(ValueError, match="not label values"):
        rank_genes_groups(m, labels, groups=["nope"])
    with pytest.raises(ValueError, match="var_names"):
        rank_genes_groups(m, labels, var_names=["a"])
    with pytest.raises(ValueError, match="needs pts"):
        rank_genes_groups(m, labels).filter()
