"""The JAX package's own single-cell workflow (``examples/scrna_pipeline.py``)
through both packages, at 2,000 cells x 500 genes, every intermediate
held to the port's module tolerances:

counts -> ``calculate_qc_metrics`` (counts exact, sums 1e-6 of the
largest) -> ``normalize(total_counts, 1e4)`` -> ``log1p_normalize`` (2
ULP) -> ``highly_variable_genes`` (seurat, 150 genes: the scores within
1e-5, the mask identical, its ranking margin checked) -> masked PCA on
the Gram engine (explained variances 1e-5 of the largest, scores 1e-4 of
max |score| up to each component's sign) -> ``neighbors.connectivities``
(the identical pattern; values 1e-3, see ``tests/test_torch_neighbors.py``)
-> ``leiden`` (labels identical to the JAX native run on either graph)
-> KMeans Lloyd from the JAX init (labels identical, centers 1e-5) ->
UMAP with the JAX draws injected (one epoch 1e-5 of max |update|; 10
float64 epochs 1e-4 of max |Y|: the jitted JAX float64 epoch differs
from its op-by-op evaluation by up to 5e-7 at some epochs, and the
layout amplifies that about tenfold an epoch, so on this graph 20 epochs
land anywhere between 7e-5 and 4e-4 with the start's rounding; the
20-epoch case is ``tests/test_torch_umap.py``'s) ->
``rank_genes_groups(method="wilcoxon")`` on the Leiden labels, the
example's last call (per gene, z and -log10 of the adjusted p-values
within 1e-6 relative; the rankings equal wherever adjacent scores are
further apart than that: the rank sums are exact in both packages at this size,
but the JAX package's float32 tie term, ~z t0^3 ~ 4e9 for the zero tie
group, rounds at 6e-8 relative, where the port's float64 one is exact).

Each package runs on its own previous output; where the step is
sensitive to its input's rounding (Leiden, UMAP), the port also runs on
the JAX package's intermediate.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
import single_algebra_tpu as jsat
import single_algebra_tpu.models as jmodels
from single_algebra_tpu import neighbors as jnb
from single_algebra_tpu.models import kmeans as jkm
from single_algebra_tpu.models import umap as ju
import single_algebra_tpu_torch as tsat
from single_algebra_tpu_torch import neighbors as tnb
from single_algebra_tpu_torch.models import kmeans as tkm
from single_algebra_tpu_torch.models import umap as tu

N, P, HVG, K, TYPES = 2000, 500, 150, 20, 8


def synthetic_counts(n_cells, n_genes, n_types=TYPES, seed=0):
    """``examples/scrna_pipeline.py::synthetic_counts``."""

    rng = np.random.default_rng(seed)
    programs = rng.gamma(2.0, 1.0, (n_types, n_genes)) * (rng.random((n_types, n_genes)) < 0.4)
    rates = programs * np.geomspace(6, 1, n_types)[:, None] * 0.08
    labels = rng.integers(0, n_types, n_cells)
    return sp.csr_matrix(rng.poisson(rates[labels]).astype(np.float32)), labels


def rel_of_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def run():
    X, labels = synthetic_counts(N, P)
    out = {"labels": labels}
    tm = tsat.SparseMatrix.from_scipy(X, device="cpu")
    jm = jsat.SparseMatrix.from_scipy(X)
    mito = np.zeros(P, bool)
    mito[:: P // 13] = True
    out["qc"] = (tsat.calculate_qc_metrics(tm, qc_vars={"mito": mito}),
                 jsat.calculate_qc_metrics(jm, qc_vars={"mito": mito}))
    umis = out["qc"][1][0]["total_counts"]
    tn = tm.normalize(umis, 1e4, tsat.Direction.ROW).log1p_normalize()
    jn = jm.normalize(umis, 1e4, jsat.Direction.ROW).log1p_normalize()
    out["norm"] = (tn.to_dense(), np.asarray(jn.to_dense()))
    out["hvg"] = (tsat.highly_variable_genes(tn, n_top_genes=HVG),
                  jsat.highly_variable_genes(jn, n_top_genes=HVG))
    mask = out["hvg"][1].mask
    tp = tsat.MaskedSparsePCABuilder().mask(mask).n_components(K).engine("gram").build()
    jp = jmodels.MaskedSparsePCABuilder().mask(mask).n_components(K).engine("gram").build()
    out["pca"] = (tp, jp)
    E, jE = tp.fit_transform(tn).numpy(), np.asarray(jp.fit_transform(jn))
    out["E"] = (E, jE)
    out["conn"] = (tnb.connectivities(E, 15, device="cpu"), jnb.connectivities(jE, 15))
    return out


def test_qc(run):
    (obs, var), (jobs, jvar) = run["qc"]
    for got, want in ((obs, jobs), (var, jvar)):
        assert set(got) == set(want)
        for key, w in want.items():
            if key.startswith("n_"):
                np.testing.assert_array_equal(got[key], w)
            else:
                assert np.abs(got[key] - w).max() <= 1e-6 * np.abs(w).max(), key


def test_log_normalized_values(run):
    got, want = run["norm"]
    np.testing.assert_array_equal(got != 0, want != 0)
    nz = want != 0
    ulp = np.abs(got[nz] - want[nz]) / np.spacing(np.abs(want[nz]).astype(np.float32))
    assert ulp.max() <= 2


def test_hvg(run):
    got, want = run["hvg"]
    s = np.sort(np.nan_to_num(want.dispersions_norm, nan=-np.inf))[::-1]
    assert s[HVG - 1] - s[HVG] > 1e-4  # the ranking's margin
    np.testing.assert_array_equal(got.mask, want.mask)
    for f in ("means", "dispersions", "dispersions_norm"):
        g, w = np.asarray(getattr(got, f), np.float64), np.asarray(getattr(want, f), np.float64)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        assert np.abs(g[fin] - w[fin]).max() <= 1e-5 * np.abs(w[fin]).max(), f


def test_masked_pca(run):
    tp, jp = run["pca"]
    ev, jev = np.asarray(tp.explained_variance_), np.asarray(jp.explained_variance_)
    assert np.abs(ev - jev).max() <= 1e-5 * jev.max()
    E, jE = run["E"]
    signs = np.sign((E * jE).sum(axis=0))
    assert rel_of_max(E * signs, jE) <= 1e-4


def test_connectivities_and_leiden(run):
    S, jS = run["conn"]
    S.sort_indices(), jS.sort_indices()
    np.testing.assert_array_equal(S.indptr, jS.indptr)
    np.testing.assert_array_equal(S.indices, jS.indices)
    assert np.abs(S.data - jS.data).max() <= 1e-3
    want = jsat.leiden(jS, resolution=0.5, seed=0)
    for graph in (jS, S):
        got = tsat.leiden(graph, resolution=0.5, seed=0)
        assert got.backend == "native"
        np.testing.assert_array_equal(got.labels, want.labels)
    assert abs(tsat.leiden(jS, resolution=0.5, seed=0).quality - want.quality) <= 1e-12
    assert want.n_communities == TYPES


def test_kmeans(run):
    E, jE = run["E"]
    signs = np.sign((E * jE).sum(axis=0)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jX = jnp.asarray(jE)
    x2, w = jkm._row_sq_norms(jX), jnp.ones(N, jnp.float32)
    tol2 = jkm.KMeans(TYPES)._tol2(jX)
    C0 = np.array(jkm._plusplus_init(key, jX, x2, w, TYPES))
    jC, jlab, jin, _ = jkm._fit_one(jX, x2, tol2, key, w, k=TYPES, max_iter=300)
    X = torch.from_numpy(E * signs)  # the port's scores, in the JAX signs
    C, lab, inertia, _ = tkm._lloyd(X, tkm._row_sq_norms(X), float(tol2), torch.from_numpy(C0),
                                    torch.ones(N), k=TYPES, max_iter=300)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert rel_of_max(C.numpy(), jC) <= 1e-5
    assert inertia == pytest.approx(float(jin), rel=1e-5)


def test_umap_with_the_jax_draws(run):
    S, jS = run["conn"]
    ed = tu._edges_of(S, N, "cpu")
    coo = jS.tocoo()
    keep = coo.data > 1e-8
    h, t = coo.row[keep].astype(np.int32), coo.col[keep].astype(np.int32)
    np.testing.assert_array_equal(ed.heads.numpy(), h)  # the same edges
    tperm = np.argsort(t, kind="stable").astype(np.int32)
    wts = coo.data[keep]
    wts = jnp.asarray((wts / wts.max()).astype(np.float32))
    jarr = (jnp.asarray(h), jnp.asarray(t), wts, jnp.asarray(tperm), jnp.asarray(t[tperm]))
    a, b = ju._fit_ab(1.0, 0.1)
    _, jE = run["E"]
    X = jnp.asarray(jE)
    Xc = X - X.mean(axis=0, keepdims=True)
    _, _, vt = jnp.linalg.svd(Xc[:4096], full_matrices=False)
    Y0 = Xc @ vt[:2].T
    Y0 = Y0 / (jnp.std(Y0) + 1e-9) * 10.0
    Y0 = np.array(Y0 + 0.1 * jax.random.normal(jax.random.PRNGKey(42), Y0.shape), np.float32)
    m = len(h)

    def draws(key):
        key, k1, k2 = jax.random.split(key, 3)
        active = torch.from_numpy(np.array(jax.random.uniform(k1, (m,)) < wts))
        negs = torch.from_numpy(np.array(jax.random.randint(k2, (m, 5), 0, N), np.int64))
        return key, active, negs

    key = jax.random.PRNGKey(43)
    Y1 = np.asarray(ju._layout_chunk(jnp.array(Y0), *jarr, key, jnp.int32(0), jnp.int32(1),
                                     n=N, n_epochs=200, neg_rate=5, a=a, b=b, lr=1.0)[0])
    _, active, negs = draws(key)
    got = tu._layout_epoch(torch.from_numpy(Y0), ed, active, negs, tu._alpha(1.0, 0, 200), a, b)
    assert rel_of_max(got.numpy() - Y0, Y1 - Y0) <= 1e-5

    Y64 = Y0.astype(np.float64)
    want = np.asarray(ju._optimize_layout(jnp.array(Y64), *jarr, key, n=N, n_epochs=10,
                                          neg_rate=5, a=a, b=b, lr=1.0))
    Y = torch.from_numpy(Y64)
    for e in range(10):
        key, active, negs = draws(key)
        Y = tu._layout_epoch(Y, ed, active, negs, tu._alpha(1.0, e, 10), a, b)
    assert rel_of_max(Y.numpy(), want) <= 1e-4


def test_rank_genes_groups_on_the_leiden_labels(run):
    """The example's last step: wilcoxon markers of each Leiden community
    on the log-normalized matrix, both packages from the JAX labels."""

    _, jS = run["conn"]
    labels = jsat.leiden(jS, resolution=0.5, seed=0).labels
    X, _ = synthetic_counts(N, P)
    umis = run["qc"][1][0]["total_counts"]
    tn = tsat.SparseMatrix.from_scipy(X, device="cpu").normalize(
        umis, 1e4, tsat.Direction.ROW).log1p_normalize()
    jn = jsat.SparseMatrix.from_scipy(X).normalize(umis, 1e4, jsat.Direction.ROW).log1p_normalize()
    got = tsat.rank_genes_groups(tn, labels, method="wilcoxon")
    want = jsat.rank_genes_groups(jn, labels, method="wilcoxon")
    assert list(got.names) == list(want.names) and len(got.names) == TYPES
    for g in want.names:
        by_gene = np.argsort(got.names[g]), np.argsort(want.names[g])
        for f in ("scores", "pvals_adj"):
            a, b = (getattr(r, f)[g][o] for r, o in zip((got, want), by_gene))
            if f == "pvals_adj":
                a, b = -np.log10(a), -np.log10(b)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
        z = want.scores[g]
        gap = np.diff(z, prepend=np.inf, append=-np.inf)
        apart = (np.abs(gap[:-1]) > 1e-6 * np.abs(z)) & (np.abs(gap[1:]) > 1e-6 * np.abs(z))
        np.testing.assert_array_equal(got.names[g][apart], want.names[g][apart])
        assert apart[:10].sum() >= 8
