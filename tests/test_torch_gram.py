"""Gram engine of the torch port against the JAX package (Pallas in
interpret mode). Tolerances: bucket plans and payloads byte-identical;
the int8 Gram equal; the bf16 and f32 Grams to 1e-6 x max|G| (the
products sum in another order); the p-space solve's singular values to
1e-5 relative, with JAX's own sketch injected into the randomized branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import single_algebra_tpu.linalg.gram as jgram
from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.linalg import gram as tgram
from single_algebra_tpu_torch.linalg.gram import GramPCAEngine, gram_matrix
from single_algebra_tpu_torch.ops import densify

from tests.conftest import cluster_counts


def both(X):
    """(port engine, JAX engine) of one scipy matrix."""

    return (GramPCAEngine.from_matrix(SparseMatrix.from_scipy(X, device="cpu")),
            jgram.GramPCAEngine.from_matrix(JMatrix.from_scipy(X)))


def tier_values(X, tier):
    """X with values of one Gram tier: int8 counts, bf16-exact counts above
    127, or general floats."""

    X = X.copy()
    d = X.data
    X.data = {
        "int8": 1 + np.round(d * 7) % 100,
        "bf16": 128 + np.round(d * 7) % 100,
        "f32": d * 1.37,
    }[tier].astype(np.float32)
    return X


@pytest.fixture(scope="module")
def counts():
    return cluster_counts(600, 140, n_clusters=8, seed=3).astype(np.float32)


@pytest.fixture(scope="module")
def wide():
    # pp > 4096: the blocked symmetric-half path (as tests/test_gram.py)
    rng = np.random.default_rng(11)
    return sp.random(1500, 4500, density=0.01, format="csr", dtype=np.float64,
                     random_state=rng)


def jax_omega(seed, p, l):
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return torch.from_numpy(np.array(jax.random.normal(key, (p, l), dtype=jnp.float32)))


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_bucket_plan_and_payload_identical(counts, fmt):
    X = counts.tocsc() if fmt == "csc" else counts
    m, jm = SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)
    for ct in GramPCAEngine.COL_TILES:
        plan, total, slab, nt = GramPCAEngine._bucket_plan(m, ct)
        jplan, jtotal, jslab, jnt = jgram.GramPCAEngine._bucket_plan(jm, ct)
        assert (total, slab, nt) == (jtotal, jslab, jnt)
        assert [c for c, _ in plan] == [c for c, _ in jplan]
        for (_, rows), (_, jrows) in zip(plan, jplan):
            np.testing.assert_array_equal(rows, jrows)
    eng = GramPCAEngine.from_matrix(m)
    jeng = jgram.GramPCAEngine.from_matrix(jm)
    assert eng.meta == tuple(jeng.meta) and eng.bwidths == tuple(jeng.bwidths)
    for a, b in zip(eng.bdata + eng.blocal, jeng.bdata + jeng.blocal):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(eng.pos.numpy(), np.asarray(jeng.pos))
    np.testing.assert_array_equal(eng.gidx.numpy(), np.asarray(jeng.gidx))


def test_from_arrays_takes_the_jax_payload(counts):
    jeng = jgram.GramPCAEngine.from_matrix(JMatrix.from_scipy(counts))
    eng = GramPCAEngine.from_arrays(
        [np.asarray(a) for a in jeng.bdata], [np.asarray(a) for a in jeng.blocal],
        np.asarray(jeng.pos), np.asarray(jeng.gidx), jeng.shape, jeng.meta,
        jeng.bwidths, device="cpu",
    )
    assert eng.device == torch.device("cpu") and eng.shape == counts.shape
    G = gram_matrix(eng).numpy()
    np.testing.assert_array_equal(G, np.asarray(jgram.gram_matrix(jeng)))


@pytest.mark.parametrize("tier", ["int8", "bf16", "f32"])
def test_gram_tiers_match_jax(counts, tier):
    X = tier_values(counts, tier)
    eng, jeng = both(X)
    assert (eng.meta[3], eng.meta[4]) == {
        "int8": (True, True), "bf16": (True, False), "f32": (False, False)}[tier]
    G, Gj = gram_matrix(eng).numpy(), np.asarray(jgram.gram_matrix(jeng))
    if tier == "int8":
        np.testing.assert_array_equal(G, Gj)
    else:
        assert np.abs(G - Gj).max() <= 1e-6 * np.abs(Gj).max()
    p = X.shape[1]
    ref = (X.astype(np.float64).T @ X.astype(np.float64)).toarray()
    assert np.abs(G[:p, :p] - ref).max() <= 1e-6 * np.abs(ref).max()
    assert not G[p:].any() and not G[:, p:].any()


@pytest.mark.parametrize("tier", ["int8", "bf16", "f32"])
def test_gram_blocked_path_matches_jax(wide, tier):
    X = tier_values(wide, tier)
    eng, jeng = both(X)
    assert eng.p_padded > 4096  # the blocked path is engaged
    G = gram_matrix(eng).numpy()
    Gj = np.asarray(jgram.gram_matrix(jeng))
    ref = (X.astype(np.float64).T @ X.astype(np.float64)).toarray()
    p = X.shape[1]
    if tier == "int8":
        np.testing.assert_array_equal(G, Gj)
        # the JAX int8 blocked path had no test: hold it to f64 as well
        np.testing.assert_array_equal(Gj[:p, :p], ref)
    else:
        scale = np.abs(Gj).max()
        assert np.abs(G - Gj).max() <= 1e-6 * scale
        assert np.abs(G[:p, :p] - ref).max() <= 1e-6 * scale
    np.testing.assert_array_equal(G, G.T)
    Gfull = gram_matrix(eng, sym=False).numpy()
    assert np.abs(G - Gfull).max() <= 1e-6 * np.abs(Gfull).max()


@pytest.mark.parametrize("tier", ["int8", "f32"])
def test_gram_padded_block(tier):
    # pp = 1280 with rb = 512: the slab pads to ppb = 1536
    X = tier_values(sp.random(700, 1200, density=0.02, format="csr",
                              random_state=np.random.default_rng(2)), tier)
    eng, jeng = both(X)
    assert eng.p_padded == 1280
    G = gram_matrix(eng, rb=512).numpy()
    Gj = np.asarray(jgram.gram_matrix(jeng, rb=512))
    assert G.shape == Gj.shape == (1280, 1280)
    if tier == "int8":
        np.testing.assert_array_equal(G, Gj)
    else:
        assert np.abs(G - Gj).max() <= 1e-6 * np.abs(Gj).max()


def test_products_match_jax(counts):
    eng, jeng = both(counts)
    rng = np.random.default_rng(0)
    B = rng.standard_normal((counts.shape[1], 5)).astype(np.float32)
    C = rng.standard_normal((counts.shape[0], 5)).astype(np.float32)
    for got, want, ref in (
        (eng.mv(torch.from_numpy(B)), jeng.mv(jnp.asarray(B)), counts @ B),
        (eng.rmv(torch.from_numpy(C)), jeng.rmv(jnp.asarray(C)), counts.T @ C),
    ):
        scale = np.abs(ref).max()
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * scale
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("center", [True, False])
def test_small_gram_solve_matches_jax(counts, center):
    eng, _ = both(counts)
    G = gram_matrix(eng)
    mu = np.zeros(G.shape[0], np.float32)
    mu[: counts.shape[1]] = np.asarray(counts.mean(axis=0)).ravel()
    n = counts.shape[0]
    s, vt = tgram.solve_gram_topk(G, torch.from_numpy(mu), n, 0, k=6, center=center)
    sj, vtj = jgram.solve_gram_topk(jnp.asarray(G.numpy()), jnp.asarray(mu), n, 0,
                                    k=6, center=center)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vtj), atol=1e-4)


@pytest.mark.parametrize("center", [False, True])
def test_large_gram_randomized_solve_same_sketch(center):
    # pp > EIGH_MAX_PP: the randomized solve; JAX's omega is injected
    rng = np.random.default_rng(1)
    pp, k, n = tgram.EIGH_MAX_PP + 512, 30, 50_000
    r = pp // 8
    Q, _ = np.linalg.qr(rng.standard_normal((pp, r)))
    w = np.concatenate([np.geomspace(30, 3, 40), np.abs(rng.standard_normal(r - 40))])
    mu = (0.1 * rng.random(pp)).astype(np.float32)
    # an uncentered Gram whose centered part is the planted spectrum
    G = ((Q * w) @ Q.T * n + n * np.outer(mu, mu) * center).astype(np.float32)
    s_j, vt_j = jax.jit(
        lambda G, mu: jgram._solve_topk(G, mu, n, 0, k=k, center=center)
    )(jnp.asarray(G), jnp.asarray(mu))
    l = k + max(10, min(k + 14, pp - k))  # the JAX sketch width
    s, vt = tgram._solve_topk(torch.from_numpy(G), torch.from_numpy(mu), n, 0,
                              k=k, center=center, omega=jax_omega(0, pp, l))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-5)
    ev_ref = np.sort(w)[::-1][:k] * n / (n - 1)
    ev = s.numpy().astype(np.float64) ** 2 / (n - 1)
    assert np.abs(ev - ev_ref).max() / ev_ref[0] < 5e-6
    # leading vectors (well separated) agree after the sign convention
    np.testing.assert_allclose(vt.numpy()[:10], np.asarray(vt_j)[:10], atol=1e-3)


def test_pca_graph_masked(counts):
    eng, jeng = both(counts)
    G = gram_matrix(eng)
    mean = torch.from_numpy(np.asarray(counts.mean(axis=0)).ravel().astype(np.float32))
    mask = np.sort(np.random.default_rng(1).choice(counts.shape[1], 50, replace=False))
    s, vt, T = tgram.gram_pca_graph(
        eng, G, mean, 0, k=4, center_svd=True, center_T=True,
        want_transform=True, mask_idx=torch.from_numpy(mask),
    )
    sj, vtj, Tj = jgram.gram_pca_graph(
        jeng, jnp.asarray(G.numpy()), jnp.asarray(mean.numpy()), 0, k=4,
        center_svd=True, center_T=True, want_transform=True,
        mask_idx=jnp.asarray(mask.astype(np.int32)),
    )
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vtj), atol=1e-4)
    Tj = np.asarray(Tj)
    assert np.abs(T.numpy() - Tj).max() <= 1e-4 * np.abs(Tj).max()


def test_gram_cached_and_cpu_route(counts):
    eng, _ = both(counts)
    densify.reset_launch_counts()
    assert eng.gram_cached() is eng.gram_cached()
    assert densify.launch_counts["tiled_ell_densify_t"] == 0  # CPU: plain version


def test_budget_rule():
    assert GramPCAEngine.hbm_budget_bytes("cpu") == 12 << 30  # JAX's fallback
    m = SparseMatrix.from_scipy(sp.random(50, 41000, density=0.01, format="csr"),
                                device="cpu")
    assert not GramPCAEngine.fits(m)  # p > 40960: G alone is too wide


def test_payload_bytes_brackets_fits(counts):
    """``payload_bytes`` is the chosen column tile's charged plan, as in the
    JAX package (its ``tests/test_engine_select.py`` check)."""

    m = SparseMatrix.from_scipy(counts, device="cpu")
    gram_b = GramPCAEngine.payload_bytes(m)
    assert gram_b == GramPCAEngine.choose_col_tile(m)[1]
    assert gram_b == jgram.GramPCAEngine.payload_bytes(JMatrix.from_scipy(counts))
    assert GramPCAEngine.fits(m, budget_bytes=gram_b)
    assert not GramPCAEngine.fits(m, budget_bytes=gram_b // 4)
