"""``models/harmony.py`` of the torch port against the JAX package.

- ``_assign_block``, one ``_kmeans_sweep`` (the same numpy block
  permutation) and ``_correct`` from the same state, float64: 1e-10 of the
  largest |value|.
- A whole run from the JAX package's initial centroids (its ``KMeans`` on
  its normalized embedding; the port's k-means++ draws are not
  ``jax.random``'s) through the private ``_harmony_from``, float32: the
  same rounds, objectives within 1e-4 relative (float32 sums of n K
  entropy terms: both packages sit 1e-5 to 5e-5 from float64), the
  embedding within 5e-5 of max |Z| from the port's float64 run and within
  5e-5 of the JAX one beyond the JAX run's own distance to float64.
- The JAX tests' bars on the port's own runs: batch separation below 0.3x,
  the types kept (ARI > 0.95), the objective not rising, a small change
  without a batch effect, determinism, the single-batch identity and
  validation.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_algebra_tpu_torch.models import HarmonyResult, KMeans, harmony
from single_algebra_tpu_torch.metrics import adjusted_rand_index
from tests.test_harmony import _batch_separation, _batched_embedding

jh = importlib.import_module("single_algebra_tpu.models.harmony")
th = importlib.import_module("single_algebra_tpu_torch.models.harmony")


def state(n=240, d=8, K=6, B=3, seed=0):
    """A random harmony state: normalized Zc, one-hot phi, soft R, O, E."""

    rng = np.random.default_rng(seed)
    Z = rng.normal(0, 2, (n, d))
    Zc = Z / np.linalg.norm(Z, axis=1, keepdims=True)
    codes = rng.integers(0, B, n)
    phi = np.eye(B)[codes]
    R = rng.random((n, K))
    R /= R.sum(1, keepdims=True)
    Y = rng.normal(0, 1, (K, d))
    Y /= np.linalg.norm(Y, axis=1, keepdims=True)
    nb_frac = phi.sum(0) / n
    O = phi.T @ R
    E = np.outer(nb_frac, R.sum(0))
    return dict(Z=Z, Zc=Zc, phi=phi, R=R, Y=Y, nb_frac=nb_frac, O=O, E=E, codes=codes)


def T(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def J(a):
    return jnp.asarray(np.asarray(a, np.float64))


def close(got, want, rel=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("theta", [0.0, 2.0])
def test_assign_block_matches_jax(theta):
    s = state()
    want = jh._assign_block(J(s["Zc"][:50]), J(s["phi"][:50]), J(s["Y"]), J(s["O"]), J(s["E"]),
                            0.1, theta)
    got = th._assign_block(T(s["Zc"][:50]), T(s["phi"][:50]), T(s["Y"]), T(s["O"]), T(s["E"]),
                           0.1, theta)
    close(got, want)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-12)


def test_objective_matches_jax():
    s = state(seed=1)
    want = jh._objective(J(s["Zc"]), J(s["Y"]), J(s["R"]), J(s["O"]), J(s["E"]), 0.1, 2.0)
    got = th._objective(T(s["Zc"]), T(s["Y"]), T(s["R"]), T(s["O"]), T(s["E"]), 0.1, 2.0)
    close(float(got), float(want))


@pytest.mark.parametrize("n,blk", [(240, 12), (250, 13)])
def test_one_sweep_matches_jax(n, blk):
    s = state(n=n, seed=2)
    perm = np.random.default_rng(5).permutation(n)
    n_blocks = -(-n // blk)
    padded = np.full(n_blocks * blk, n, np.int32)
    padded[:n] = perm
    want = jh._kmeans_sweep(J(s["Zc"]), J(s["phi"]), J(s["R"]), J(s["O"]), J(s["E"]),
                            J(s["nb_frac"]), jnp.asarray(padded.reshape(n_blocks, blk)), 0.1, 2.0)
    got = th._kmeans_sweep(T(s["Zc"]), T(s["phi"]), T(s["R"]), T(s["O"]), T(s["E"]),
                           T(s["nb_frac"]), torch.split(torch.from_numpy(perm), blk), 0.1, 2.0)
    for g, w in zip(got, want):
        close(g, w)


def test_kmeans_rounds_stop_where_jax_stops():
    s = state(seed=3)
    n, blk, iters = 240, 12, 6
    rng = np.random.default_rng(0)
    perms = [rng.permutation(n) for _ in range(iters)]
    jperms = jnp.asarray(np.stack(perms).reshape(iters, n // blk, blk).astype(np.int32))
    args = ("Zc", "phi", "R", "O", "E", "nb_frac")
    for eps in (1e-1, 1e-3, 1e-12):
        want = jh._kmeans_rounds(*(J(s[a]) for a in args), jperms, 0.1, 2.0, eps)
        got = th._kmeans_rounds(*(T(s[a]) for a in args),
                                [torch.split(torch.from_numpy(p), blk) for p in perms],
                                0.1, 2.0, eps)
        for g, w in zip(got, want):
            close(g, w, 1e-9)


@pytest.mark.parametrize("lam", [1.0, 0.1])
def test_correct_matches_jax(lam):
    s = state(n=300, K=7, B=3, seed=4)
    phi_star = np.concatenate([np.ones((300, 1)), s["phi"]], 1)
    want = jh._correct(J(s["Z"]), J(s["R"]), J(phi_star), lam)
    got = th._correct(T(s["Z"]), T(s["R"]), T(phi_star), lam)
    close(got, want)


def jax_centroids(Z, K, seed):
    """The JAX harmony's initial centroids (its KMeans on its own
    normalized embedding)."""

    from single_algebra_tpu.models import KMeans as JKMeans

    Zc = jh._l2n(jnp.asarray(np.asarray(Z, np.float32)))
    km = JKMeans(n_clusters=K, n_init=1, max_iter=10, random_seed=seed).fit(np.asarray(Zc))
    return np.asarray(jh._l2n(jnp.asarray(km.cluster_centers_, jnp.float32)))


@pytest.mark.parametrize("seed,K,rounds", [(0, 6, 10), (7, 4, 3), (3, 4, 10)])
def test_whole_run_from_the_jax_centroids_matches_jax(seed, K, rounds):
    Z, _, b_lab = _batched_embedding(seed=seed)
    want = jh.harmony(Z, b_lab, n_clusters=K, max_rounds=rounds, seed=seed)
    B, codes = th._batch_codes(b_lab, Z.shape[0])
    Y = jax_centroids(Z, K, seed)
    kw = dict(sigma=0.1, theta=2.0, lam=1.0, max_rounds=rounds, max_kmeans_iters=20,
              block_frac=0.05, eps_kmeans=1e-5, eps_harmony=1e-4, seed=seed)
    got = th._harmony_from(torch.tensor(Z), codes, B, torch.tensor(Y), **kw)
    f64 = th._harmony_from(torch.tensor(Z, dtype=torch.float64), codes, B,
                           torch.tensor(Y, dtype=torch.float64), **kw)
    assert (got.n_rounds, got.converged) == (want.n_rounds, want.converged)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-4)
    scale = np.abs(f64.embedding).max()
    ours = np.abs(got.embedding - f64.embedding).max()
    jax_err = np.abs(want.embedding - f64.embedding).max()
    assert ours <= 5e-5 * scale
    assert np.abs(got.embedding - want.embedding).max() <= jax_err + 5e-5 * scale


def test_harmony_removes_batch_keeps_types():
    Z, t_lab, b_lab = _batched_embedding()
    res = harmony(Z, b_lab, n_clusters=6, seed=0, device="cpu")
    assert isinstance(res, HarmonyResult)
    assert res.embedding.shape == Z.shape and res.embedding.dtype == np.float32
    before = _batch_separation(Z, t_lab, b_lab)
    after = _batch_separation(res.embedding, t_lab, b_lab)
    assert after < 0.3 * before, (before, after)
    km = KMeans(n_clusters=3, n_init=3, random_seed=0, device="cpu").fit(res.embedding)
    assert adjusted_rand_index(t_lab, km.labels_.numpy()) > 0.95


def test_harmony_objective_decreases_across_rounds():
    Z, _, b_lab = _batched_embedding(seed=1)
    res = harmony(Z, b_lab, n_clusters=6, max_rounds=5, seed=0, device="cpu")
    assert len(res.objective) >= 2
    assert res.objective[-1] <= res.objective[0]


def test_harmony_single_batch_identity():
    Z, _, _ = _batched_embedding(seed=2)
    res = harmony(Z, ["only"] * Z.shape[0], device="cpu")
    np.testing.assert_array_equal(res.embedding, Z)
    assert res.converged and res.n_rounds == 0 and res.objective == []


def test_harmony_no_batch_effect_small_change():
    rng = np.random.default_rng(3)
    Z = rng.normal(0, 3, (300, 6)).astype(np.float32)
    b_lab = rng.choice(["a", "b"], 300)
    res = harmony(Z, b_lab, n_clusters=5, max_rounds=3, seed=0, device="cpu")
    assert np.linalg.norm(res.embedding - Z) / np.linalg.norm(Z) < 0.25


def test_harmony_validation_determinism_and_tensor_input():
    Z, _, b_lab = _batched_embedding(seed=4)
    with pytest.raises(ValueError, match="batch length"):
        harmony(Z, b_lab[:-1], device="cpu")
    with pytest.raises(ValueError, match="must be"):
        harmony(np.zeros(5), ["a"] * 5, device="cpu")
    r1 = harmony(Z, b_lab, n_clusters=4, max_rounds=2, seed=7, device="cpu")
    r2 = harmony(torch.from_numpy(Z), b_lab, n_clusters=4, max_rounds=2, seed=7)
    np.testing.assert_array_equal(r1.embedding, r2.embedding)
    assert r1.objective == r2.objective


def test_default_device_is_the_card():
    Z, _, b_lab = _batched_embedding(seed=5)
    if torch.cuda.is_available():
        assert harmony(Z, b_lab, n_clusters=4, max_rounds=1).embedding.shape == Z.shape
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            harmony(Z, b_lab, n_clusters=4, max_rounds=1)
