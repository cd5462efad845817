"""Lanczos and block-Lanczos SVD of the torch port against the JAX package.

Both packages get the same numpy matrix and the JAX package's own start
vector / start block (``jax.random``, which torch cannot reproduce), so
the two recurrences compare step for step: singular values to 1e-5
relative in float32 and 1e-10 in float64 (the recurrences amplify
rounding differences between XLA's and torch's dots), the singular
subspaces by their principal angles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_algebra_tpu.linalg import block_lanczos as jblock
from single_algebra_tpu.linalg import lanczos as jlanczos
from single_algebra_tpu.linalg.operators import DenseOperator as JDense
from single_algebra_tpu_torch.linalg import block_lanczos as tblock
from single_algebra_tpu_torch.linalg import lanczos as tlanczos
from single_algebra_tpu_torch.linalg.operators import DenseOperator

DTYPES = {"float32": (np.float32, jnp.float32, 1e-5), "float64": (np.float64, jnp.float64, 1e-10)}


def planted(n, p, seed, decay=0.8, dtype=np.float32):
    """Dense matrix with a geometric singular-value decay."""

    rng = np.random.default_rng(seed)
    r = min(n, p)
    U, _ = np.linalg.qr(rng.standard_normal((n, r)))
    V, _ = np.linalg.qr(rng.standard_normal((p, r)))
    return ((U * (10.0 * decay ** np.arange(r))) @ V.T).astype(dtype)


def jax_v0(seed, p, dtype):
    """The start vector ``single_algebra_tpu.linalg.lanczos.lanczos_svd`` draws."""

    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return np.array(jax.random.normal(key, (p,), dtype=dtype))


def jax_V1(seed, p, b, dtype):
    """The start block of ``block_lanczos_svd``: Q of a Gaussian [p, b]."""

    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return np.array(jnp.linalg.qr(jax.random.normal(key, (p, b), dtype=dtype))[0])


def max_sin_angle(A, B):
    """Largest principal-angle sine between the row spaces of A and B."""

    Qa, _ = np.linalg.qr(np.asarray(A, np.float64).T)
    Qb, _ = np.linalg.qr(np.asarray(B, np.float64).T)
    return float(np.linalg.norm(Qb - Qa @ (Qa.T @ Qb), 2))


def assert_same(res, jres, rtol, angle):
    sj = np.asarray(jres.s)
    assert np.abs(res.s.numpy() - sj).max() <= rtol * sj[0]
    assert tuple(res.u.shape) == tuple(jres.u.shape)
    assert tuple(res.vt.shape) == tuple(jres.vt.shape)
    assert max_sin_angle(res.vt.numpy(), np.asarray(jres.vt)) <= angle
    assert max_sin_angle(res.u.numpy().T, np.asarray(jres.u).T) <= angle


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lanczos_fixed_depth_matches_jax(dtype):
    npdt, jdt, rtol = DTYPES[dtype]
    A = planted(220, 90, 1, dtype=npdt)
    k, steps, seed = 6, 40, 7
    jres = jlanczos.lanczos_svd(JDense(jnp.asarray(A)), k, steps=steps, seed=seed)
    info = {}
    res = tlanczos.lanczos_svd(DenseOperator(torch.from_numpy(A)), k, steps=steps, seed=seed,
                               v0=torch.from_numpy(jax_v0(seed, 90, jdt)), info=info)
    assert info["steps"] == steps
    assert_same(res, jres, rtol, 1e-3 if dtype == "float32" else 1e-8)
    s_true = np.linalg.svd(A.astype(np.float64), compute_uv=False)[:k]
    assert np.abs(res.s.numpy() - s_true).max() <= max(rtol, 1e-6) * s_true[0]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lanczos_adaptive_matches_jax(dtype):
    npdt, jdt, rtol = DTYPES[dtype]
    A = planted(300, 120, 2, decay=0.85, dtype=npdt)
    k, seed, tol = 5, 3, 1e-6
    jres = jlanczos.lanczos_svd(JDense(jnp.asarray(A)), k, seed=seed, tol=tol, check_every=8)
    info = {}
    res = tlanczos.lanczos_svd(DenseOperator(torch.from_numpy(A)), k, seed=seed, tol=tol,
                               check_every=8, v0=torch.from_numpy(jax_v0(seed, 120, jdt)),
                               info=info)
    # it stopped early, on a whole number of check blocks
    assert info["steps"] % 8 == 0 and info["steps"] < tlanczos.max_lanczos_steps(300, 120, k)
    assert_same(res, jres, rtol, 1e-3 if dtype == "float32" else 1e-8)


def test_lanczos_stops_on_exhaustion():
    # rank 3: the Krylov space is exhausted long before the budget
    rng = np.random.default_rng(4)
    A = (rng.standard_normal((80, 3)) @ rng.standard_normal((3, 50))).astype(np.float64)
    info = {}
    res = tlanczos.lanczos_svd(DenseOperator(torch.from_numpy(A)), 3, tol=1e-12,
                               check_every=4, info=info)
    assert info["steps"] <= 12
    s_true = np.linalg.svd(A, compute_uv=False)[:3]
    np.testing.assert_allclose(res.s.numpy(), s_true, rtol=1e-10)


def test_lanczos_step_budgets_match_jax():
    for n, p, k in ((1000, 400, 50), (100, 60, 5), (1_000_000, 30_000, 50)):
        assert tlanczos.default_lanczos_steps(n, p, k) == jlanczos.default_lanczos_steps(n, p, k)
        assert tlanczos.max_lanczos_steps(n, p, k) == jlanczos.max_lanczos_steps(n, p, k)


def test_lanczos_seeded_start_and_bad_v0():
    A = planted(120, 60, 5)
    op = DenseOperator(torch.from_numpy(A))
    a = tlanczos.lanczos_svd(op, 4, steps=30, seed=1)
    b = tlanczos.lanczos_svd(op, 4, steps=30, seed=1)
    assert torch.equal(a.s, b.s)
    s_true = np.linalg.svd(A.astype(np.float64), compute_uv=False)[:4]
    assert np.abs(a.s.numpy() - s_true).max() <= 1e-5 * s_true[0]
    with pytest.raises(ValueError):
        tlanczos.lanczos_svd(op, 4, steps=30, v0=torch.zeros(61))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("adaptive", [False, True])
def test_block_lanczos_matches_jax(dtype, b, adaptive):
    npdt, jdt, rtol = DTYPES[dtype]
    A = planted(260, 110, 6, decay=0.85, dtype=npdt)
    k, seed = 6, 11
    kw = dict(block_size=b, seed=seed, tol=1e-6) if adaptive else dict(
        block_size=b, seed=seed, steps=48 // b)
    jres = jblock.block_lanczos_svd(JDense(jnp.asarray(A)), k, **kw)
    info = {}
    res = tblock.block_lanczos_svd(DenseOperator(torch.from_numpy(A)), k,
                                   V1=torch.from_numpy(jax_V1(seed, 110, b, jdt)),
                                   info=info, **kw)
    if not adaptive:
        assert info["steps"] == 48 // b
    assert_same(res, jres, rtol, 1e-3 if dtype == "float32" else 1e-8)
    s_true = np.linalg.svd(A.astype(np.float64), compute_uv=False)[:k]
    assert np.abs(res.s.numpy() - s_true).max() <= max(rtol, 2e-6) * s_true[0]


def test_block_lanczos_tall_uses_cholesky_qr2():
    # >= 16384 rows: the CholeskyQR2 panel factorization, as in the JAX package
    A = planted(17000, 40, 7)
    seed, b, k = 5, 4, 5
    jres = jblock.block_lanczos_svd(JDense(jnp.asarray(A)), k, block_size=b, steps=6, seed=seed)
    res = tblock.block_lanczos_svd(DenseOperator(torch.from_numpy(A)), k, block_size=b, steps=6,
                                   V1=torch.from_numpy(jax_V1(seed, 40, b, jnp.float32)))
    assert_same(res, jres, 1e-5, 1e-3)


def test_block_lanczos_clamps_block_and_checks_V1():
    A = planted(30, 5, 8)
    op = DenseOperator(torch.from_numpy(A))
    res = tblock.block_lanczos_svd(op, 3, block_size=8, steps=2)  # b clamps to 5
    s_true = np.linalg.svd(A.astype(np.float64), compute_uv=False)[:3]
    assert np.abs(res.s.numpy() - s_true).max() <= 1e-5 * s_true[0]
    with pytest.raises(ValueError):
        tblock.block_lanczos_svd(op, 3, block_size=4, steps=2, V1=torch.zeros((5, 3)))
