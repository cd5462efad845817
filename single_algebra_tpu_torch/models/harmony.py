"""Harmony batch integration over PCA embeddings.

Counterpart of ``single_algebra_tpu/models/harmony.py`` (Korsunsky et al.
2019, harmonypy structure): iterate (a) diversity-penalized soft spherical
k-means over the cosine-normalized embedding and (b) per-cluster ridge
regression removing batch effects, until the objective stabilizes.

Everything is dense ``[n, K]`` / ``[n, B]`` / ``[K, d]`` linear algebra on
the device. The JAX package runs each k-means phase as one
``lax.while_loop``; here a Python loop runs the sweeps, with one scalar
pull per k-means iteration (the stopping rule). The block permutations
come from ``np.random.default_rng(seed)`` in both packages, so they are
the same. The initial centroids come from the port's ``KMeans``, whose
k-means++ draws are not ``jax.random``'s; :func:`_harmony_from` takes the
centroids, so the tests feed it the JAX package's.

The K ridge systems ``[B+1, B+1]`` are one batched solve, and the
per-cluster design ``R[:, k] * phi*`` is one ``[n, K (B+1)]`` operand:
the systems, their right-hand sides and the correction are three GEMMs
over it (1.2 GB at 10^6 cells, K 100 and two batches), never an
``[n, K, B+1, d]`` product.

**Departure from the JAX arithmetic: the ridge systems in float64.** The
systems are ill-conditioned by design: the intercept column of ``phi*``
is the sum of the batch columns, so only ``lam`` (1, against per-cluster
sums of ~n / K) separates them. Formed from float32 sums over 10^5 to
10^6 cells and solved in float32, as the JAX package does, their
solutions carry errors of order 1e-3 of max |Z| into the correction (the
smoke records the figure beside the port's). The port forms the systems
and their right-hand sides in float64 and solves there; the correction
itself is one float32 GEMM. At the tests' sizes the two agree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..types import precision_policy

__all__ = ["harmony", "HarmonyResult"]


@dataclasses.dataclass
class HarmonyResult:
    embedding: np.ndarray  # [n, d] corrected
    objective: list  # per harmony round
    n_rounds: int
    converged: bool


def _l2n(X: torch.Tensor) -> torch.Tensor:
    return X / torch.clamp(torch.linalg.norm(X, dim=1, keepdim=True), min=1e-12)


def _assign_block(Zc_blk, phi_blk, Y, O, E, sigma: float, theta: float):
    """Diversity-penalized soft assignment for one cell block:
    ``R ~ exp(-2 (1 - cos) / sigma) * prod_b ((E + 1) / (O + 1))^theta``
    gathered by the block's batch, normalized per cell."""

    dist = 2.0 * (1.0 - Zc_blk @ Y.T)  # [blk, K]
    penalty = ((E + 1.0) / (O + 1.0)) ** theta  # [B, K]
    logr = -dist / sigma + phi_blk @ torch.log(penalty)
    logr = logr - logr.amax(dim=1, keepdim=True)
    R = torch.exp(logr)
    return R / R.sum(dim=1, keepdim=True)


def _objective(Zc, Y, R, O, E, sigma, theta):
    """Harmony objective: k-means error + entropy + diversity penalty."""

    err = (R * 2.0 * (1.0 - Zc @ Y.T)).sum()
    ent = sigma * (R * torch.log(torch.clamp(R, min=1e-30))).sum()
    div = sigma * theta * (O * torch.log(torch.clamp((O + 1.0) / (E + 1.0), min=1e-30))).sum()
    return err + ent + div


def _kmeans_sweep(Zc, phi, R, O, E, nb_frac, blocks, sigma: float, theta: float):
    """One diversity-k-means iteration: the centroid update, then the
    block sweep over ``blocks`` (a sequence of cell-id tensors, the
    permuted blocks; the JAX package's padding ids, which it drops, are
    not in them). Returns ``(R, O, E, objective)``."""

    Y0 = _l2n(R.T @ Zc)
    R = R.clone()
    for idx in blocks:
        Rb, phib = R[idx], phi[idx]
        O1 = O - phib.T @ Rb
        E1 = E - torch.outer(nb_frac, Rb.sum(dim=0))
        Rb_new = _assign_block(Zc[idx], phib, Y0, O1, E1, sigma, theta).to(R.dtype)
        R[idx] = Rb_new
        O = O1 + phib.T @ Rb_new
        E = E1 + torch.outer(nb_frac, Rb_new.sum(dim=0))
    return R, O, E, _objective(Zc, Y0, R, O, E, sigma, theta)


def _kmeans_rounds(Zc, phi, R, O, E, nb_frac, perms, sigma: float, theta: float, eps: float):
    """A whole diversity-k-means phase: up to ``len(perms)`` iterations
    (``perms[i]``: iteration i's blocks) with the JAX package's
    relative-objective stopping rule, one scalar pull per iteration.
    Returns ``(R, O, E, objective)``."""

    prev = obj = torch.full((), float("inf"), dtype=Zc.dtype, device=Zc.device)
    for it, blocks in enumerate(perms):
        if it >= 2 and bool(torch.abs(prev - obj) < eps * torch.abs(prev)):
            break
        R, O, E, new_obj = _kmeans_sweep(Zc, phi, R, O, E, nb_frac, blocks, sigma, theta)
        prev, obj = obj, new_obj
    return R, O, E, obj


def _correct(Z, R, phi_star, lam: float):
    """Per-cluster ridge removal of batch effects.

    For each cluster k: ``W_k = (Phi*^T diag(R_k) Phi* + lam I')^-1
    Phi*^T diag(R_k) Z``, intercept unpenalized and its correction row
    zeroed; ``Z_corr = Z - sum_k R_k * (Phi* W_k)``. The K systems are one
    batched solve; ``RP = [R_k * Phi*]_k`` ``[n, K q]`` carries the three
    products."""

    n, q = phi_star.shape
    K, d = R.shape[1], Z.shape[1]
    RP = (R[:, :, None] * phi_star[:, None, :]).reshape(n, K * q)
    RP64 = RP.double()
    A = (RP64.T @ phi_star.double()).reshape(K, q, q)
    ridge = torch.ones(q, dtype=torch.float64, device=Z.device)
    ridge[0] = 0.0
    A = A + lam * torch.diag(ridge)
    b = (RP64.T @ Z.double()).reshape(K, q, d)
    del RP64
    W = torch.linalg.solve(A, b).to(Z.dtype)
    W[:, 0] = 0.0  # keep each cluster's own centroid
    return Z - RP @ W.reshape(K * q, d)


def _harmony_from(Z: torch.Tensor, codes: np.ndarray, n_batches: int, Y: torch.Tensor, *,
                  sigma: float, theta: float, lam: float, max_rounds: int,
                  max_kmeans_iters: int, block_frac: float, eps_kmeans: float,
                  eps_harmony: float, seed: int) -> HarmonyResult:
    """The harmony rounds from the initial centroids ``Y`` ``[K, d]``
    (unit rows): everything of :func:`harmony` after its k-means."""

    n = Z.shape[0]
    dev, dt = Z.device, Z.dtype
    K = Y.shape[0]
    codes_t = torch.as_tensor(codes, dtype=torch.int64, device=dev)
    phi = torch.nn.functional.one_hot(codes_t, n_batches).to(dt)  # [n, B]
    phi_star = torch.cat([torch.ones((n, 1), dtype=dt, device=dev), phi], dim=1)
    rng = np.random.default_rng(seed)

    Zd = Z
    Zc = _l2n(Zd)
    blk = max(int(np.ceil(n * block_frac)), 1)

    # initial R without diversity (O == E cancels the penalty)
    O0 = torch.ones((n_batches, K), dtype=dt, device=dev)
    R = _assign_block(Zc, phi, Y, O0, O0, sigma, theta)
    nb_frac = phi.sum(dim=0) / n  # [B]
    O = phi.T @ R
    E = torch.outer(nb_frac, R.sum(dim=0))

    objective, converged, rounds = [], False, 0
    for rounds in range(1, max_rounds + 1):
        # (a) diversity-penalized spherical k-means; every iteration's
        # permutation is drawn up front, as the JAX package draws them
        perms = []
        for _ in range(max_kmeans_iters):
            perm = torch.from_numpy(rng.permutation(n).astype(np.int64)).to(dev)
            perms.append(torch.split(perm, blk))
        R, O, E, obj = _kmeans_rounds(Zc, phi, R, O, E, nb_frac, perms, sigma, theta,
                                      eps_kmeans)
        objective.append(float(obj))

        # (b) ridge correction
        Zd = _correct(Zd, R, phi_star, lam)
        Zc = _l2n(Zd)

        if len(objective) > 1 and abs(objective[-2] - objective[-1]) < eps_harmony * abs(
                objective[-2]):
            converged = True
            break

    return HarmonyResult(Zd.cpu().numpy(), objective, rounds, converged)


def _batch_codes(batch: Sequence, n: int):
    batch = list(batch.cpu().numpy() if isinstance(batch, torch.Tensor) else batch)
    if len(batch) != n:
        raise ValueError(f"batch length ({len(batch)}) != rows ({n})")
    labels = list(dict.fromkeys(batch))
    code_of = {b: i for i, b in enumerate(labels)}
    return len(labels), np.fromiter((code_of[b] for b in batch), np.int64, n)


@precision_policy()
def harmony(
    Z,
    batch: Sequence,
    *,
    n_clusters: Optional[int] = None,
    sigma: float = 0.1,
    theta: float = 2.0,
    lam: float = 1.0,
    max_rounds: int = 10,
    max_kmeans_iters: int = 20,
    block_frac: float = 0.05,
    eps_kmeans: float = 1e-5,
    eps_harmony: float = 1e-4,
    seed: int = 0,
    device="cuda",
) -> HarmonyResult:
    """Remove batch effects from an embedding (harmonypy semantics).

    ``Z``: ``[n, d]`` PCA embedding (numpy, or a tensor, which keeps its
    device; numpy goes to ``device``). ``batch``: length-n labels.
    ``theta``: diversity pressure (0 = plain soft k-means). Returns the
    corrected embedding (host float32); downstream neighbors, clustering
    and UMAP run on it unchanged.
    """

    from .kmeans import KMeans

    if isinstance(Z, torch.Tensor):
        device = Z.device
    Zh = np.asarray(Z.cpu().numpy() if isinstance(Z, torch.Tensor) else Z, np.float32)
    if Zh.ndim != 2:
        raise ValueError(f"Z must be [n, d], got {Zh.shape}")
    n = Zh.shape[0]
    B, codes = _batch_codes(batch, n)
    if B < 2:
        return HarmonyResult(Zh.copy(), [], 0, True)

    K = min(n_clusters or int(min(100, max(2, round(n / 30)))), n)
    Zd = torch.from_numpy(np.ascontiguousarray(Zh)).to(device)
    # initial centroids: spherical k-means via the port's KMeans on the
    # cosine ball
    km = KMeans(n_clusters=K, n_init=1, max_iter=10, random_seed=seed, device=Zd.device)
    km.fit(_l2n(Zd))
    Y = _l2n(km.cluster_centers_.to(torch.float32))
    return _harmony_from(Zd, codes, B, Y, sigma=sigma, theta=theta, lam=lam,
                         max_rounds=max_rounds, max_kmeans_iters=max_kmeans_iters,
                         block_frac=block_frac, eps_kmeans=eps_kmeans,
                         eps_harmony=eps_harmony, seed=seed)
