"""Doublet detection: the Scrublet algorithm (Wolock et al. 2019).

Counterpart of ``single_algebra_tpu/doublets.py`` (scanpy's
``pp.scrublet`` role), composed from the port's stages: total-count
normalize + log1p (device value maps), HVG selection, PCA on the
observed cells (``SparsePCABuilder``'s defaults), projection of
SIMULATED doublets (sums of random observed pairs, drawn with
``np.random.default_rng(seed)`` as in the JAX package) through the same
components, and a cross-set kNN against the observed + simulated union.
The doublet score is the Bayes posterior of the neighborhood's simulated
fraction:

    L_d = q / r,  L_s = 1 - q,
    score = rho * L_d / (rho * L_d + (1 - rho) * L_s)

with ``q`` the (smoothed) fraction of simulated neighbors, ``r`` the
simulated:observed ratio and ``rho`` the expected doublet rate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .types import precision_policy

__all__ = ["scrublet", "ScrubletResult"]


@dataclasses.dataclass
class ScrubletResult:
    doublet_scores: np.ndarray  # [n] posterior per observed cell
    sim_scores: np.ndarray  # [n_sim] scores of the simulated doublets
    predicted: np.ndarray  # [n] bool, scores above the threshold
    threshold: float
    embedding: np.ndarray  # [n, n_comps] observed-cell PCA (reusable)

    def __repr__(self):
        return (f"ScrubletResult(predicted={int(self.predicted.sum())}/"
                f"{len(self.predicted)}, threshold={self.threshold:.3f})")


def _auto_threshold(sim_scores: np.ndarray) -> float:
    """The midpoint of a 1-d 2-means fit of the (bimodal) simulated
    scores."""

    s = np.sort(np.asarray(sim_scores, np.float64))
    lo, hi = s[0], s[-1]
    if hi - lo < 1e-12:
        return float(hi)
    c = np.array([lo, hi])
    for _ in range(50):
        assign = np.abs(s[:, None] - c[None, :]).argmin(1)
        new = np.array([s[assign == j].mean() if (assign == j).any() else c[j] for j in range(2)])
        if np.allclose(new, c):
            break
        c = new
    return float(c.mean())


@precision_policy()
def scrublet(
    m,
    *,
    expected_doublet_rate: float = 0.06,
    sim_doublet_ratio: float = 2.0,
    n_top_genes: int = 2000,
    n_comps: int = 30,
    k: Optional[int] = None,
    threshold: Optional[float] = None,
    seed: int = 0,
    verbose: bool = False,
) -> ScrubletResult:
    """Score each cell's probability of being a doublet.

    ``m``: RAW counts ``SparseMatrix`` [cells, genes] (its device runs
    the stages). ``k`` defaults to ``round(0.5 * sqrt(n))``, expanded by
    ``(1 + r)`` for the union graph. ``threshold=None`` splits the
    simulated-score distribution automatically. ``verbose`` prints each
    stage's seconds (the card synchronized first).
    """

    import sys
    import time

    from . import feature_selection as fs
    from .models import SparsePCABuilder
    from .neighbors import cross_knn
    from .sparse.matrix import SparseMatrix
    from .types import Direction

    dev = m.device
    t0 = time.perf_counter()

    def _stage(name):
        nonlocal t0
        if verbose:
            # wait for the card's queue first, or its work is billed to a
            # later stage
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            print(f"[scrublet] {name}: {now - t0:.2f}s", file=sys.stderr)
            t0 = now

    n, p = m.shape
    if n < 10:
        raise ValueError(f"need at least 10 cells, got {n}")
    if not (0 < expected_doublet_rate < 1):
        raise ValueError("expected_doublet_rate must be in (0, 1)")
    rng = np.random.default_rng(seed)
    n_sim = max(int(round(sim_doublet_ratio * n)), 1)
    r = n_sim / n

    # --- simulate doublets on the raw counts (host CSR add) ------------
    X = m.to_scipy().tocsr()
    pair_a = rng.integers(0, n, n_sim)
    pair_b = rng.integers(0, n, n_sim)
    X_sim = X[pair_a] + X[pair_b]
    _stage("simulate (host CSR add)")

    # --- normalize + log1p, HVGs of the observed cells -------------------
    # the columns are selected on the raw host CSR and the row scaling
    # (full-gene sums, scrublet semantics) applied after
    def norm(mm, sums):
        return mm.normalize(np.asarray(sums, np.float32), 1e4, Direction.ROW).log1p_normalize()

    def put(a):
        return SparseMatrix.from_scipy(a, device=dev)

    sums_obs = np.asarray(X.sum(axis=1), np.float64).ravel()
    sums_sim = np.asarray(X_sim.sum(axis=1), np.float64).ravel()
    obs = norm(m, sums_obs)
    hvg = fs.highly_variable_genes(obs, n_top_genes=min(n_top_genes, p))
    _stage("normalize + HVG fit")
    if hvg.mask.all():
        obs_h, sim_h = obs, norm(put(X_sim), sums_sim)
    else:
        cols = np.flatnonzero(hvg.mask)
        obs_h = norm(put(X.tocsc()[:, cols].tocsr()), sums_obs)
        sim_h = norm(put(X_sim.tocsc()[:, cols].tocsr()), sums_sim)
    _stage("HVG column select + device payloads")

    # --- PCA fit on the observed cells, projection of the simulated ------
    n_comps = min(n_comps, obs_h.shape[1] - 1, n - 1)
    pca = SparsePCABuilder().n_components(n_comps).verbose(False).build()
    E_obs = pca.fit_transform(obs_h).float()
    _stage("PCA fit_transform (observed)")
    E_sim = pca.transform(sim_h).float()
    _stage("PCA transform (simulated)")

    # --- union kNN + posterior scores -----------------------------------
    if k is None:
        k = int(round(0.5 * np.sqrt(n)))
    k = max(k, 3)
    k_adj = int(round(k * (1 + r)))
    union = torch.cat([E_obs, E_sim])
    is_sim = np.concatenate([np.zeros(n, bool), np.ones(n_sim, bool)])

    def scores_of(E_query, self_offset: int):
        # one extra neighbor: the query is in the union (its self hit)
        _, idx = cross_knn(E_query, union, k_adj + 1, approx=True)
        idx = idx.cpu().numpy()
        # drop each row's self column, keeping the ascending order (a
        # stable argsort of the drop mask puts the kept entries first)
        self_ids = np.arange(idx.shape[0]) + self_offset
        keep = idx != self_ids[:, None]
        order = np.argsort(~keep, axis=1, kind="stable")
        idx = np.take_along_axis(idx, order[:, :k_adj], axis=1)
        q = (is_sim[idx].sum(axis=1) + 1.0) / (idx.shape[1] + 2.0)
        ld, ls = q / r, 1.0 - q
        rho = expected_doublet_rate
        return rho * ld / (rho * ld + (1.0 - rho) * ls)

    doublet_scores = scores_of(E_obs, 0)
    _stage("union kNN + scores (observed)")
    sim_scores = scores_of(E_sim, n)
    _stage("union kNN + scores (simulated)")

    thr = threshold if threshold is not None else _auto_threshold(sim_scores)
    return ScrubletResult(
        doublet_scores=doublet_scores,
        sim_scores=sim_scores,
        predicted=doublet_scores > thr,
        threshold=float(thr),
        embedding=E_obs.cpu().numpy(),
    )
