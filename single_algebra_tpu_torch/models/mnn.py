"""Mutual-nearest-neighbors batch correction (Haghverdi et al. 2018).

Counterpart of ``single_algebra_tpu/models/mnn.py``. Batches are
corrected in turn onto a growing reference. For each new batch the MNN
pairs come from two cross-set kNN passes (``neighbors.cross_knn``); each
cell's correction is the Gaussian-kernel weighted average of its
batch's pair vectors, with a per-cell bandwidth (the distance to the
k-th nearest pair anchor). The distances, bandwidths, kernel and the
weighted average run on the device in row blocks of the batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..types import precision_policy

__all__ = ["mnn_correct", "MNNResult"]

# elements of one [batch rows, pairs] kernel block
_KERNEL_BLOCK = 1 << 27


@dataclasses.dataclass
class MNNResult:
    corrected: np.ndarray  # [n, d] in the ORIGINAL row order
    n_pairs: List[int]  # MNN pairs found per merge step
    batch_order: List


def _mnn_pairs(R: np.ndarray, B: np.ndarray, k: int, device="cuda") -> np.ndarray:
    """Mutual kNN pairs ``[P, 2]`` (reference row, batch row), in the JAX
    package's order: by reference row, then by the reference row's
    neighbor rank."""

    from ..neighbors import cross_knn

    _, b_to_r = cross_knn(B, R, min(k, R.shape[0]), device=device)
    _, r_to_b = cross_knn(R, B, min(k, B.shape[0]), device=device)
    b_to_r, r_to_b = b_to_r.cpu().numpy(), r_to_b.cpu().numpy()
    r = np.repeat(np.arange(R.shape[0]), r_to_b.shape[1])
    b = r_to_b.ravel()
    mutual = (b_to_r[b] == r[:, None]).any(axis=1)
    return np.stack([r[mutual], b[mutual]], axis=1).astype(np.int64).reshape(-1, 2)


def mnn_correct(
    X,
    batch: Sequence,
    *,
    k: int = 20,
    sigma: float = 1.0,
    iterations: int = 2,
    device="cuda",
) -> MNNResult:
    """Correct batches onto the first batch's coordinate frame.

    ``X``: dense [n, d] (embedding or expression); ``batch``: length-n
    labels, merged in first-appearance order. ``sigma`` scales the
    per-cell Gaussian kernel. ``iterations``: pairs are re-derived on the
    partly corrected data (MNN pair vectors are edge-biased);
    ``iterations=1`` is the vanilla Haghverdi correction."""

    if iterations < 1:
        raise ValueError(f"iterations={iterations} must be >= 1")
    res = None
    for _ in range(iterations):
        res = _mnn_once(X, batch, k=k, sigma=sigma, device=device)
        X = res.corrected
    return res


@precision_policy()
def _correction(B: torch.Tensor, anchors: torch.Tensor, vec: torch.Tensor, *, k: int,
                sigma: float) -> torch.Tensor:
    """Each batch row's kernel-weighted average of the pair vectors."""

    nb, P = B.shape[0], anchors.shape[0]
    a2 = (anchors * anchors).sum(dim=1)
    kth = min(k, P - 1)
    out = torch.empty_like(B)
    step = max(1, _KERNEL_BLOCK // max(P, 1))
    for r0 in range(0, nb, step):
        b = B[r0:r0 + step]
        d2 = torch.clamp((b * b).sum(dim=1)[:, None] - 2.0 * (b @ anchors.T) + a2[None, :],
                         min=0.0)
        # per-cell bandwidth: the distance to the kth nearest anchor, so
        # the smoothing stays local
        h2 = sigma * sigma * torch.clamp(torch.kthvalue(d2, kth + 1, dim=1).values, min=1e-12)
        Wk = torch.exp(-d2 / (2.0 * h2[:, None] + 1e-30))
        Wk = Wk / torch.clamp(Wk.sum(dim=1, keepdim=True), min=1e-30)
        out[r0:r0 + step] = Wk @ vec
    return out


def _mnn_once(X, batch, *, k: int, sigma: float, device="cuda") -> MNNResult:
    if isinstance(X, torch.Tensor):
        device, X = X.device, X.cpu().numpy()
    X = np.asarray(X, np.float32)
    if X.ndim != 2:
        raise ValueError(f"X must be [n, d], got {X.shape}")
    n = X.shape[0]
    batch = np.asarray(list(batch))
    if batch.shape[0] != n:
        raise ValueError(f"batch length ({batch.shape[0]}) != rows ({n})")
    order = list(dict.fromkeys(batch.tolist()))
    if len(order) < 2:
        return MNNResult(X.copy(), [], order)

    out = X.copy()
    ref_rows = np.where(batch == order[0])[0]
    n_pairs = []
    for b in order[1:]:
        rows = np.where(batch == b)[0]
        R, B = out[ref_rows], out[rows]
        pairs = _mnn_pairs(R, B, k, device)
        n_pairs.append(len(pairs))
        if len(pairs) == 0:
            ref_rows = np.concatenate([ref_rows, rows])
            continue
        Bt = torch.as_tensor(B, device=device)
        vec = torch.as_tensor(R[pairs[:, 0]] - B[pairs[:, 1]], device=device)  # [P, d]
        anchors = Bt[torch.as_tensor(pairs[:, 1], device=device)]
        out[rows] = B + _correction(Bt, anchors, vec, k=k, sigma=sigma).cpu().numpy()
        ref_rows = np.concatenate([ref_rows, rows])
    return MNNResult(out, n_pairs, order)
