"""Reference-to-query transfer: ``ingest`` and ``transfer_values``.

Counterpart of ``single_algebra_tpu/ingest.py`` (scanpy's ``tl.ingest``
role). Reference and query live in one embedding space (project the
query with the reference's fitted PCA first); labels transfer by an
inverse-distance-weighted kNN vote and continuous values by the same
weighted average. The kNN is the port's cross-set ``cross_knn`` on the
device; the weights and the vote are host float64.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["ingest", "transfer_values"]


def _weights(dists: np.ndarray) -> np.ndarray:
    """Inverse-distance weights; exact matches (distance 0) take all the
    mass."""

    d = np.asarray(dists, np.float64)
    zero = d <= 1e-12
    w = 1.0 / np.maximum(d, 1e-12)
    has_zero = zero.any(axis=1)
    w[has_zero] = zero[has_zero].astype(np.float64)
    return w / w.sum(axis=1, keepdims=True)


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _knn(E_query, E_ref, k: int, device):
    from .neighbors import cross_knn

    d, idx = cross_knn(E_query, E_ref, k, device=device)
    return d.cpu().numpy(), idx.cpu().numpy()


def ingest(E_ref, E_query, labels: Sequence, *, k: int = 15,
           device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Transfer categorical labels from reference to query cells:
    ``(predicted_labels, confidence)``, the confidence being the winning
    class's share of the inverse-distance kNN vote."""

    E_ref = np.asarray(_host(E_ref), np.float32)
    labels = _host(labels)
    if labels.shape[0] != E_ref.shape[0]:
        raise ValueError(
            f"labels length ({labels.shape[0]}) != reference rows ({E_ref.shape[0]})"
        )
    names, codes = np.unique(labels, return_inverse=True)
    d, idx = _knn(E_query, E_ref, k, device)
    w = _weights(d)  # [nq, k]
    onehot = np.eye(len(names))[codes[idx]]  # [nq, k, C]
    votes = np.einsum("qk,qkc->qc", w, onehot)
    best = votes.argmax(axis=1)
    return names[best], votes[np.arange(len(best)), best]


def transfer_values(E_ref, E_query, values, *, k: int = 15, device="cuda") -> np.ndarray:
    """Transfer continuous per-cell values (``[n_ref]`` or ``[n_ref, m]``,
    e.g. the reference's UMAP coordinates) by the weighted kNN average."""

    E_ref = np.asarray(_host(E_ref), np.float32)
    V = np.asarray(_host(values), np.float64)
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]
    if V.shape[0] != E_ref.shape[0]:
        raise ValueError(f"values rows ({V.shape[0]}) != reference rows ({E_ref.shape[0]})")
    d, idx = _knn(E_query, E_ref, k, device)
    out = np.einsum("qk,qkm->qm", _weights(d), V[idx])
    return out[:, 0] if squeeze else out
