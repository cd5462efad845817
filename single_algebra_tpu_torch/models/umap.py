"""UMAP's exact kNN graph, the one part of ``models/umap.py`` ported yet.

Counterpart of ``single_algebra_tpu/models/umap.py::_knn_graph``, which
t-SNE's knn mode imports. The rest of the JAX module (the fuzzy simplicial
set, the layout optimizer, ``UMAP`` / ``UMAPConfig``) waits for ROADMAP
Queue 1 item 5, with ``neighbors.py``.
"""

from __future__ import annotations

import torch

__all__: list = []


def _knn_graph(X: torch.Tensor, *, k: int, block: int = 2048):
    """Exact kNN excluding self: ``(dists [n, k], idx [n, k])``, nearest
    first, ``idx`` int32.

    ``[block, n]`` squared-distance tiles ``|x|^2 + |y|^2 - 2 x.y``
    computed in float32 (one GEMM each), the self pair masked to inf,
    ``topk`` of the negated tile, and ``sqrt(max(d, 0))`` at the end.
    Memory O(block * n). Among equal distances the order of the ids is
    torch's, which may differ from ``lax.top_k``'s."""

    X = X.float()
    n = X.shape[0]
    sq = (X * X).sum(dim=1)
    d_all = torch.empty((n, k), dtype=torch.float32, device=X.device)
    i_all = torch.empty((n, k), dtype=torch.int32, device=X.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        d2 = sq[r0:r1, None] + sq[None, :]
        d2.addmm_(X[r0:r1], X.T, alpha=-2.0)
        torch.diagonal(d2, offset=r0).fill_(float("inf"))
        nd, ni = torch.topk(-d2, k, dim=1)
        d_all[r0:r1] = -nd
        i_all[r0:r1] = ni.int()
    return torch.sqrt(torch.clamp(d_all, min=0.0)), i_all
