"""Sparse @ dense products over the plain padded-ELL layout.

Counterpart of ``single_algebra_tpu/ops/spmm.py``'s ``ell_spmm``: a
row-blocked gather (``index_select``) plus a batched contraction, on any
device. It is an XLA gather in the JAX package, not a Pallas kernel. It
serves the gather engine (``SparseOperator``), ``SparseMatrix``'s
products, and the tiled engine's overflow side arrays (the few entries
past the main level's width). ``ell_scatter_densify`` is the JAX
package's ELL-block densify, also an XLA scatter there.
"""

from __future__ import annotations

import torch

__all__ = ["ell_spmm", "ell_spmm_xla", "ell_scatter_densify", "ell_onehot_spmm"]

# elements of the gathered [br, W, k] intermediate per row block (the JAX
# package's _GATHER_BUDGET)
_GATHER_BUDGET = 1 << 22


def _row_block(W: int, k: int, R: int) -> int:
    br = max(8, _GATHER_BUDGET // max(W * k, 1))
    return min((br // 8) * 8, R)


def ell_spmm(ell_data: torch.Tensor, ell_ids: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``out[r, :] = sum_w ell_data[r, w] * B[ell_ids[r, w], :]`` -> ``[R, k]``.

    Padding slots have ``data == 0`` and ``id == 0``, so they add exact
    zeros. Rows go in blocks that bound the gathered intermediate at
    ``_GATHER_BUDGET`` elements; the contraction runs in the promoted
    dtype of the values and ``B`` at full precision."""

    R, W = ell_data.shape
    k = B.shape[1]
    dt = torch.promote_types(ell_data.dtype, B.dtype)
    out = torch.empty((R, k), dtype=dt, device=B.device)
    if R == 0:
        return out
    Bd = B.to(dt)
    br = _row_block(W, k, R)
    for r0 in range(0, R, br):
        r1 = min(r0 + br, R)
        g = Bd.index_select(0, ell_ids[r0:r1].reshape(-1).long()).view(r1 - r0, W, k)
        out[r0:r1] = torch.bmm(ell_data[r0:r1].to(dt).unsqueeze(1), g).squeeze(1)
    return out


#: the name the JAX package gives the gather path (there beside its
#: dispatcher ``ell_spmm``, which always takes it)
ell_spmm_xla = ell_spmm


def ell_scatter_densify(ell_data, ell_ids, row_nnz, n: int) -> torch.Tensor:
    """Major-axis ELL block -> dense ``[R, n]`` by one scatter-add (stored
    entries with the same id add up; padded slots add nothing)."""

    R, W = ell_data.shape
    valid = torch.arange(W, device=ell_data.device)[None, :] < row_nnz[:, None]
    vals = torch.where(valid, ell_data, torch.zeros_like(ell_data))
    ids = torch.where(valid, ell_ids, torch.zeros_like(ell_ids)).long()
    out = torch.zeros((R, n), dtype=ell_data.dtype, device=ell_data.device)
    return out.scatter_add_(1, ids, vals)


def ell_onehot_spmm(ell_data, ell_ids, codes: torch.Tensor, nb: int) -> torch.Tensor:
    """``ell_spmm(ell_data, ell_ids, onehot)`` for the indicator matrix
    ``onehot[i, codes[i]] = 1`` -> ``[R, nb]``.

    Each row of the indicator holds one 1, so the product adds each
    line's stored values into the bin of their id's code: one scatter-add
    over the payload, where the gather form would materialize a
    ``[R, W, nb]`` intermediate (150 GB for the 64 batches of a 1M x 30k
    matrix's column layout). Padded slots carry value 0 and add nothing."""

    R = ell_data.shape[0]
    bins = codes.to(ell_data.device).long()[ell_ids.long()]
    out = torch.zeros((R, nb), dtype=ell_data.dtype, device=ell_data.device)
    return out.scatter_add_(1, bins, ell_data)
