"""Statistic reductions over the padded-ELL layout.

Counterpart of ``single_algebra_tpu/ops/stats.py``: every statistic over
the *major* axis is a masked reduction along the width of the ELL grid,
and a statistic over the *minor* axis is the same reduction over the
transposed layout (see ``SparseMatrix``). They are jitted XLA reductions
in the JAX package, not Pallas kernels, so here they are plain PyTorch
on whatever device the tensors live.

Conventions:

* ``ell_data [R, W]`` float values, zero-padded.
* ``ell_ids  [R, W]`` int32 minor indices, zero-padded.
* ``row_nnz  [R]``    number of valid entries per major line. Validity
  comes from ``row_nnz`` (not ``data != 0``), so explicitly stored zeros
  count as entries.
* Masked variants take ``mask`` (bool) over the **minor** axis: an entry
  takes part iff ``mask[id]``.
"""

from __future__ import annotations

import torch

__all__ = [
    "valid_mask",
    "count_major",
    "sum_major",
    "sum_major_squared",
    "sum_major_masked",
    "sum_major_squared_masked",
    "count_major_masked",
    "min_max_major",
    "var_stored_major",
    "var_stored_major_masked",
    "sum_major_n_top",
    "var_bessel_dense",
]


def valid_mask(ell_ids: torch.Tensor, row_nnz: torch.Tensor) -> torch.Tensor:
    """[R, W] bool: True where the slot holds a stored entry."""

    width = ell_ids.shape[1]
    w = torch.arange(width, device=ell_ids.device, dtype=row_nnz.dtype)
    return w[None, :] < row_nnz[:, None]


def count_major(ell_ids: torch.Tensor, row_nnz: torch.Tensor) -> torch.Tensor:
    """Stored-entry count per major line."""

    del ell_ids
    return row_nnz


def sum_major(ell_data: torch.Tensor) -> torch.Tensor:
    """Sum of stored entries per major line (padding slots are exact
    zeros, so no mask is needed)."""

    return ell_data.sum(dim=1)


def sum_major_squared(ell_data: torch.Tensor) -> torch.Tensor:
    """Sum of squared stored entries per major line."""

    return (ell_data * ell_data).sum(dim=1)


def _gathered_mask(ell_ids, row_nnz, mask) -> torch.Tensor:
    """[R, W] bool: slot valid AND its minor index masked in."""

    return valid_mask(ell_ids, row_nnz) & mask[ell_ids.long()]


def sum_major_masked(ell_data, ell_ids, row_nnz, mask) -> torch.Tensor:
    m = _gathered_mask(ell_ids, row_nnz, mask)
    return torch.where(m, ell_data, torch.zeros_like(ell_data)).sum(dim=1)


def sum_major_squared_masked(ell_data, ell_ids, row_nnz, mask) -> torch.Tensor:
    m = _gathered_mask(ell_ids, row_nnz, mask)
    return torch.where(m, ell_data * ell_data, torch.zeros_like(ell_data)).sum(dim=1)


def count_major_masked(ell_ids, row_nnz, mask) -> torch.Tensor:
    return _gathered_mask(ell_ids, row_nnz, mask).sum(dim=1, dtype=torch.int32)


def min_max_major(ell_data, ell_ids, row_nnz):
    """(min, max) of stored entries per major line. Lines with no stored
    entry keep ``(dtype max, dtype min)``, finite extremes as in the
    reference, not infinities."""

    info = torch.finfo(ell_data.dtype)
    m = valid_mask(ell_ids, row_nnz)
    hi = torch.full((), info.max, dtype=ell_data.dtype, device=ell_data.device)
    lo = torch.full((), info.min, dtype=ell_data.dtype, device=ell_data.device)
    mins = torch.where(m, ell_data, hi).amin(dim=1)
    maxs = torch.where(m, ell_data, lo).amax(dim=1)
    return mins, maxs


def _stored_var(count, s, sq):
    """Population variance from count / sum / sum of squares, 0 where the
    count is 0 (clamped at 0: ``sq/n - mean^2`` can round negative for a
    near-constant line)."""

    safe = torch.clamp(count, min=1)
    mean = s / safe
    var = torch.clamp(sq / safe - mean * mean, min=0)
    return torch.where(count > 0, var, torch.zeros_like(var))


def var_stored_major(ell_data, ell_ids, row_nnz) -> torch.Tensor:
    """Population variance of the *stored entries only* per major line:
    the reference's ``var_*_chunk`` and ``_masked`` semantics (mean and
    variance over the stored count, no Bessel correction)."""

    del ell_ids
    count = row_nnz.to(ell_data.dtype)
    return _stored_var(count, sum_major(ell_data), sum_major_squared(ell_data))


def var_stored_major_masked(ell_data, ell_ids, row_nnz, mask) -> torch.Tensor:
    count = count_major_masked(ell_ids, row_nnz, mask).to(ell_data.dtype)
    s = sum_major_masked(ell_data, ell_ids, row_nnz, mask)
    sq = sum_major_squared_masked(ell_data, ell_ids, row_nnz, mask)
    return _stored_var(count, s, sq)


def sum_major_n_top(ell_data, ell_ids, row_nnz, n: int) -> torch.Tensor:
    """Sum of the top-n stored entries per major line; lines with at most
    n entries sum everything. Stored entries can be negative, so invalid
    slots are set to the dtype's lowest value before the selection."""

    width = ell_data.shape[1]
    if n >= width:
        return sum_major(ell_data)
    neg = torch.finfo(ell_data.dtype).min
    masked = torch.where(
        valid_mask(ell_ids, row_nnz), ell_data,
        torch.full((), neg, dtype=ell_data.dtype, device=ell_data.device),
    )
    top = masked.topk(n, dim=1).values
    return torch.where(top > neg, top, torch.zeros_like(top)).sum(dim=1)


def var_bessel_dense(s: torch.Tensor, sq: torch.Tensor, n: int) -> torch.Tensor:
    """Bessel-corrected variance over the full dense axis of length ``n``
    (implicit zeros take part): ``(sq/n - mean^2) * n/(n-1)``, the
    reference's plain ``var_col``."""

    if n <= 1:
        return torch.zeros_like(s)
    nf = torch.tensor(n, dtype=s.dtype, device=s.device)
    mean = s / nf
    pop = torch.clamp(sq / nf - mean * mean, min=0)
    return pop * (nf / (nf - 1))
