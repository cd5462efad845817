"""Dense-tensor preprocessing (reference ``src/dense/mod.rs``).

Counterpart of ``single_algebra_tpu/dense.py``. The reference's dense
``Normalize`` validates the length of ``sums`` strictly (it bails on a
mismatch) and, unlike the sparse implementations, has no zero-sum guard:
it divides by the given sums unconditionally. Both behaviours are kept,
plus ``log1p`` for parity with the sparse surface. Functions return new
tensors on the input's device; a numpy input goes to ``device``.
"""

from __future__ import annotations

import torch

from .types import Direction

__all__ = ["normalize", "log1p"]


def normalize(arr, sums, target, direction: Direction, device="cuda") -> torch.Tensor:
    """Scale rows/columns of a dense matrix so each sums to ``target``:
    ``arr * (target / sums)`` with no zero guard (a zero sum gives inf or
    nan, as in the reference)."""

    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(arr, device=device)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D array, got ndim={arr.ndim}")
    sums = torch.as_tensor(sums, device=arr.device).to(arr.dtype)
    axis, n = ("rows", arr.shape[0]) if direction == Direction.ROW else ("columns", arr.shape[1])
    if sums.shape[0] != n:
        raise ValueError(
            f"Length of sums ({sums.shape[0]}) does not match number of {axis} ({n})"
        )
    scale = torch.as_tensor(target, dtype=arr.dtype, device=arr.device) / sums
    return arr * (scale[:, None] if direction == Direction.ROW else scale[None, :])


def log1p(arr, device="cuda") -> torch.Tensor:
    """Elementwise ln(1 + x)."""

    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(arr, device=device)
    return torch.log1p(arr)
