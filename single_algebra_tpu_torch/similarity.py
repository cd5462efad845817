"""Pairwise similarity measures (reference ``src/similarity/mod.rs``).

Counterpart of ``single_algebra_tpu/similarity.py``. Each measure has two
entry points:

* ``calculate(a, b)`` — one pair, with the reference's guards (zero norm
  -> 0.0, empty union -> 0.0, ...).
* ``pairwise(X, Y=None)`` — ``[n, m]`` similarities between the rows of
  two embedding matrices. Cosine, Pearson and Euclidean are one ``torch.mm``
  each (full float32: the package's precision policy keeps TF32 off);
  Euclidean uses ``||x||^2 + ||y||^2 - 2<x, y>``. Manhattan and Jaccard
  have no inner-product form and are row-blocked reductions, each block's
  ``[b, m, p]`` intermediate bounded by ``_BLOCK`` elements.

Tensors keep their device; a numpy input goes to ``device`` (the card
unless the caller names another).

The reference's semantics are kept, quirks included:

* Jaccard counts the positions where ``|a_i - b_i| < threshold`` as the
  intersection (positions where both are zero included) while the union
  counts only positions where either value is positive, so the ratio can
  exceed 1.
* Euclidean and Manhattan are RBF-style conversions ``exp(-gamma * dist)``
  with gamma 1.0 by default.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import precision_policy

__all__ = [
    "SimilarityMeasure",
    "CosineSimilarity",
    "EuclideanSimilarity",
    "PearsonSimilarity",
    "ManhattanSimilarity",
    "JaccardSimilarity",
]

# elements of one row block's [b, m, p] intermediate (the JAX package's)
_BLOCK = 1 << 22


def _as2d(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=device)
    return x[None, :] if x.ndim == 1 else x


def _block_rows(n: int, m: int, p: int) -> int:
    return min(max(1, _BLOCK // max(m * p, 1)), n)


def _blocked_pairwise(X, Y, row_fn) -> torch.Tensor:
    """``row_fn(X_block [b, 1, p], Y [1, m, p]) -> [b, m]`` over row blocks."""

    n, p = X.shape
    m = Y.shape[0]
    out = torch.empty((n, m), dtype=X.dtype, device=X.device)
    br = _block_rows(n, m, p)
    for r0 in range(0, n, br):
        out[r0:r0 + br] = row_fn(X[r0:r0 + br, None, :], Y[None, :, :])
    return out


def _guarded_ratio_(num, nx, ny, eps) -> torch.Tensor:
    """``num / (nx ny^T)`` where the norm product is ``> eps``, else 0, in
    place in ``num`` (an ``[n, m]`` output may be most of the card: one
    more temporary of its size, not four)."""

    denom = nx[:, None] * ny[None, :]
    small = denom <= eps
    num.div_(denom.clamp_(min=eps))
    del denom
    return num.masked_fill_(small, 0.0)


class SimilarityMeasure:
    """Base: ``calculate`` is a 1 x 1 ``pairwise``."""

    def __init__(self, device="cuda"):
        self.device = device

    def _pair(self, X, Y):
        X = _as2d(X, self.device)
        Y = X if Y is None else _as2d(Y, X.device)
        return X, Y

    def calculate(self, a, b) -> float:
        return float(self.pairwise(_as2d(a, self.device), _as2d(b, self.device))[0, 0])

    def pairwise(self, X, Y=None) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError


class CosineSimilarity(SimilarityMeasure):
    """dot / (||a|| ||b||); 0 when the norm product is at most eps."""

    @precision_policy()
    def pairwise(self, X, Y=None) -> torch.Tensor:
        X, Y = self._pair(X, Y)
        nx = torch.sqrt((X * X).sum(dim=1))
        ny = torch.sqrt((Y * Y).sum(dim=1))
        return _guarded_ratio_(X @ Y.T, nx, ny, torch.finfo(X.dtype).eps)


class EuclideanSimilarity(SimilarityMeasure):
    """exp(-gamma * ||a - b||_2)."""

    def __init__(self, gamma: float = 1.0, device="cuda"):
        super().__init__(device)
        self.gamma = float(gamma)

    @precision_policy()
    def pairwise(self, X, Y=None) -> torch.Tensor:
        X, Y = self._pair(X, Y)
        # (|x|^2 + |y|^2) - 2<x, y>, in that order, then exp(-gamma * dist),
        # all in place in the one [n, m] temporary besides the product
        sq = (X * X).sum(dim=1)[:, None] + (Y * Y).sum(dim=1)[None, :]
        sq.sub_((X @ Y.T).mul_(2.0))
        return sq.clamp_(min=0.0).sqrt_().mul_(-self.gamma).exp_()


class PearsonSimilarity(SimilarityMeasure):
    """Pearson correlation; 0 when the denominator is at most eps."""

    @precision_policy()
    def pairwise(self, X, Y=None) -> torch.Tensor:
        X, Y = self._pair(X, Y)
        Xc = X - X.mean(dim=1, keepdim=True)
        Yc = Y - Y.mean(dim=1, keepdim=True)
        vx = torch.sqrt((Xc * Xc).sum(dim=1))
        vy = torch.sqrt((Yc * Yc).sum(dim=1))
        return _guarded_ratio_(Xc @ Yc.T, vx, vy, torch.finfo(X.dtype).eps)


class ManhattanSimilarity(SimilarityMeasure):
    """exp(-gamma * ||a - b||_1)."""

    def __init__(self, gamma: float = 1.0, device="cuda"):
        super().__init__(device)
        self.gamma = float(gamma)

    def pairwise(self, X, Y=None) -> torch.Tensor:
        X, Y = self._pair(X, Y)
        d1 = _blocked_pairwise(X, Y, lambda xb, yb: (xb - yb).abs().sum(dim=-1))
        return torch.exp(-self.gamma * d1)


class JaccardSimilarity(SimilarityMeasure):
    """|{i: |a_i - b_i| < t}| / |{i: a_i > 0 or b_i > 0}|; 0 when the union
    is empty (the reference's quirks kept: see the module docs)."""

    def __init__(self, threshold: float | None = None, device="cuda"):
        super().__init__(device)
        self.threshold = (
            float(np.finfo(np.float64).eps) if threshold is None else float(threshold)
        )

    def pairwise(self, X, Y=None) -> torch.Tensor:
        X, Y = self._pair(X, Y)
        t = self.threshold

        def rows(xb, yb):
            inter = ((xb - yb).abs() < t).sum(dim=-1).to(X.dtype)
            union = ((xb > 0) | (yb > 0)).sum(dim=-1).to(X.dtype)
            return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                               torch.zeros_like(inter))

        return _blocked_pairwise(X, Y, rows)
