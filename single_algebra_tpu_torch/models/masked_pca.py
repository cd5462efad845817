"""MaskedSparsePCA — PCA restricted to a boolean feature subset.

Counterpart of ``single_algebra_tpu/models/masked_pca.py``, the
reference's ``MaskedSparsePCA``/``MaskedSparsePCABuilder``. The masked
view is a :class:`~..linalg.operators.MaskedOperator` over any engine
(an index scatter / gather of the operand), and on the Gram engine the
fit takes the submatrix of the cached full Gram (``gram_pca_graph``'s
``mask_idx``).

Kept from the reference, as in the JAX package:

* the mask length must equal the number of features exactly;
* ``mean_`` is FULL width (p), over all columns; the total variance is
  summed over the masked columns only;
* the Lanczos method does not center (the raw masked operator); only the
  projection is centered;
* ``components_`` is k x p_masked, and ``feature_importances`` covers the
  masked features only.

Divergence kept from the JAX package: the transform is the full
projection ``T = (X[:, mask] - 1 mu[mask]^T) V^T`` (the reference
subtracts the mean only at stored entries).

``save``/``load`` use the JAX package's ``.npz`` format, so a model saved
by either package loads in the other. A scipy input goes to ``device``
(the card unless the caller names another).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..linalg.operators import CenteredOperator, MaskedOperator
from ..types import SVDMethod, precision_policy
from ..utils.tracing import span
from .pca import _as_matrix, _LazyPCAState, _PCABuilder, _project, make_engine_operator

__all__ = ["MaskedSparsePCA", "MaskedSparsePCABuilder"]

_MASK_ERROR = (
    "The mask vector length and the number of features (columns) have to be the same!"
)


class MaskedSparsePCA(_LazyPCAState):
    """PCA over the masked columns. State after ``fit``: ``components_``
    (k x p_masked, on the matrix's device), ``explained_variance_`` (k),
    ``mean_`` (p, full width)."""

    def __init__(
        self,
        mask: Sequence[bool],
        n_components: int = 50,
        alpha: float = 1.0,
        tolerance: float = 1e-6,
        random_seed: int = 42,
        center: bool = True,
        verbose: bool = False,
        svd_method: SVDMethod = SVDMethod.lanczos(),
        engine: str = "auto",
        lanczos_steps: int | None = None,
        lanczos_block: int | None = None,
    ):
        self.mask = np.asarray(mask, dtype=bool)
        super().__init__(n_components, alpha, tolerance, random_seed, center, verbose,
                         svd_method, engine, lanczos_steps, lanczos_block)

    def _mask_idx(self, device) -> torch.Tensor:
        return torch.from_numpy(np.where(self.mask)[0]).to(device)

    @precision_policy()
    def fit(self, x, device="cuda") -> "MaskedSparsePCA":
        with span("pca.fit", model=type(self).__name__):
            m = _as_matrix(x, device)
            if m.shape[1] != self.mask.shape[0]:
                raise ValueError(_MASK_ERROR)
            return self._fit(m, np.where(self.mask)[0])

    def _print_fit(self, op, n_samples, n_cols, n_features, t0) -> None:
        sm, k = self.svd_method, self.n_components
        name = "Randomized" if sm.is_random else "Lanczos"
        print(f"PCA | SparseMasked | {name} SVD ({type(op).__name__}):")
        print(f"  Input shape: {n_samples} samples x {n_cols} features "
              f"(using {n_features} features with mask)")
        print(f"  Reduced to: {k} components")
        ev = np.asarray(self.explained_variance_, np.float64)
        if self.total_variance_:
            print(f"  Total variance explained: "
                  f"{float(ev.sum()) / self.total_variance_ * 100:.2f}%")
        print(f"  Fit took {time.perf_counter() - t0:.3f}s")

    @precision_policy()
    def transform(self, x) -> torch.Tensor:
        self._check_fitted()
        m = _as_matrix(x, self.components_.device)
        if m.shape[1] != self.mask.shape[0]:
            raise ValueError(_MASK_ERROR)
        idx = self._mask_idx(m.device)
        op = MaskedOperator(make_engine_operator(m, self.engine), idx)
        if self.center:
            op = CenteredOperator(op, self._mean_device()[idx])
        return _project(op, self.components_.T)

    @precision_policy()
    def fit_transform(self, x, device="cuda") -> torch.Tensor:
        return super().fit_transform(_as_matrix(x, device))

    @precision_policy()
    def inverse_transform(self, T) -> torch.Tensor:
        """Scores back to FULL feature width [n, p]: masked columns get
        ``T @ components_`` (+ their mean when centered); the columns the
        model never sees get their mean (the best constant), or zero when
        uncentered."""

        self._check_fitted()
        T = torch.as_tensor(T, device=self.components_.device)
        Rm = T @ self.components_
        p = self.mask.shape[0]
        if self.center:
            out = self._mean_device().to(Rm.dtype).expand(T.shape[0], p).clone()
        else:
            out = torch.zeros((T.shape[0], p), dtype=Rm.dtype, device=Rm.device)
        out[:, self._mask_idx(out.device)] += Rm
        return out

    def _saved_extra(self) -> dict:
        return dict(mask=self.mask)

    @classmethod
    def _loaded(cls, z, **kw) -> "MaskedSparsePCA":
        return cls(mask=z["mask"], **kw)


@dataclasses.dataclass
class MaskedSparsePCABuilder(_PCABuilder):
    """Builder with the reference's defaults and a required ``mask``."""

    _mask: Optional[np.ndarray] = None

    def mask(self, m) -> "MaskedSparsePCABuilder":
        self._mask = np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m, dtype=bool)
        return self

    def build(self) -> MaskedSparsePCA:
        if self._mask is None:
            raise ValueError("MaskedSparsePCABuilder requires a mask")
        return MaskedSparsePCA(mask=self._mask, **self._params())
