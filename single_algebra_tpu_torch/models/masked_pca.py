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
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..linalg.gram import GramPCAEngine, gram_pca_graph
from ..linalg.operators import CenteredOperator, MaskedOperator
from ..types import SVDMethod, precision_policy
from ..utils.tracing import span
from .pca import (
    _LazyPCAState,
    _as_matrix,
    _fit_graph,
    _host_col_stats,
    _project,
    _warn_gram_ignores_lanczos_knobs,
    make_engine_operator,
)

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
        self.lanczos_steps = lanczos_steps
        self.lanczos_block = lanczos_block
        self.engine = engine
        self.mask = np.asarray(mask, dtype=bool)
        self.n_components = n_components
        self.alpha = alpha  # parity field; unused, as in the reference
        self.tolerance = tolerance
        self.random_seed = random_seed
        self.center = center
        self.verbose = verbose
        self.svd_method = svd_method
        self.lanczos_steps_taken_: int | None = None
        self._init_lazy_state()

    def _mask_idx(self, device) -> torch.Tensor:
        return torch.from_numpy(np.where(self.mask)[0]).to(device)

    @precision_policy()
    def fit(self, x, device="cuda") -> "MaskedSparsePCA":
        with span("pca.fit", model=type(self).__name__):
            return self._fit(x, device)

    def _fit(self, x, device) -> "MaskedSparsePCA":
        m = _as_matrix(x, device)
        n_samples, n_cols = m.shape
        if n_cols != self.mask.shape[0]:
            raise ValueError(_MASK_ERROR)
        k = self.n_components
        t0 = time.perf_counter()
        idx = self._mask_idx(m.device)
        idx_np = np.where(self.mask)[0]
        n_features = len(idx_np)

        op = make_engine_operator(m, self.engine)
        t1 = time.perf_counter()
        col_sums, col_sq = _host_col_stats(m)
        dt = np.float32 if m.dtype == torch.float32 else np.float64
        if self.center:
            mean_np = (col_sums / n_samples).astype(dt)
        else:
            mean_np = np.zeros(n_cols, dt)
        self.mean_ = mean_np  # FULL width, as in the reference
        self._mean_dev = torch.as_tensor(mean_np, device=m.device)

        total_var = None
        if self.center and n_samples > 1:
            mean64 = col_sums / n_samples
            var_all = (col_sq - mean64 * col_sums) / (n_samples - 1)
            total_var = float(var_all[idx_np].sum())
        t_stats = time.perf_counter() - t1

        sm = self.svd_method
        want_t = getattr(self, "_want_transform", False)
        if isinstance(op, GramPCAEngine):
            # masked Gram PCA = the submatrix of the cached full Gram
            _warn_gram_ignores_lanczos_knobs(self)
            s_dev, vt, T = gram_pca_graph(
                op, op.gram_cached(), self._mean_dev, self.random_seed, k=k,
                center_svd=self.center and sm.is_random, center_T=self.center,
                want_transform=want_t, mask_idx=idx,
                solver_oversamples=sm.n_oversamples if sm.is_random else 10,
                solver_iters=sm.n_power_iterations if sm.is_random else 6,
            )
        else:
            info = {}
            s_dev, vt, T = _fit_graph(
                MaskedOperator(op, idx), self._mean_dev[idx], self.random_seed, k=k,
                method=sm, center=self.center, steps=self.lanczos_steps,
                want_transform=want_t, tol=self.tolerance,
                lanczos_block=self.lanczos_block, info=info,
            )
            self.lanczos_steps_taken_ = info.get("steps")
        self._fitted_transform = T
        self._fit_timings = dict(stats=t_stats)
        self.components_ = vt  # k x p_masked
        self._set_fit_state(s_dev, total_var, n_samples, min(n_samples, n_features))

        if self.verbose:
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
        return self

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
        m = _as_matrix(x, device)  # convert once; fit and transform share layouts
        self._want_transform = True
        try:
            self.fit(m)
        finally:
            self._want_transform = False
        T = self._fitted_transform
        self._fitted_transform = None
        return T

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

    def feature_importances(self) -> torch.Tensor:
        self._check_fitted()
        return self.components_**2

    def explained_variance_ratio(self) -> torch.Tensor:
        self._check_fitted()
        ev = np.asarray(self.explained_variance_, dtype=np.float64)
        return torch.from_numpy(ev / ev.sum())

    def cumulative_explained_variance_ratio(self) -> torch.Tensor:
        return torch.cumsum(self.explained_variance_ratio(), dim=0)

    def _check_fitted(self):
        if self.components_ is None:
            raise RuntimeError("Must be fitted before transform!")

    def save(self, path: str) -> None:
        np.savez(
            path,
            components=self.components_.cpu().numpy(),
            explained_variance=np.asarray(self.explained_variance_),
            mean=np.asarray(self.mean_),
            mask=self.mask,
            meta=np.array(
                [self.n_components, int(self.center), self.random_seed,
                 self.total_variance_ or 0.0, self.noise_variance_ or 0.0],
                dtype=np.float64,
            ),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "MaskedSparsePCA":
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"  # np.savez appends the suffix; np.load does not
        with np.load(path) as z:
            meta = z["meta"]
            obj = cls(mask=z["mask"], n_components=int(meta[0]), center=bool(meta[1]),
                      random_seed=int(meta[2]))
            obj.components_ = torch.as_tensor(np.array(z["components"]), device=device)
            obj.explained_variance_ = np.array(z["explained_variance"])
            obj.mean_ = np.array(z["mean"])
            obj.total_variance_ = float(meta[3])
            obj.noise_variance_ = float(meta[4])
        return obj


@dataclasses.dataclass
class MaskedSparsePCABuilder:
    """Builder with the reference's defaults and a required ``mask``."""

    _mask: Optional[np.ndarray] = None
    _n_components: int = 50
    _alpha: float = 1.0
    _tolerance: float = 1e-6
    _random_seed: int = 42
    _center: bool = True
    _verbose: bool = False
    _svd_method: SVDMethod = dataclasses.field(default_factory=SVDMethod.lanczos)
    _engine: str = "auto"
    _lanczos_steps: int | None = None
    _lanczos_block: int | None = None

    def lanczos_block(self, b: int | None) -> "MaskedSparsePCABuilder":
        self._lanczos_block = b
        return self

    def lanczos_steps(self, n: int) -> "MaskedSparsePCABuilder":
        self._lanczos_steps = n
        return self

    def engine(self, e: str) -> "MaskedSparsePCABuilder":
        self._engine = e
        return self

    def mask(self, m) -> "MaskedSparsePCABuilder":
        self._mask = np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m, dtype=bool)
        return self

    def n_components(self, n: int) -> "MaskedSparsePCABuilder":
        self._n_components = n
        return self

    def alpha(self, a: float) -> "MaskedSparsePCABuilder":
        self._alpha = a
        return self

    def tolerance(self, t: float) -> "MaskedSparsePCABuilder":
        self._tolerance = t
        return self

    def random_seed(self, s: int) -> "MaskedSparsePCABuilder":
        self._random_seed = s
        return self

    def center(self, c: bool) -> "MaskedSparsePCABuilder":
        self._center = c
        return self

    def verbose(self, v: bool) -> "MaskedSparsePCABuilder":
        self._verbose = v
        return self

    def svd_method(self, m: SVDMethod) -> "MaskedSparsePCABuilder":
        self._svd_method = m
        return self

    def build(self) -> MaskedSparsePCA:
        if self._mask is None:
            raise ValueError("MaskedSparsePCABuilder requires a mask")
        return MaskedSparsePCA(
            mask=self._mask,
            n_components=self._n_components,
            alpha=self._alpha,
            tolerance=self._tolerance,
            random_seed=self._random_seed,
            center=self._center,
            verbose=self._verbose,
            svd_method=self._svd_method,
            engine=self._engine,
            lanczos_steps=self._lanczos_steps,
            lanczos_block=self._lanczos_block,
        )
