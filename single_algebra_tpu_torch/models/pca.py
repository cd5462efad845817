"""SparsePCA — PCA for sparse matrices, on every engine of the JAX package.

Counterpart of ``single_algebra_tpu/models/pca.py`` with the same
builder defaults (n_components=50, alpha=1.0, tolerance=1e-6, seed=42,
center=True, method=Lanczos) and the same semantics:

* Lanczos never centers the matrix, only the projection; on the Gram
  engine the Lanczos method is therefore the exact UNCENTERED Gram solve
  and the randomized method the centered one.
* ``explained_variance_ratio`` divides by the sum of the computed
  components' variances (ratios sum to 1), as the reference does.
* ``feature_importances`` = squared loadings, k x p.
* ``save``/``load`` use the JAX package's ``.npz`` format, so a model
  saved by either package loads in the other.

The engines: the densified engine (``DensifiedOperator``), the Gram
engine (``linalg/gram.py``), the tiled engine (``TiledSparseOperator``)
and the gather engine (``SparseOperator``), with the randomized, Lanczos
and block-Lanczos solvers on the non-Gram engines. ``make_engine_operator``
keeps the JAX decision order.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional, Self

import numpy as np
import torch

from ..linalg.block_lanczos import block_lanczos_svd
from ..linalg.gram import EIGH_MAX_PP, GramPCAEngine, gram_pca_graph
from ..linalg.lanczos import lanczos_svd
from ..linalg.operators import (
    CenteredOperator,
    DensifiedOperator,
    MaskedOperator,
    SparseOperator,
    TiledSparseOperator,
)
from ..linalg.svd import randomized_svd, svd_flip
from ..sparse.matrix import SparseMatrix
from ..types import SVDMethod, precision_policy
from ..utils.tracing import span

__all__ = ["SparsePCA", "SparsePCABuilder", "make_engine_operator"]


def _as_matrix(x, device="cuda") -> SparseMatrix:
    """A scipy input becomes a matrix on ``device`` (the card unless the
    caller names another); a ``SparseMatrix`` keeps its own device."""

    if isinstance(x, SparseMatrix):
        return x
    return SparseMatrix.from_scipy(x, device=device)


def _host_col_stats(m: SparseMatrix):
    """(sum_col, sum_col_squared) per column, float64 numpy: the matrix's
    kept host statistics (``SparseMatrix._host_col_stats``). The fit looks
    this name up at each call."""

    return m._host_col_stats()


def _needs_lo(m: SparseMatrix) -> bool:
    """True when the values are NOT bf16-exact (the densified engine then
    needs a second, lo, half)."""

    return not m.values_bf16_exact()


def make_engine_operator(m: SparseMatrix, engine: str = "auto"):
    """Select and build the compute engine for a matrix (cached per matrix).

    'auto' on a CUDA device takes the JAX package's order: the densified
    engine when the dense bf16 form fits 0.6 of device memory, else the
    Gram engine when its plan fits 0.8, else the tiled engine when its
    payload fits 0.6, else the gather engine ('sparse'). On any other
    device 'auto' is 'sparse', as off the TPU in the JAX package.
    """

    with span("pca.engine", requested=engine) as current:
        cache = m._operator_cache
        if engine in cache:
            current.set(cached=True)
            return cache[engine]
        chosen = _choose_engine(m) if engine == "auto" else engine
        current.set(engine=chosen, cached=chosen in cache)
        if chosen not in cache:
            cache[chosen] = _build_engine(m, chosen)
        cache[engine] = cache[chosen]
        return cache[chosen]


def _choose_engine(m: SparseMatrix) -> str:
    """The engine 'auto' takes for ``m`` (see :func:`make_engine_operator`)."""

    if m.device.type != "cuda" or m.dtype != torch.float32:
        return "sparse"
    with span("pca.engine_gates"):
        if DensifiedOperator.fits(
            m.shape, needs_lo=False, device=m.device
        ) and DensifiedOperator.fits(
            m.shape, needs_lo=_needs_lo(m), device=m.device
        ):
            return "dense"
        if GramPCAEngine.fits(m):
            return "gram"
        if TiledSparseOperator.fits(m):
            return "tiled"
        return "sparse"


def _build_engine(m: SparseMatrix, engine: str):
    if engine == "dense":
        return DensifiedOperator.from_matrix(m)
    if engine == "gram":
        return GramPCAEngine.from_matrix(m)
    if engine == "tiled":
        return TiledSparseOperator.from_matrix(m)
    if engine == "sparse":
        return SparseOperator.from_matrix(m)
    raise ValueError(f"unknown engine {engine!r}")


def _fit_graph(op, mean, seed, *, k: int, method: SVDMethod, center: bool,
               steps: int | None = None, want_transform: bool, tol: float | None = None,
               lanczos_block: int | None = None, omega=None, start=None,
               info: dict | None = None):
    """The fit on a non-Gram engine: SVD -> sign flip -> optional scores
    ``(X - 1 mu^T) V^T`` through the operator's precise product.

    The randomized method solves the (centered) operator. The Lanczos
    methods run on the RAW operator (the reference never centers the
    Lanczos path; only the projection is centered): block Lanczos when
    ``lanczos_block`` is set, else the scalar recurrence; ``tol`` drives
    their convergence-adaptive mode and ``steps`` is the Krylov budget.
    ``omega`` replaces the seeded sketch and ``start`` the Lanczos start
    vector / block (the parity tests pass the JAX package's); ``info``
    receives the steps a Lanczos solver took."""

    proj_op = CenteredOperator(op, mean) if center else op
    if method.is_random:
        res = randomized_svd(
            proj_op, k, method.n_oversamples, method.n_power_iterations,
            method.normalizer, seed=seed, omega=omega,
        )
    elif lanczos_block is not None:
        # `steps` is the KRYLOV DIMENSION on every ``SparsePCABuilder`` surface;
        # block_lanczos_svd counts block steps, so convert here: a tuned
        # depth carries over between the two modes
        bsteps = None if steps is None else max(-(-steps // lanczos_block), 2)
        res = block_lanczos_svd(
            op, k, block_size=lanczos_block, steps=bsteps, seed=seed, tol=tol,
            V1=start, info=info,
        )
    else:
        res = lanczos_svd(op, k, steps=steps, seed=seed, tol=tol, v0=start, info=info)
    _, vt = svd_flip(res.u, res.vt, u_based_decision=False)
    T = _project(proj_op, vt.T) if want_transform else None
    return res.s, vt, T


def _project(op, comps_t):
    """The PCA projection, through the operator's precise product."""

    return getattr(op, "mv_precise", op.mv)(comps_t)


def _warn_gram_ignores_lanczos_knobs(model) -> None:
    """The Gram engine computes the Lanczos method as an exact uncentered
    solve: say so when the user tuned Lanczos-only knobs."""

    if model.svd_method.is_random:
        return
    tuned = [
        name
        for name, v in (
            ("lanczos_steps", model.lanczos_steps),
            ("lanczos_block", model.lanczos_block),
        )
        if v is not None
    ]
    if tuned:
        warnings.warn(
            "engine='gram' computes the Lanczos method as an exact "
            f"(uncentered) Gram solve; {', '.join(tuned)} (and tolerance) "
            "are not used on this path.",
            UserWarning,
            stacklevel=3,
        )


class _LazyPCAState:
    """The PCA model both ``SparsePCA`` and ``MaskedSparsePCA`` are: the
    constructor's fields, the one fit core (:meth:`_fit`), the model
    state, the analysis methods and ``save``/``load``.

    ``components_`` stays a device tensor (it feeds ``transform``);
    ``mean_`` and ``explained_variance_`` are host numpy. The singular
    values are pulled to the host (the sync point) only when
    ``explained_variance_`` / ``total_variance_`` / ``noise_variance_`` is
    first read, so ``fit`` returns with the device work still queued."""

    def __init__(
        self,
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
        self.n_components = n_components
        self.engine = engine
        self.alpha = alpha  # parity field; unused, as in the reference
        self.tolerance = tolerance
        self.random_seed = random_seed
        self.center = center
        self.verbose = verbose
        self.svd_method = svd_method
        self.lanczos_steps_taken_: int | None = None  # (block) steps of the last Lanczos fit
        self.components_: Optional[torch.Tensor] = None
        self._mean_np: Optional[np.ndarray] = None
        self._mean_dev: Optional[torch.Tensor] = None
        self._s_dev: Optional[torch.Tensor] = None
        self._ev_np: Optional[np.ndarray] = None
        self._total_var: Optional[float] = None
        self._noise_var: Optional[float] = None
        self._fit_n_samples: Optional[int] = None
        self._fit_min_dim: Optional[int] = None

    # -- fitting -------------------------------------------------------

    @precision_policy()
    def fit(self, x):
        with span("pca.fit", model=type(self).__name__):
            return self._fit(_as_matrix(x))

    def _fit(self, m: SparseMatrix, idx: np.ndarray | None = None):
        """The fit over the columns ``idx`` of ``m`` (all when None).
        ``mean_`` is FULL width (p), over all columns; the total variance
        is summed over ``idx``. On the Gram engine a mask takes the
        submatrix of the cached full Gram; on the others the operator's
        masked view (``MaskedOperator``)."""

        n_samples, n_cols = m.shape
        n_features = n_cols if idx is None else len(idx)
        k = self.n_components
        t0 = time.perf_counter()

        op = make_engine_operator(m, self.engine)
        t1 = time.perf_counter()

        col_sums, col_sq = _host_col_stats(m)
        dt = np.float32 if m.dtype == torch.float32 else np.float64
        if self.center:
            mean_np = (col_sums / n_samples).astype(dt)
        else:
            mean_np = np.zeros(n_cols, dt)
        self.mean_ = mean_np
        self._mean_dev = torch.as_tensor(mean_np, device=m.device)

        total_var = None
        if self.center and n_samples > 1:
            mean64 = col_sums / n_samples
            var = (col_sq - mean64 * col_sums) / (n_samples - 1)
            total_var = float((var if idx is None else var[idx]).sum())
        t_stats = time.perf_counter() - t1

        idx_dev = None if idx is None else torch.from_numpy(idx).to(m.device)
        sm = self.svd_method
        want_t = getattr(self, "_want_transform", False)
        if isinstance(op, GramPCAEngine):
            # the Lanczos method maps to the uncentered exact solve, the
            # randomized one to the centered
            _warn_gram_ignores_lanczos_knobs(self)
            s_dev, vt, T = gram_pca_graph(
                op, op.gram_cached(), self._mean_dev, self.random_seed, k=k,
                center_svd=self.center and sm.is_random, center_T=self.center,
                want_transform=want_t, mask_idx=idx_dev,
                solver_oversamples=sm.n_oversamples if sm.is_random else 10,
                solver_iters=sm.n_power_iterations if sm.is_random else 6,
            )
        else:
            fit_op, mean = op, self._mean_dev
            if idx_dev is not None:
                fit_op, mean = MaskedOperator(op, idx_dev), mean[idx_dev]
            info = {}
            s_dev, vt, T = _fit_graph(
                fit_op, mean, self.random_seed, k=k, method=sm,
                center=self.center, steps=self.lanczos_steps,
                want_transform=want_t, tol=self.tolerance,
                lanczos_block=self.lanczos_block, info=info,
            )
            self.lanczos_steps_taken_ = info.get("steps")
        self._fitted_transform = T
        # host seconds of the column statistics; the engine build and the
        # solve are the spans "pca.engine" and "gram.solve" / "svd.randomized"
        self._fit_timings = dict(stats=t_stats)
        self.components_ = vt  # k x n_features
        self._set_fit_state(s_dev, total_var, n_samples, min(n_samples, n_features))
        if self.verbose:
            self._print_fit(op, n_samples, n_cols, n_features, t0)
        return self

    @precision_policy()
    def fit_transform(self, x) -> torch.Tensor:
        m = _as_matrix(x)  # convert once; fit and transform share layouts
        self._want_transform = True
        try:
            self.fit(m)
        finally:
            self._want_transform = False
        T = self._fitted_transform
        self._fitted_transform = None
        return T

    # -- model state -----------------------------------------------------

    def _set_fit_state(self, s_dev, total_var, n_samples, min_dim) -> None:
        self._s_dev = s_dev
        self._ev_np = None
        self._total_var = total_var  # None when center=False -> lazy sum
        self._noise_var = None
        self._fit_n_samples = n_samples
        self._fit_min_dim = min_dim

    def _finalize_ev(self) -> None:
        if self._ev_np is not None or self._s_dev is None:
            return
        s_np = self._s_dev.cpu().numpy().astype(np.float64)
        self._s_dev = None
        n_minus_1 = max((self._fit_n_samples or 1) - 1, 1)
        ev64 = s_np**2 / n_minus_1
        dt = (
            _np_dtype(self.components_.dtype)
            if self.components_ is not None
            else np.float32
        )
        self._ev_np = ev64.astype(dt)
        if self._total_var is None:  # center=False: total = sum of EVs
            self._total_var = float(ev64.sum())
        k, min_dim = self.n_components, self._fit_min_dim or 0
        if k < min_dim:
            self._noise_var = (self._total_var - float(ev64.sum())) / (min_dim - k)
        else:
            self._noise_var = 0.0

    @property
    def explained_variance_(self) -> Optional[np.ndarray]:
        self._finalize_ev()
        return self._ev_np

    @explained_variance_.setter
    def explained_variance_(self, v) -> None:
        self._ev_np = None if v is None else np.asarray(v)
        self._s_dev = None

    @property
    def total_variance_(self) -> Optional[float]:
        self._finalize_ev()
        return self._total_var

    @total_variance_.setter
    def total_variance_(self, v) -> None:
        self._total_var = v

    @property
    def noise_variance_(self) -> Optional[float]:
        self._finalize_ev()
        return self._noise_var

    @noise_variance_.setter
    def noise_variance_(self, v) -> None:
        self._noise_var = v

    @property
    def mean_(self) -> Optional[np.ndarray]:
        return self._mean_np

    @mean_.setter
    def mean_(self, v) -> None:
        self._mean_np = None if v is None else np.asarray(v)
        self._mean_dev = None

    def _mean_device(self) -> torch.Tensor:
        """``mean_`` on the components' device (cached)."""

        if self._mean_dev is None:
            self._mean_dev = torch.as_tensor(
                self._mean_np, device=self.components_.device
            )
        return self._mean_dev

    # -- analysis ------------------------------------------------------

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

    # -- persistence: the JAX package's .npz format -----------------------

    def save(self, path: str) -> None:
        np.savez(
            path,
            components=self.components_.cpu().numpy(),
            explained_variance=np.asarray(self.explained_variance_),
            mean=np.asarray(self.mean_),
            meta=np.array(
                [
                    self.n_components,
                    int(self.center),
                    self.random_seed,
                    self.total_variance_ or 0.0,
                    self.noise_variance_ or 0.0,
                ],
                dtype=np.float64,
            ),
            **self._saved_extra(),
        )

    def _saved_extra(self) -> dict:
        """Arrays a subclass saves beside the common ones."""

        return {}

    @classmethod
    def load(cls, path: str, device="cuda"):
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"  # np.savez appends the suffix; np.load does not
        with np.load(path) as z:
            meta = z["meta"]
            obj = cls._loaded(z, n_components=int(meta[0]), center=bool(meta[1]),
                              random_seed=int(meta[2]))
            obj.components_ = torch.as_tensor(np.array(z["components"]), device=device)
            obj.explained_variance_ = np.array(z["explained_variance"])
            obj.mean_ = np.array(z["mean"])
            obj.total_variance_ = float(meta[3])
            obj.noise_variance_ = float(meta[4])
        return obj

    @classmethod
    def _loaded(cls, z, **kw):
        """The unfitted model that ``load`` fills from the open ``.npz``."""

        return cls(**kw)


def _np_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


class SparsePCA(_LazyPCAState):
    """PCA on sparse matrices (samples x features).

    State after ``fit``: ``components_`` (k x p, on the matrix's device),
    ``explained_variance_`` (k), ``mean_`` (p).
    """

    def _print_fit(self, op, n_samples, n_features, n_fit, t0) -> None:
        sm, k = self.svd_method, self.n_components
        if isinstance(op, GramPCAEngine) and op.p_padded > EIGH_MAX_PP and sm.is_random:
            os_floor = min(k + 14, max(op.p_padded - k, 0))
            print(
                "Large-Gram randomized solve: oversamples/power-iterations "
                f"are treated as minimums (oversamples >= {os_floor}, q >= 8; "
                f"requested {sm.n_oversamples}/{sm.n_power_iterations})"
            )
        name = "randomized" if sm.is_random else "Lanczos"
        print(f"SVD using {name} algorithm ({type(op).__name__}):")
        print(f"  Input shape: {n_samples} samples x {n_features} features")
        print(f"  Reduced to: {k} components")
        print(f"  Estimated noise variance: {self.noise_variance_}")
        print(f"  Fit took {time.perf_counter() - t0:.3f}s")

    # -- inference -----------------------------------------------------

    def _operator_for_transform(self, m):
        """Any cached operator projects; never build a fresh Gram engine
        just for a projection."""

        cache = m._operator_cache
        if self.engine == "auto" and cache:
            return cache.get("auto") or next(iter(cache.values()))
        return make_engine_operator(m, self.engine)

    @precision_policy()
    def transform(self, x) -> torch.Tensor:
        self._check_fitted()
        m = _as_matrix(x, self.components_.device)
        op = self._operator_for_transform(m)
        if self.center:
            op = CenteredOperator(op, self._mean_device())
        return _project(op, self.components_.T)

    @precision_policy()
    def inverse_transform(self, T) -> torch.Tensor:
        """``T @ components_`` (+ ``mean_`` when centered)."""

        self._check_fitted()
        T = torch.as_tensor(T, device=self.components_.device)
        R = T @ self.components_
        if self.center:
            R = R + self._mean_device()
        return R

    # -- state -----------------------------------------------------------

    @classmethod
    def from_state(
        cls, state: dict, *, center: bool = True, random_seed: int = 42,
        device="cuda",
    ) -> "SparsePCA":
        """A fitted model from numpy state: ``components`` (k x p),
        ``explained_variance``, ``mean``, ``total_variance`` and
        ``noise_variance`` (e.g. a JAX ``SparsePCA``'s fields)."""

        comps = np.array(state["components"])  # a writable copy
        obj = cls(n_components=comps.shape[0], center=center, random_seed=random_seed)
        obj.components_ = torch.as_tensor(comps, device=device)
        obj.explained_variance_ = np.asarray(state["explained_variance"])
        obj.mean_ = np.asarray(state["mean"])
        obj.total_variance_ = float(state["total_variance"])
        obj.noise_variance_ = float(state["noise_variance"])
        return obj


@dataclasses.dataclass
class _PCABuilder:
    """The fluent setters both PCA builders share, with the reference's
    defaults."""

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

    def lanczos_block(self, b: int | None) -> Self:
        self._lanczos_block = b
        return self

    def lanczos_steps(self, n: int) -> Self:
        self._lanczos_steps = n
        return self

    def engine(self, e: str) -> Self:
        """Compute engine: 'auto', 'dense', 'gram', 'tiled' or 'sparse'."""

        self._engine = e
        return self

    def n_components(self, n: int) -> Self:
        self._n_components = n
        return self

    def alpha(self, a: float) -> Self:
        self._alpha = a
        return self

    def tolerance(self, t: float) -> Self:
        self._tolerance = t
        return self

    def random_seed(self, s: int) -> Self:
        self._random_seed = s
        return self

    def center(self, c: bool) -> Self:
        self._center = c
        return self

    def verbose(self, v: bool) -> Self:
        self._verbose = v
        return self

    def svd_method(self, m: SVDMethod) -> Self:
        self._svd_method = m
        return self

    def _params(self) -> dict:
        """The ten shared constructor arguments."""

        return {f.name[1:]: getattr(self, f.name) for f in dataclasses.fields(_PCABuilder)}


@dataclasses.dataclass
class SparsePCABuilder(_PCABuilder):
    """Fluent builder with the reference's defaults."""

    def build(self) -> SparsePCA:
        return SparsePCA(**self._params())
