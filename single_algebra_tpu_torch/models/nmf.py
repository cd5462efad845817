"""Non-negative matrix factorization: the gene-program (cNMF) model.

Counterpart of ``single_algebra_tpu/models/nmf.py``. X ~= W H with W
``[n, k] >= 0`` (cell usages) and H ``[k, p] >= 0`` (gene programs),
Frobenius loss, solved with multiplicative updates (Lee & Seung 2000;
sklearn ``NMF(solver='mu')`` semantics). Every update is two products
with X (``X @ H^T`` / ``X^T @ W``) plus ``[k, k]`` Gram products; the
loss is tracked without a dense residual, as ``||X||^2 - 2 <W^T X, H> +
tr((W^T W)(H H^T))``. The JAX package runs the loop as one
``lax.while_loop``; here a Python loop runs it, with one scalar pull per
iteration (sklearn's stopping rule).

The engine is the JAX package's TPU choice with the card in the TPU's
place: on a CUDA float32 matrix whose dense form fits, the densified
engine's compensated products (``mv_precise`` / ``rmv_precise``; its
payload is ``make_engine_operator(m, "dense")``, so the NNDSVD init's
``'auto'`` engine is the same payload, not a second copy); otherwise the
gather engine over the row and column layouts; with ``mesh=`` the
row-sharded ``ShardedSpMM``.

NNDSVD(a) initialization rides the port's randomized SVD (a
``torch.Generator`` sketch; the tests pass the JAX package's). The
'random' init draws from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import precision_policy

__all__ = ["NMF"]

_EPS = 1e-12


def _loss_from_xht(x_sq, W, H, XHt):
    """``||X - W H||^2`` from ``X H^T`` (the product the W update already
    ran): ``x_sq - 2 <W, X H^T> + <W^T W, H H^T>``."""

    return x_sq - 2.0 * (W * XHt).sum() + ((W.T @ W) * (H @ H.T)).sum()


def _mu_loop(op, W0, H0, x_sq, tol: float, max_iter: int):
    """Multiplicative-update loop over any mv / rmv operator (the compensated
    products where the operator has them: MU tolerates small product error,
    but they keep sklearn's loss parity tight). Returns ``(W, H, loss,
    n_iter)``; ``x_sq`` is ``||X||^2`` as a 0-d tensor."""

    op_mv = getattr(op, "mv_precise", op.mv)
    op_rmv = getattr(op, "rmv_precise", op.rmv)
    W, H = W0, H0
    cur = _loss_from_xht(x_sq, W, H, op_mv(H.T))
    drop = torch.full_like(cur, float("inf"))
    bar = tol * torch.clamp(x_sq, min=_EPS)
    it = 0
    # sklearn 'mu' stopping rule: the loss drop against tol x ||X||^2
    while it < max_iter and (it < 2 or bool(drop > bar)):
        num_h = op_rmv(W).T  # [k, p]
        H = H * num_h / torch.clamp((W.T @ W) @ H, min=_EPS)
        num_w = op_mv(H.T)  # [n, k]
        W = W * num_w / torch.clamp(W @ (H @ H.T), min=_EPS)
        new = _loss_from_xht(x_sq, W, H, num_w)
        cur, drop, it = new, cur - new, it + 1
    return W, H, cur, it


def _nndsvd(u: np.ndarray, s: np.ndarray, vt: np.ndarray, fill: Optional[float]):
    """NNDSVD (Boutsidis & Gallopoulos 2008) from a truncated SVD
    (float64 host arrays) -> ``(W [n, k], H [k, p])``; exact zeros become
    ``fill`` ('nndsvda': the data mean) or ``_EPS`` ('nndsvd': exact zeros
    stall multiplicative updates)."""

    n, k = u.shape
    p = vt.shape[1]
    W = np.zeros((n, k))
    H = np.zeros((k, p))
    W[:, 0] = np.sqrt(s[0]) * np.abs(u[:, 0])
    H[0] = np.sqrt(s[0]) * np.abs(vt[0])
    for j in range(1, k):
        x, y = u[:, j], vt[j]
        xp, xn = np.maximum(x, 0), np.maximum(-x, 0)
        yp, yn = np.maximum(y, 0), np.maximum(-y, 0)
        npos = np.linalg.norm(xp) * np.linalg.norm(yp)
        nneg = np.linalg.norm(xn) * np.linalg.norm(yn)
        if npos >= nneg:
            norm, xu, yv = npos, xp, yp
        else:
            norm, xu, yv = nneg, xn, yn
        xu_n, yv_n = np.linalg.norm(xu), np.linalg.norm(yv)
        if xu_n * yv_n > 0:
            W[:, j] = np.sqrt(s[j] * norm) * xu / xu_n
            H[j] = np.sqrt(s[j] * norm) * yv / yv_n
    fill = _EPS if fill is None else fill
    W[W == 0] = fill
    H[H == 0] = fill
    return W, H


def _mean(m) -> float:
    n, p = m.shape
    return float(m.sum_row().double().sum()) / (n * p)


def _x_sq(m, dt):
    return torch.tensor(float(m.sum_row_squared().double().sum()), dtype=dt, device=m.device)


class NMF:
    """sklearn-style NMF over a sparse cells x genes matrix.

    ``init``: 'nndsvda' (default: NNDSVD with zeros filled by the data
    mean, sklearn's default for dense-ish problems; deterministic),
    'nndsvd' (zeros stay ~zero), or 'random' (seeded scaled uniform).
    After ``fit`` / ``fit_transform``: ``components_`` ``[k, p]``,
    ``reconstruction_err_`` (Frobenius), ``n_iter_``, and ``engine_``
    (the operator class the products ran on).

    ``mesh``: a ``parallel.Mesh`` row-shards X (``ShardedSpMM``): every MU
    product becomes a slab product per entry, ``X^T W`` one reduction,
    and the NNDSVD init's randomized SVD runs over the same operator. The
    fit runs on the matrix's device (the mesh's home device with
    ``mesh``).
    """

    def __init__(
        self,
        n_components: int,
        *,
        init: str = "nndsvda",
        max_iter: int = 200,
        tol: float = 1e-4,
        seed: int = 42,
        mesh=None,
    ):
        if n_components < 1:
            raise ValueError(f"n_components={n_components} must be >= 1")
        if init not in ("nndsvd", "nndsvda", "random"):
            raise ValueError(f"unknown init {init!r}")
        if max_iter < 1:
            raise ValueError(f"max_iter={max_iter} must be >= 1")
        self.n_components = int(n_components)
        self.init = init
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.seed = int(seed)
        self.mesh = mesh
        self.components_: Optional[np.ndarray] = None
        self.reconstruction_err_: Optional[float] = None
        self.n_iter_: Optional[int] = None
        self.engine_: Optional[str] = None

    # -- initialization ------------------------------------------------

    def _init_wh(self, m, dt, op=None):
        n, p = m.shape
        k = self.n_components
        dev = op.device if op is not None else m.device
        if self.init == "random":
            # sklearn scaling: sqrt(mean(X) / k)
            scale = float(np.sqrt(max(_mean(m), _EPS) / k))
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.seed)
            W = scale * torch.rand((n, k), generator=gen, dtype=dt, device=dev)
            H = scale * torch.rand((k, p), generator=gen, dtype=dt, device=dev)
            return W, H

        from ..linalg import randomized_svd

        if op is None:
            from .pca import make_engine_operator

            op = make_engine_operator(m, "auto")
        res = randomized_svd(op, k, n_oversamples=10, n_power_iterations=7, seed=self.seed)
        to64 = lambda t: t.detach().cpu().numpy().astype(np.float64)
        W, H = _nndsvd(to64(res.u), to64(res.s), to64(res.vt),
                       _mean(m) if self.init == "nndsvda" else None)
        return (torch.as_tensor(W, dtype=dt, device=dev),
                torch.as_tensor(H, dtype=dt, device=dev))

    def _operator(self, m):
        """The MU products' engine (see the module docstring)."""

        if self.mesh is not None:
            from ..parallel import ShardedSpMM

            return ShardedSpMM.from_matrix(m, self.mesh)
        from ..linalg.operators import DensifiedOperator
        from .pca import _needs_lo, make_engine_operator

        if (m.device.type == "cuda" and m.dtype == torch.float32
                and DensifiedOperator.fits(m.shape, needs_lo=_needs_lo(m), device=m.device)):
            # MU runs ~4 wide products an iteration: the densified payload
            # runs each as bf16 GEMMs, where the gather engine runs batched
            # micro-products (ROADMAP Queue 2)
            return make_engine_operator(m, "dense")
        return make_engine_operator(m, "sparse")

    # -- fitting ---------------------------------------------------------

    @precision_policy()
    def fit_transform(self, m) -> np.ndarray:
        """Fit on a ``SparseMatrix`` and return W ``[n, k]`` (cell usages)."""

        from ..sparse.matrix import SparseMatrix

        if not isinstance(m, SparseMatrix):
            raise TypeError("NMF.fit_transform expects a SparseMatrix")
        n, p = m.shape
        if self.n_components > min(n, p):
            raise ValueError(f"n_components={self.n_components} > min{m.shape}")
        if m.nnz and float(m.min_max_col()[0].min()) < 0:
            raise ValueError("NMF requires non-negative data")
        dt = m.dtype
        op = self._operator(m)
        self.engine_ = type(op).__name__
        W0, H0 = self._init_wh(m, dt, op if self.mesh is not None else None)
        x_sq = _x_sq(m, dt).to(op.device)
        W, H, final, n_iter = _mu_loop(op, W0, H0, x_sq, self.tol, self.max_iter)
        self.components_ = H.cpu().numpy()
        self.reconstruction_err_ = float(np.sqrt(max(float(final), 0.0)))
        self.n_iter_ = int(n_iter)
        return W.cpu().numpy()

    def fit(self, m) -> "NMF":
        self.fit_transform(m)
        return self

    @precision_policy()
    def transform(self, m, *, max_iter: int = 500) -> np.ndarray:
        """Usages of NEW cells under the fitted programs: MU iterations on
        W with H held fixed, until the loss improvement falls under the
        model's ``tol`` (the same stopping rule as ``fit``)."""

        if self.components_ is None:
            raise ValueError("NMF is not fitted")
        from ..sparse.matrix import SparseMatrix

        if not isinstance(m, SparseMatrix):
            raise TypeError("NMF.transform expects a SparseMatrix")
        if m.ncols != self.components_.shape[1]:
            raise ValueError(
                f"matrix has {m.ncols} columns, model fitted on {self.components_.shape[1]}")
        dt, dev = m.dtype, m.device
        H = torch.as_tensor(self.components_, dtype=dt, device=dev)
        HHt = H @ H.T
        XHt = m.matmul_dense(H.T)  # [n, k]
        x_sq = _x_sq(m, dt)

        def loss(W):
            return x_sq - 2.0 * (W * XHt).sum() + ((W.T @ W) * HHt).sum()

        W = torch.full((m.nrows, self.n_components),
                       float(np.sqrt(max(_mean(m), _EPS) / self.n_components)),
                       dtype=dt, device=dev)
        cur = loss(W)
        drop = torch.full_like(cur, float("inf"))
        bar = self.tol * torch.clamp(x_sq, min=_EPS)
        it = 0
        while it < int(max_iter) and (it < 2 or bool(drop > bar)):
            W = W * XHt / torch.clamp(W @ HHt, min=_EPS)
            new = loss(W)
            cur, drop, it = new, cur - new, it + 1
        return W.cpu().numpy()
