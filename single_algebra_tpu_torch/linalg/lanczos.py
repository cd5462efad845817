"""Golub-Kahan-Lanczos truncated SVD over the operator seam.

Counterpart of ``single_algebra_tpu/linalg/lanczos.py``: Golub-Kahan
bidiagonalization with FULL two-pass reorthogonalization, then the SVD of
the small bidiagonal for the Ritz triplets. A Python loop over steps with
preallocated Krylov buffers takes the place of the JAX package's
``fori_loop``/``while_loop``; each step is eager tensor code, with no
host synchronization inside it.

Two modes, as there:

* **fixed depth** (``tol=None``): exactly ``steps`` iterations.
* **convergence-adaptive** (``tol`` set): blocks of ``check_every`` steps;
  after each block the Ritz values (singular values of the accumulated
  bidiagonal) are recomputed, and the loop stops once the top-k values
  moved by less than ``tol`` relative to the largest, or the Krylov space
  is exhausted (``beta <= eps``). That check is one small SVD and the
  loop's only host synchronization, once per block of steps.

The small SVDs run in float64 (on the operator's device) whatever the
operator's dtype: cuSOLVER's float32 SVD leaves more noise in the Ritz
values of an 800-step bidiagonal than ``SparsePCABuilder``'s default tolerance of
1e-6, so a float32 check could never stop the loop; the Krylov bases and
every large product stay in the operator's dtype.

Semantics kept from the JAX package: the solver runs on the RAW operator
handed to it (the caller decides about centering; the PCA never centers
the Lanczos path), it uses ``mv_precise``/``rmv_precise`` where the
operator has them (the recurrence is sensitive to product error), and the
unfilled rows of the Krylov buffers stay zero: after an early stop the
bidiagonal keeps the last coupling ``beta`` beside a zero row of ``V``,
exactly as the zero-padded bidiagonal of the JAX package does.

Randomness: ``jax.random`` and torch draw different streams from one
seed, so :func:`lanczos_svd` takes an optional start vector ``v0``.
Without it, ``v0`` comes from a ``torch.Generator`` on the operator's
device seeded with ``seed``; parity tests pass the JAX package's own.
"""

from __future__ import annotations

import torch

from .svd import SvdResult

__all__ = ["lanczos_svd", "default_lanczos_steps", "max_lanczos_steps"]


def default_lanczos_steps(n: int, p: int, k: int) -> int:
    """Fixed-depth budget: enough Krylov depth for the top-k triplets on
    gapped (real-data) spectra (~2k steps suffice; 8k is the safe
    default)."""

    return int(min(min(n, p), max(8 * k, 128)))


def max_lanczos_steps(n: int, p: int, k: int) -> int:
    """Adaptive-mode budget: deep enough that flat noise bulks, the worst
    case, converge without hand-tuning; capped by a multiple of k because
    a full-width buffer is prohibitive at a million rows."""

    return int(min(min(n, p), max(16 * k, 384)))


def _reorth(basis: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Two passes of classical Gram-Schmidt of ``x`` against the rows of
    ``basis`` (the filled rows only: the others are zero)."""

    if basis.shape[0] == 0:
        return x
    for _ in range(2):
        x = x - basis.T @ (basis @ x)
    return x


def _inv_or_zero(a: torch.Tensor, eps: float) -> torch.Tensor:
    """1 / a, or 0 where ``a <= eps`` (a breakdown ends the recurrence
    with zero vectors instead of dividing by ~0); no host sync."""

    return torch.where(a > eps, 1.0 / torch.clamp(a, min=eps), torch.zeros_like(a))


def _pad_to(s: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` entries of the last axis, zero-padded to ``k`` when
    there are fewer (``k`` > min(n, p): the surplus components are 0, as
    the Gram engine returns them)."""

    if s.shape[-1] >= k:
        return s[..., :k]
    return torch.nn.functional.pad(s, (0, k - s.shape[-1]))


def lanczos_svd(
    op,
    n_components: int,
    steps: int | None = None,
    seed: int = 42,
    tol: float | None = None,
    check_every: int | None = None,
    *,
    v0: torch.Tensor | None = None,
    info: dict | None = None,
) -> SvdResult:
    """Truncated SVD of ``op`` via Golub-Kahan bidiagonalization.

    ``op`` needs ``mv``/``rmv``/``shape``/``dtype``/``device``. ``steps``
    is the Krylov budget; when None it is derived from the shape and k (a
    larger budget in adaptive mode, since the loop exits once converged).
    ``tol`` enables the adaptive mode. ``v0`` ([p]) replaces the seeded
    Gaussian start vector; ``info``, when given, receives ``steps`` (the
    steps taken).
    """

    n, p = op.shape
    k = n_components
    if steps is None:
        steps = (
            max_lanczos_steps(n, p, k) if tol is not None
            else default_lanczos_steps(n, p, k)
        )
    m = min(steps, min(n, p))  # no Krylov direction is left past min(n, p)
    if check_every is None:
        check_every = max(k, 32)
    check_every = min(check_every, m)
    dtype, device = op.dtype, op.device
    eps = float(torch.finfo(dtype).tiny) * 1e8

    op_mv = getattr(op, "mv_precise", op.mv)
    op_rmv = getattr(op, "rmv_precise", op.rmv)

    if v0 is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        v0 = torch.randn(p, generator=gen, dtype=dtype, device=device)
    elif tuple(v0.shape) != (p,):
        raise ValueError(f"v0 must be [{p}], got {tuple(v0.shape)}")
    v_cur = (v0 / torch.linalg.norm(v0)).to(dtype)

    # Krylov bases as fixed buffers; unfilled rows are zero
    U = torch.zeros((m, n), dtype=dtype, device=device)
    V = torch.zeros((m, p), dtype=dtype, device=device)
    alphas = torch.zeros(m, dtype=dtype, device=device)
    betas = torch.zeros(m, dtype=dtype, device=device)  # betas[j] couples v_{j+1}
    u_prev = torch.zeros(n, dtype=dtype, device=device)
    beta_prev = torch.zeros((), dtype=dtype, device=device)

    def bidiagonal(size: int) -> torch.Tensor:
        # upper bidiagonal: A V = U B with B[j, j] = alpha_j, B[j, j+1] = beta_j
        a, b = alphas[:size].double(), betas[: size - 1].double()
        return torch.diag(a) + torch.diag(b, diagonal=1)

    filled, s_prev = 0, None
    while filled < m:
        stop = min(filled + check_every, m) if tol is not None else m
        for j in range(filled, stop):
            V[j] = v_cur
            u = op_mv(v_cur[:, None])[:, 0] - beta_prev * u_prev
            u = _reorth(U[:j], u)
            alpha = torch.linalg.norm(u)
            u = u * _inv_or_zero(alpha, eps)
            U[j] = u
            alphas[j] = alpha

            w = op_rmv(u[:, None])[:, 0] - alpha * v_cur
            w = _reorth(V[: j + 1], w)
            beta = torch.linalg.norm(w)
            v_cur = w * _inv_or_zero(beta, eps)
            betas[j] = beta
            u_prev, beta_prev = u, beta
        filled = stop
        if tol is None:
            break
        # Ritz values of the filled block with its last coupling (the
        # zero-padded bidiagonal's top values)
        s_now = _pad_to(
            torch.linalg.svdvals(bidiagonal(min(filled + 1, m))), k
        )
        if s_prev is not None:
            moved = (s_now - s_prev).abs().max() / torch.clamp(s_now[0], min=eps)
            if bool((moved < tol) | (beta_prev <= eps)):  # the block's host sync
                break
        elif bool(beta_prev <= eps):
            break
        s_prev = s_now

    size = min(filled + 1, m)
    pb, s, qtb = torch.linalg.svd(bidiagonal(size))
    u_full = U[:size].T @ _pad_to(pb, k).to(dtype)  # [n, k]
    v_full = V[:size].T @ _pad_to(qtb.T, k).to(dtype)  # [p, k]
    if info is not None:
        info["steps"] = filled
    return SvdResult(u=u_full, s=_pad_to(s, k).to(dtype), vt=v_full.T)
