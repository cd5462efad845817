"""Block Golub-Kahan-Lanczos bidiagonalization: the GEMM-shaped Lanczos.

Counterpart of ``single_algebra_tpu/linalg/block_lanczos.py``. The scalar
recurrence in :mod:`.lanczos` advances the Krylov space one vector at a
time: every step is two products with a single operand column plus the
reorthogonalization, strictly in sequence. The block variant advances
``b`` vectors per step:

* each step's products are ``A @ [p, b]`` / ``A^T @ [n, b]``, which
  amortize one pass over the matrix across b Krylov directions;
* the sequential depth for the same Krylov dimension drops b-fold;
* clustered singular values (common in scRNA spectra) are resolved
  together instead of one per step.

Recurrence (block GKL with full reorthogonalization):

    U_j R_j = A V_j - U_{j-1} L_{j-1}^T     (QR, [n, b])
    V_{j+1} L_j = A^T U_j - V_j R_j^T       (QR, [p, b])

giving ``A [V_1..V_m] = [U_1..U_m] B`` with upper block-bidiagonal ``B``
(``B[j,j] = R_j``, ``B[j,j+1] = L_j^T``); the small SVD of B yields the
Ritz triplets exactly as in the scalar case.

Same semantics as :func:`~.lanczos.lanczos_svd` (raw operator, no
centering) and the same two modes; the adaptive mode checks the Ritz
values after every block step, as the JAX package does (one small SVD and
one host synchronization per block step). ``V1`` ([p, b], orthonormal
columns) replaces the seeded start block, for parity tests.
"""

from __future__ import annotations

import torch

from .lanczos import _pad_to
from .svd import _CHOLQR_MIN_ROWS, SvdResult, _cholesky_qr2_with_r

__all__ = ["block_lanczos_svd"]


def _qr_tall(X: torch.Tensor):
    """(Q, R) for a tall-skinny block: CholeskyQR2 on big float32 blocks
    (two Gram GEMMs), Householder otherwise."""

    if X.shape[0] >= _CHOLQR_MIN_ROWS and X.dtype == torch.float32:
        return _cholesky_qr2_with_r(X)
    return torch.linalg.qr(X)


def _reorth(basis: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Two passes of block classical Gram-Schmidt against the filled rows."""

    if basis.shape[0] == 0:
        return X
    for _ in range(2):
        X = X - basis.T @ (basis @ X)
    return X


def block_lanczos_svd(
    op,
    n_components: int,
    block_size: int = 8,
    steps: int | None = None,
    seed: int = 42,
    tol: float | None = None,
    *,
    V1: torch.Tensor | None = None,
    info: dict | None = None,
) -> SvdResult:
    """Truncated SVD of ``op`` via block Golub-Kahan bidiagonalization.

    ``steps`` counts BLOCK steps; the Krylov dimension is ``steps *
    block_size``. The default budget matches the scalar path's Krylov
    dimension (``max(8k, 128)``, adaptive: ``max(16k, 384)``). ``info``,
    when given, receives ``steps`` (the block steps taken).
    """

    n, p = op.shape
    k = n_components
    # a block wider than the operator would make the panel QRs rank-deficient
    b = max(min(block_size, min(n, p)), 1)
    if steps is None:
        kdim = max(16 * k, 384) if tol is not None else max(8 * k, 128)
        steps = max(-(-min(kdim, min(n, p)) // b), 2)
    # past ceil(min(n, p) / b) block steps the Krylov space is exhausted:
    # the next panel QR would factor a residual of rounding noise into
    # spurious directions (the JAX package then returns NaN eigenvalues)
    m = min(steps, -(-min(n, p) // b))
    dtype, device = op.dtype, op.device
    eps = float(torch.finfo(dtype).tiny) * 1e8
    op_mv = getattr(op, "mv_precise", op.mv)
    op_rmv = getattr(op, "rmv_precise", op.rmv)

    if V1 is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        V1 = torch.linalg.qr(
            torch.randn((p, b), generator=gen, dtype=dtype, device=device)
        )[0]
    elif tuple(V1.shape) != (p, b):
        raise ValueError(f"V1 must be [{p}, {b}], got {tuple(V1.shape)}")
    v_cur = V1.to(dtype)

    # stacked Krylov bases [m*b, n] / [m*b, p]; unfilled rows zero. B is
    # assembled from the per-step diagonal (R_j) and coupling (L_j) blocks
    U = torch.zeros((m * b, n), dtype=dtype, device=device)
    V = torch.zeros((m * b, p), dtype=dtype, device=device)
    Rs = torch.zeros((m, b, b), dtype=dtype, device=device)
    Ls = torch.zeros((m, b, b), dtype=dtype, device=device)
    u_prev = torch.zeros((n, b), dtype=dtype, device=device)
    L_prev = torch.zeros((b, b), dtype=dtype, device=device)

    def assemble_B(size: int) -> torch.Tensor:
        """The leading ``size`` block rows and columns of B, in float64
        (the small SVDs run there, see :mod:`.lanczos`): the filled
        steps plus, after an early stop, the last coupling block beside a
        zero block row of V (the zero-padded B's top-left corner)."""

        B = torch.zeros((size * b, size * b), dtype=torch.float64, device=device)
        for j in range(size):
            B[j * b:(j + 1) * b, j * b:(j + 1) * b] = Rs[j]
            if j + 1 < size:
                B[j * b:(j + 1) * b, (j + 1) * b:(j + 2) * b] = Ls[j].T
        return B

    filled, s_prev = 0, None
    for j in range(m):
        V[j * b:(j + 1) * b] = v_cur.T
        Au = op_mv(v_cur) - u_prev @ L_prev.T
        Au = _reorth(U[: j * b], Au)
        u, R = _qr_tall(Au)
        U[j * b:(j + 1) * b] = u.T
        Rs[j] = R

        W = op_rmv(u) - v_cur @ R.T
        W = _reorth(V[: (j + 1) * b], W)
        v_cur, L = _qr_tall(W)
        Ls[j] = L
        u_prev, L_prev = u, L
        filled = j + 1
        if tol is None:
            continue
        s_now = _pad_to(torch.linalg.svdvals(assemble_B(min(filled + 1, m))), k)
        exhausted = torch.linalg.norm(L) <= eps
        if s_prev is not None:
            moved = (s_now - s_prev).abs().max() / torch.clamp(s_now[0], min=eps)
            if bool((moved < tol) | exhausted):  # the step's host sync
                break
        elif bool(exhausted):
            break
        s_prev = s_now

    size = min(filled + 1, m)
    pb, s, qtb = torch.linalg.svd(assemble_B(size))
    u_full = U[: size * b].T @ _pad_to(pb, k).to(dtype)
    v_full = V[: size * b].T @ _pad_to(qtb.T, k).to(dtype)
    if info is not None:
        info["steps"] = filled
    return SvdResult(u=u_full, s=_pad_to(s, k).to(dtype), vt=v_full.T)
