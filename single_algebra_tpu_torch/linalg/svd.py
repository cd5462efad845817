"""Randomized truncated SVD and the deterministic sign convention.

Counterpart of ``single_algebra_tpu/linalg/svd.py``: Halko-Martinsson-Tropp
range finding with oversampling and normalized power iterations over the
operator seam (``mv``/``rmv``/``shape``/``dtype``/``device``), CholeskyQR2 for tall
bases, and sklearn's ``svd_flip``. Factorizations go to ``torch.linalg``
(cuSOLVER/cuBLAS on the card), as the JAX package left them to XLA.

Accuracy classes: the power iterations ride the operator's ``mv_fast`` /
``rmv_fast`` products and the final ``Bt = A^T Q`` its ``rmv_precise``,
each falling back to ``mv`` / ``rmv`` where the operator has no such
product, as in the JAX package.

Randomness: ``jax.random`` and torch draw different streams from one
seed, so :func:`randomized_svd` takes an optional ``omega`` (the Gaussian
test matrix). Without it, ``omega`` comes from a ``torch.Generator`` on
the operator's device seeded with ``seed``; parity tests pass the JAX
package's own ``omega`` so both solves see the same sketch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import PowerIterationNormalizer
from ..utils.tracing import span

__all__ = ["SvdResult", "randomized_svd", "svd_flip", "cholesky_qr2", "gaussian_sketch"]

# Householder QR beats CholeskyQR2's extra Gram passes below this many rows
_CHOLQR_MIN_ROWS = 16384


class SvdResult(NamedTuple):
    u: torch.Tensor  # [n, k]
    s: torch.Tensor  # [k]
    vt: torch.Tensor  # [k, p]


def _cholqr_round(Y: torch.Tensor, shift: bool):
    """One CholeskyQR round -> (Q, R). The shifted round adds
    ``eps32 * tr(G) * 11 (m + l + 1)`` to the diagonal so the Cholesky
    factorization stays positive-definite for ill-conditioned ``Y``."""

    g = Y.T @ Y
    if shift:
        l = g.shape[0]
        s = (
            torch.finfo(torch.float32).eps
            * torch.trace(g)
            * float(11 * (Y.shape[0] + l + 1))
        )
        g = g + s * torch.eye(l, dtype=g.dtype, device=g.device)
    r = torch.linalg.cholesky(g, upper=True)
    return torch.linalg.solve_triangular(r, Y, upper=True, left=False), r


def _colnorm_rescale(Q: torch.Tensor):
    """(Q with exactly-unit column norms, the norms it had): elementwise
    square-and-sum. The JAX package's ``_vpu_colnorm_rescale`` needs it
    on the TPU, whose self-Gram under-measures the diagonal; kept so both
    packages finish the basis the same way."""

    nrm = torch.sqrt(torch.clamp((Q * Q).sum(dim=0), min=1e-30))
    return Q * (1.0 / nrm)[None, :], nrm


def cholesky_qr2(Y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of range(Y) via a shifted then an unshifted
    CholeskyQR round, with exactly-unit column norms."""

    q1, _ = _cholqr_round(Y, True)
    q2, _ = _cholqr_round(q1, False)
    return _colnorm_rescale(q2)[0]


def _cholesky_qr2_with_r(Y: torch.Tensor):
    """(Q, R) with Q orthonormal via two Gram rounds, R = diag(norms) R2 R1
    so that Q R == Y still holds after the column-norm rescale."""

    q1, r1 = _cholqr_round(Y, True)
    q2, r2 = _cholqr_round(q1, False)
    qs, nrm = _colnorm_rescale(q2)
    return qs, nrm[:, None] * (r2 @ r1)


def _orthonormalize(Y: torch.Tensor, normalizer: PowerIterationNormalizer):
    if normalizer == PowerIterationNormalizer.QR:
        return _final_basis(Y)
    if normalizer == PowerIterationNormalizer.LU:
        with span("svd.orthonormalize", rows=Y.shape[0]):
            P, L, _ = torch.linalg.lu(Y)
            return P @ L
    return Y


def _final_basis(Y: torch.Tensor) -> torch.Tensor:
    with span("svd.orthonormalize", rows=Y.shape[0]):
        if Y.shape[0] >= _CHOLQR_MIN_ROWS and Y.dtype == torch.float32:
            return cholesky_qr2(Y)
        return torch.linalg.qr(Y)[0]


def gaussian_sketch(p: int, l: int, seed: int, *, dtype, device) -> torch.Tensor:
    """The default ``omega``: standard normal [p, l] from a generator on
    ``device`` seeded with ``seed``."""

    with span("svd.sketch"):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return torch.randn((p, l), generator=gen, dtype=dtype, device=device)


def randomized_svd(
    op,
    n_components: int,
    n_oversamples: int = 10,
    n_power_iterations: int = 7,
    normalizer: PowerIterationNormalizer = PowerIterationNormalizer.QR,
    seed: int = 42,
    omega: torch.Tensor | None = None,
) -> SvdResult:
    """Truncated SVD of ``op`` with ``l = min(k + oversamples, n, p)``
    sketch columns. ``omega`` ([p, l]) replaces the seeded Gaussian draw.
    Centering is a :class:`CenteredOperator` around ``op``."""

    n, p = op.shape
    l = min(n_components + n_oversamples, min(n, p))
    with span("svd.randomized", n=n, p=p, l=l):
        if omega is None:
            omega = gaussian_sketch(p, l, seed, dtype=op.dtype, device=op.device)
        elif tuple(omega.shape) != (p, l):
            raise ValueError(f"omega must be [{p}, {l}], got {tuple(omega.shape)}")

        # power iterations ride the FAST products (subspace perturbation enters
        # the spectrum only at second order); the final projection the precise
        mv_fast = getattr(op, "mv_fast", op.mv)
        rmv_fast = getattr(op, "rmv_fast", op.rmv)
        Y = mv_fast(omega)  # [n, l]
        for _ in range(n_power_iterations):
            Y = _orthonormalize(Y, normalizer)
            Z = _orthonormalize(rmv_fast(Y), normalizer)  # [p, l]
            Y = mv_fast(Z)

        Q = _final_basis(Y)  # [n, l] orthonormal
        Bt = getattr(op, "rmv_precise", op.rmv)(Q)  # [p, l] == (Q^T A)^T

        with span("svd.small_svd"):
            if p >= _CHOLQR_MIN_ROWS and Bt.dtype == torch.float32:
                # Bt = Qb R with a Gram-based QR, then the SVD of the small [l, l]
                # factor: B = R^T Qb^T, svd(R^T) = (ub, s, vr^T) =>
                # svd(B) = (ub, s, vr^T Qb^T)
                Qb, R = _cholesky_qr2_with_r(Bt)
                ub, s, vtr = torch.linalg.svd(R.T, full_matrices=False)
                vt = vtr @ Qb.T
            else:
                ub, s, vt = torch.linalg.svd(Bt.T, full_matrices=False)
            U = Q @ ub
        return SvdResult(
            u=U[:, :n_components], s=s[:n_components], vt=vt[:n_components]
        )


def svd_flip(u: torch.Tensor, vt: torch.Tensor, u_based_decision: bool = False):
    """sklearn ``svd_flip``: each singular vector's largest-|.| entry is
    made positive (the V-based variant by default, as the reference
    calls it)."""

    if u_based_decision:
        idx = torch.argmax(torch.abs(u), dim=0)
        signs = torch.sign(u[idx, torch.arange(u.shape[1], device=u.device)])
    else:
        idx = torch.argmax(torch.abs(vt), dim=1)
        signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device), idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs).to(u.dtype)
    return u * signs[None, :], vt * signs[:, None]
