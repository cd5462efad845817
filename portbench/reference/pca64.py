"""The plain reference: PCA of a host CSR matrix in plain PyTorch.

Everything here works from the host CSR arrays that the benchmark drew
and nothing else: no module of the measured program, of the JAX package
or of JAX is imported, and nothing the program derived is read. Two
precisions share one code path:

* ``"float64"``: the reference. Products of integer counts in
  ``[-127, 127]`` go through exact int8 tensor-core products summed in
  float64 (exact), every other product is a float64 product.
* ``"tf32"``: the control, the same algorithms with every product's
  operands and every value map's result rounded to TF32 (10 explicit
  mantissa bits, the tensor cores' float32 input format) and float32
  accumulation. It stands in for the program to show that the comparison
  fails a computation one precision step below the float32 the
  configurations state. Where the program computes a stage in bf16 (the
  randomized solver's power steps on a bf16 payload round their operand
  to bf16), the control's randomized SVD takes that stage's operands
  through scaled fp8 (``fp8_round``), the step below bf16.

Algorithms: the exact top-k eigenpairs of a Gram matrix by subspace
iteration with Rayleigh-Ritz steps (the Gram engine's exact solves), and
Halko-Martinsson-Tropp randomized SVD with Householder QR in every power
step, drawing its sketch as the port's documented default does (a
standard normal ``[p, l]`` float32 draw from a ``torch.Generator`` on the
device seeded with the fit's ``random_seed``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "Csr",
    "tf32_round",
    "fp8_round",
    "gram",
    "top_eig",
    "project",
    "randomized_svd",
    "svd_flip_v",
]

INT8_ROWS = 16_384  # rows per exact int8 partial: 16,384 x 127^2 < 2^31
GRAM_ROWS = 8_192  # rows per densified block of the float64 and TF32 Grams
COL_BLOCK = 4_096  # Gram columns per product; blocks below the diagonal are mirrored


def _dtype(precision: str) -> torch.dtype:
    if precision == "float64":
        return torch.float64
    if precision == "tf32":
        return torch.float32
    raise ValueError(f"unknown precision {precision!r}")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) at 10 mantissa bits."""

    i = x.contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & -8192
    return i.view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 (3 mantissa bits), each column scaled to
    the format's range first, as scaled fp8 products take it."""

    amax = x.abs().amax(dim=0, keepdim=True)
    scale = 448.0 / torch.where(amax > 0, amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def _rnd(x: torch.Tensor, precision: str) -> torch.Tensor:
    return tf32_round(x) if precision == "tf32" else x


class Csr:
    """A host CSR matrix (indptr, indices, values) held on ``device`` for
    the reference's products, in ``precision``'s dtype."""

    def __init__(self, indptr, indices, values, shape, device, precision: str = "float64"):
        self.shape = (int(shape[0]), int(shape[1]))
        self.device = torch.device(device)
        self.precision = precision
        self.h_indptr = np.asarray(indptr, np.int64)
        self.h_indices = np.asarray(indices, np.int32)
        self.h_values = np.asarray(values)
        self.values = _rnd(torch.from_numpy(self.h_values).to(self.device, _dtype(precision)),
                           precision)
        self.indptr = torch.from_numpy(self.h_indptr).to(self.device)
        self.indices = torch.from_numpy(self.h_indices.astype(np.int64)).to(self.device)
        self._a = self._at = None

    @classmethod
    def from_scipy(cls, X, device, precision: str = "float64") -> "Csr":
        return cls(X.indptr, X.indices, X.data, X.shape, device, precision)

    def int8_exact(self) -> bool:
        v = self.h_values
        return bool(self.shape[1] % 8 == 0 and v.size and np.abs(v).max() <= 127
                    and np.all(v == np.round(v)))

    def rows_of_entries(self) -> torch.Tensor:
        counts = self.indptr[1:] - self.indptr[:-1]
        return torch.repeat_interleave(torch.arange(self.shape[0], device=self.device), counts)

    def dense_rows(self, r0: int, r1: int, dtype) -> torch.Tensor:
        lo, hi = int(self.h_indptr[r0]), int(self.h_indptr[r1])
        counts = self.indptr[r0 + 1:r1 + 1] - self.indptr[r0:r1]
        rows = torch.repeat_interleave(torch.arange(r1 - r0, device=self.device), counts)
        D = torch.zeros((r1 - r0, self.shape[1]), dtype=dtype, device=self.device)
        D.index_put_((rows, self.indices[lo:hi]), self.values[lo:hi].to(dtype), accumulate=True)
        return D

    def _sparse(self, transpose: bool):
        """``A`` (or ``A^T``) as a torch CSR tensor, built once."""

        if not transpose:
            if self._a is None:
                self._a = torch.sparse_csr_tensor(self.indptr, self.indices, self.values,
                                                  size=self.shape)
            return self._a
        if self._at is None:
            order = torch.argsort(self.indices, stable=True)  # row order kept per column
            counts = torch.bincount(self.indices, minlength=self.shape[1])
            crow = torch.zeros(self.shape[1] + 1, dtype=torch.int64, device=self.device)
            torch.cumsum(counts, 0, out=crow[1:])
            self._at = torch.sparse_csr_tensor(crow, self.rows_of_entries()[order],
                                               self.values[order],
                                               size=(self.shape[1], self.shape[0]))
        return self._at

    def mv(self, B: torch.Tensor) -> torch.Tensor:
        """``A @ B``, ``B`` in this matrix's dtype."""

        return self._sparse(False) @ _rnd(B.contiguous(), self.precision)

    def rmv(self, C: torch.Tensor) -> torch.Tensor:
        """``A^T @ C``."""

        return self._sparse(True) @ _rnd(C.contiguous(), self.precision)

    def col_sums(self) -> torch.Tensor:
        return torch.zeros(self.shape[1], dtype=self.values.dtype, device=self.device) \
            .index_add_(0, self.indices, self.values)


def _mirror_upper(G: torch.Tensor, block: int) -> None:
    p = G.shape[0]
    for c0 in range(0, p, block):
        c1 = min(c0 + block, p)
        G[c1:, c0:c1] = G[c0:c1, c1:].T


def gram(A: Csr) -> torch.Tensor:
    """``A^T A`` in ``A``'s precision (float64 exact for int8-exact counts)."""

    n, p = A.shape
    if A.precision == "float64" and A.int8_exact():
        G = torch.zeros((p, p), dtype=torch.float64, device=A.device)
        for r0 in range(0, n, INT8_ROWS):
            D = A.dense_rows(r0, min(r0 + INT8_ROWS, n), torch.float32)
            rows = D.shape[0]
            At = torch.zeros((p, rows + (-rows) % 8), dtype=torch.int8, device=A.device)
            At[:, :rows] = D.T.to(torch.int8)
            del D
            for c0 in range(0, p, COL_BLOCK):
                c1 = min(c0 + COL_BLOCK, p)
                if A.device.type == "cuda":
                    part = torch._int_mm(At[:c1], At[c0:c1].T)
                else:
                    part = At[:c1].to(torch.int32) @ At[c0:c1].T.to(torch.int32)
                G[:c1, c0:c1] += part.double()
            del At
        _mirror_upper(G, COL_BLOCK)
        return G
    dt = _dtype(A.precision)
    G = torch.zeros((p, p), dtype=dt, device=A.device)
    for r0 in range(0, n, GRAM_ROWS):
        D = _rnd(A.dense_rows(r0, min(r0 + GRAM_ROWS, n), dt), A.precision)
        for c0 in range(0, p, COL_BLOCK):
            c1 = min(c0 + COL_BLOCK, p)
            G[c0:c1, c0:].addmm_(D[:, c0:c1].T, D[:, c0:])
        del D
    _mirror_upper(G, COL_BLOCK)
    return G


def top_eig(G: torch.Tensor, k: int, precision: str = "float64", max_iters: int = 500):
    """Top-``k`` eigenpairs of the symmetric PSD ``G`` by subspace
    iteration with a Rayleigh-Ritz step per iteration, until the Ritz
    values move less than 1e-13 of the largest -> (values descending,
    vectors [p, k] with unit columns, iterations)."""

    p = G.shape[0]
    b = min(2 * k + 28, p)
    gen = torch.Generator(device=G.device)
    gen.manual_seed(1)
    Q = torch.linalg.qr(torch.randn((p, b), generator=gen, dtype=G.dtype, device=G.device))[0]
    Gr = _rnd(G, precision)
    prev = None
    for it in range(max_iters):
        Z = Gr @ _rnd(Q, precision)
        Q = torch.linalg.qr(Z)[0]
        H = _rnd(Q, precision).T @ (Gr @ _rnd(Q, precision))
        w, W = torch.linalg.eigh((H + H.T) / 2)
        ritz = w.flip(0)[:k]
        if prev is not None and float(((ritz - prev).abs() / ritz[0]).max()) < 1e-13:
            break
        prev = ritz
    V = Q @ W.flip(1)[:, :k]
    return ritz, V / torch.linalg.vector_norm(V, dim=0), it + 1


def project(A: Csr, mu: torch.Tensor | None, Vt: torch.Tensor) -> torch.Tensor:
    """Scores ``(A - 1 mu^T) V^T`` for ``Vt`` ([k, p]) in ``A``'s precision."""

    dt = A.values.dtype
    W = Vt.T.to(dt).contiguous()
    T = A.mv(W)
    if mu is not None:
        T = T - (_rnd(mu.to(dt), A.precision) @ _rnd(W, A.precision))[None, :]
    return T


def _qr(Y: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.linalg.qr(_rnd(Y, precision))[0]


def randomized_svd(A: Csr, mu: torch.Tensor | None, k: int, oversamples: int, iters: int,
                   seed: int, power_round=None):
    """Randomized SVD of ``A - 1 mu^T`` with QR in every power step ->
    (singular values [k], Vt [k, p]); the sketch is the standard normal
    float32 ``[p, k + oversamples]`` of a generator on ``A``'s device
    seeded with ``seed``. ``power_round`` (the control's) rounds the
    operand of every product before the final one."""

    n, p = A.shape
    l = min(k + oversamples, n, p)
    dt = A.values.dtype
    gen = torch.Generator(device=A.device)
    gen.manual_seed(int(seed))
    omega = torch.randn((p, l), generator=gen, dtype=torch.float32, device=A.device).to(dt)
    m = None if mu is None else mu.to(dt)

    def mv(B):
        out = A.mv(B)
        return out if m is None else out - (_rnd(m, A.precision) @ _rnd(B, A.precision))[None, :]

    def rmv(C):
        if m is None:
            return A.rmv(C)
        return A.rmv(C) - _rnd(m, A.precision)[:, None] * _rnd(C.sum(dim=0), A.precision)[None, :]

    rp = power_round or (lambda x: x)
    Y = mv(rp(omega))
    for _ in range(iters):
        Y = _qr(Y, A.precision)
        Z = _qr(rmv(rp(Y)), A.precision)
        Y = mv(rp(Z))
    Q = _qr(Y, A.precision)
    Bt = rmv(Q)
    _, s, vt = torch.linalg.svd(_rnd(Bt, A.precision).T, full_matrices=False)
    return s[:k], svd_flip_v(vt[:k])


def svd_flip_v(vt: torch.Tensor) -> torch.Tensor:
    """Each row's largest-magnitude entry made positive."""

    idx = torch.argmax(vt.abs(), dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device), idx])
    return vt * torch.where(signs == 0, torch.ones_like(signs), signs)[:, None]
