"""Linear-operator seam between sparse storage and the SVD engines.

Counterpart of ``single_algebra_tpu/linalg/operators.py``: an operator is
any object with ``shape``, ``dtype``, ``device``, ``mv(B)`` (``A @ B``) and
``rmv(C)`` (``A^T @ C``), and optionally the accuracy classes
``mv_fast``/``rmv_fast`` (what randomized power iterations ride) and
``mv_precise``/``rmv_precise`` (the final projection and the PCA scores).

* :class:`SparseOperator`   — the gather engine (``'sparse'``): products
  through ``ops/spmm.py::ell_spmm`` over the matrix's two ELL layouts.
* :class:`MaskedOperator`   — a column-masked view of any engine: the
  narrow operand is scattered to full width for ``mv``, the masked rows of
  the full product gathered for ``rmv``.
* :class:`DenseOperator`    — a dense tensor (the small-Gram solve).
* :class:`CenteredOperator` — implicit column centering as a rank-1
  correction, with the operand deflation of its ``rmv`` products; it
  forwards each accuracy class to its base.
* :class:`DensifiedOperator` — the dense-bf16 engine for matrices whose
  dense form fits device memory: bf16 ``hi`` (+ ``lo``) payload, bf16
  tensor-core products with float32 accumulation.
* :class:`TiledSparseOperator` — the tiled engine: products through the
  ``tiled_ell_spmm_t`` / ``tiled_ell_rmv_t`` kernels over one row-major
  column-tiled payload, plus plain-ELL overflow side arrays.

Products run in full float32 under the package's precision policy
(``types.precision_policy``, entered by every public entry point), the
counterpart of the JAX package's
``Precision.HIGHEST`` dots.

**The bf16 operand split.** The JAX package splits a float32 operand
into three bf16 terms (``bf16_terms``, ``OPERAND_TERMS``) because the
TPU's matrix unit rounds an f32 operand to bf16. The tiled engine does
not need it here: its kernels form each slot's product of a bf16 payload
value and a float32 operand in float32 (one rounding, in the FMA), so its
f32-class products ``mv``/``rmv`` make one kernel call per payload half
(hi, then lo when the values are not bf16-exact) on the unsplit float32
operand; ``tests/test_torch_tiled.py`` holds them to the JAX three-term
result and to a float64 product at 1e-6. The densified engine keeps the
split: its products are cuBLAS GEMMs, whose tensor cores take bf16
operands, and the three terms stacked into one ``[p, 3k]`` operand read
the dense payload once, where a float32 GEMM would first widen it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from ..ops.spmm import ell_spmm
from ..ops.spmm_kernel import (
    rmv_form_nbytes, tiled_ell_rmv_form, tiled_ell_rmv_t, tiled_ell_spmm_t,
)
from ..utils.tracing import count, span

__all__ = [
    "SparseOperator",
    "MaskedOperator",
    "OPERAND_TERMS",
    "bf16_terms",
    "DenseOperator",
    "CenteredOperator",
    "DensifiedOperator",
    "TiledSparseOperator",
    "hbm_bytes",
]


def hbm_bytes(device: torch.device | str) -> int | None:
    """Total memory of a CUDA device, or None for any other device."""

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


@dataclasses.dataclass
class SparseOperator:
    """Products with a ``SparseMatrix`` through both ELL orientations: ``mv``
    over the row layout, ``rmv`` over the column layout, each a row-blocked
    gather (``ell_spmm``) in the promoted dtype of the values and the
    operand. Built from the matrix's cached device layouts (the column one
    comes with its transpose)."""

    row_data: torch.Tensor  # row-major ELL [R, Wr]
    row_ids: torch.Tensor
    col_data: torch.Tensor  # column-major ELL [C, Wc]
    col_ids: torch.Tensor
    shape: Tuple[int, int]

    @classmethod
    def from_matrix(cls, m) -> "SparseOperator":
        row = m._layout_for("row")
        col = m._layout_for("col")
        return cls(row.ell_data, row.ell_ids, col.ell_data, col.ell_ids, m.shape)

    @property
    def dtype(self):
        return self.row_data.dtype

    @property
    def device(self):
        return self.row_data.device

    def mv(self, B):
        """A @ B, B: [ncols, k] -> [nrows, k]."""

        return ell_spmm(self.row_data, self.row_ids, B)[: self.shape[0]]

    def rmv(self, C):
        """A.T @ C, C: [nrows, k] -> [ncols, k]."""

        return ell_spmm(self.col_data, self.col_ids, C)[: self.shape[1]]


@dataclasses.dataclass
class MaskedOperator:
    """Column-masked view of any engine: logical shape ``(n, p_masked)``.

    ``mask_idx[i]`` is the full-width column of masked column i. ``mv*``
    scatter the narrow operand into full width (columns outside the mask
    multiply zeros); ``rmv*`` gather the masked rows of the full-width
    product. Each accuracy class takes the base's product of that class,
    or its plain ``mv``/``rmv`` where the base has none."""

    base: object
    mask_idx: torch.Tensor  # [p_masked] int64

    @property
    def shape(self):
        return (self.base.shape[0], self.mask_idx.shape[0])

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _full(self, B):
        full = torch.zeros((self.base.shape[1], B.shape[1]), dtype=B.dtype, device=B.device)
        full[self.mask_idx] = B
        return full

    def _mv_with(self, name, B):
        return getattr(self.base, name, self.base.mv)(self._full(B))

    def _rmv_with(self, name, C):
        return getattr(self.base, name, self.base.rmv)(C)[self.mask_idx]

    def mv(self, B):
        return self.base.mv(self._full(B))

    def rmv(self, C):
        return self.base.rmv(C)[self.mask_idx]

    def mv_precise(self, B):
        return self._mv_with("mv_precise", B)

    def rmv_precise(self, C):
        return self._rmv_with("rmv_precise", C)

    def mv_fast(self, B):
        return self._mv_with("mv_fast", B)

    def rmv_fast(self, C):
        return self._rmv_with("rmv_fast", C)


@dataclasses.dataclass
class DenseOperator:
    """Dense operator (the small-Gram solve, tests)."""

    a: torch.Tensor

    @property
    def shape(self):
        return tuple(self.a.shape)

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def device(self):
        return self.a.device

    def mv(self, B):
        return self.a @ B

    def rmv(self, C):
        return self.a.T @ C


@dataclasses.dataclass
class CenteredOperator:
    """Implicitly column-centered view of any operator.

    ``rmv`` uses OPERAND DEFLATION: ``A_c^T C`` is computed as
    ``A^T (C - 1 cbar^T) - mu (1^T (C - 1 cbar^T))`` with
    ``cbar = (1^T C)/n``, so no float32 partial sum is ever stored at the
    uncentered column scale (the direct form floors the relative accuracy
    of ``Q^T A_c`` at ~``eps32 * mu/sigma``; see the JAX class).

    A float64 ``mu`` over a float32 engine promotes, as ``jnp`` does: the
    rank-1 terms and the products come out in float64, and so does
    :attr:`dtype` (the randomized solve draws its sketch in it)."""

    base: object
    mu: torch.Tensor  # [p]

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return torch.promote_types(self.base.dtype, self.mu.dtype)

    @property
    def device(self):
        return self.base.device

    def _deflate(self, C):
        n = self.base.shape[0]
        cbar = C.sum(dim=0) / n
        Cd = C - cbar[None, :]
        return Cd, Cd.sum(dim=0)

    def _corr(self, B):
        """``mu^T B`` in the promoted dtype of the two."""

        dt = torch.promote_types(self.mu.dtype, B.dtype)
        return self.mu.to(dt) @ B.to(dt)

    def mv(self, B):
        return self.base.mv(B) - self._corr(B)[None, :]

    def rmv(self, C):
        Cd, t = self._deflate(C)
        return self.base.rmv(Cd) - self.mu[:, None] * t[None, :]

    def _mv_with(self, name, B):
        base = getattr(self.base, name, self.base.mv)
        return base(B) - self._corr(B)[None, :]

    def _rmv_with(self, name, C):
        base = getattr(self.base, name, self.base.rmv)
        Cd, t = self._deflate(C)
        return base(Cd) - self.mu[:, None] * t[None, :]

    def mv_precise(self, B):
        return self._mv_with("mv_precise", B)

    def rmv_precise(self, C):
        return self._rmv_with("rmv_precise", C)

    def mv_fast(self, B):
        return self._mv_with("mv_fast", B)

    def rmv_fast(self, C):
        return self._rmv_with("rmv_fast", C)


# term count of the OPERAND split in the densified engine's precise
# products: each bf16 term holds 8 mantissa bits, so the dropped residual
# is ~2^-(8*terms) relative; 3 terms put it under the float32
# accumulation noise (2 floored explained variance at ~1.5e-5 in the JAX
# package)
OPERAND_TERMS = 3


def bf16_terms(B: torch.Tensor, terms: int = OPERAND_TERMS) -> list:
    """Split float32 ``B`` into ``terms`` bf16 tensors summing to ``B``
    with a ~2^-(8*terms) relative residual."""

    out = []
    r = B
    for _ in range(terms - 1):
        h = r.to(torch.bfloat16)
        out.append(h)
        r = r - h.to(B.dtype)
    out.append(r.to(torch.bfloat16))
    return out


def _bf16_from_bits(a) -> torch.Tensor:
    """A numpy array of bf16 bit patterns (uint16, or ``ml_dtypes``'
    bfloat16) as a CPU ``torch.bfloat16`` tensor sharing its memory."""

    bits = np.ascontiguousarray(a).view(np.uint16)
    if not bits.flags.writeable:  # torch refuses read-only memory
        bits = bits.copy()
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


_RED_BLOCK = 1 << 13  # the reduction axis of one cuBLAS call of a bf16 product


def _bf16_dot(a: torch.Tensor, b: torch.Tensor, over_rows: bool) -> torch.Tensor:
    """``a @ b`` (``a^T @ b`` when ``over_rows``) of bf16 tensors with
    float32 accumulation and a float32 result, ``a`` being ``[n, p]``.
    On CUDA one cuBLAS call whose output is float32 (a ``.T`` view, never
    a transposed copy); a plain ``torch.matmul`` would round the
    accumulator to bf16. ``b`` is zero-padded to a multiple of 8 columns
    first: cuBLAS is slower on narrower operands (``chip_smoke.py``'s
    ``dense_products`` line: on an H100 at 400,000 x 30,000 the 3-column
    operand of a one-column precise product took 19.1 ms unpadded, 8.8 ms
    padded); the reduction runs in blocks. Elsewhere row blocks of ``a``
    are widened: products of bf16 values are exact in float32. Each GEMM
    call (cuBLAS on a card) adds 1 to the counter ``dense.cublas_calls``."""

    if a.device.type == "cuda":
        k = b.shape[1]
        if k % 8:
            b = torch.nn.functional.pad(b, (0, 8 - k % 8))
        # the reduction runs in blocks of _RED_BLOCK along its axis, the
        # float32 partials added: one cuBLAS call over all 400,000 rows of
        # the smoke's densified path is the less precise (its
        # dense_products line records both forms), and NMF's
        # multiplicative updates compound a product's error. Over columns,
        # the contiguous axis of ``a``, the blocks stop at a multiple of 8:
        # a block whose extent is not one runs in an unaligned cuBLAS
        # kernel (at 600,000 x 36,601 on an H100 the last 3,833 columns
        # took 4.6 ms of a 19.6 ms pass); the last ``p % 8`` columns are
        # added in float32, where products of bf16 values are exact
        red = a.shape[0 if over_rows else 1]
        end = red if over_rows else red - red % 8
        out = None
        for j0 in range(0, end, _RED_BLOCK):
            j1 = min(j0 + _RED_BLOCK, end)
            count("dense.cublas_calls")
            part = (torch.mm(a[j0:j1].T, b[j0:j1], out_dtype=torch.float32) if over_rows
                    else torch.mm(a[:, j0:j1], b[j0:j1], out_dtype=torch.float32))
            out = part if out is None else out.add_(part)
        if end < red:
            count("dense.cublas_calls")
            tail = (a[:, end:].float(), b[end:].float())
            out = torch.mm(*tail) if out is None else out.addmm_(*tail)
        return out[:, :k]
    n, p = a.shape
    step = max((64 << 20) // max(4 * p, 1), 1)
    bf = b.float()
    if not over_rows:
        out = torch.empty((n, b.shape[1]), dtype=torch.float32)
        for r0 in range(0, n, step):
            count("dense.cublas_calls")
            out[r0:r0 + step] = a[r0:r0 + step].float() @ bf
        return out
    out = torch.zeros((p, b.shape[1]), dtype=torch.float32)
    for r0 in range(0, n, step):
        count("dense.cublas_calls")
        out.addmm_(a[r0:r0 + step].float().T, bf[r0:r0 + step])
    return out


def _row_stride(p: int) -> int:
    """Elements per row of a stored dense bf16 half: ``p`` rounded up to a
    multiple of 8, so that every row starts 16-byte aligned. cuBLAS's bf16
    tensor-core GEMMs take narrower loads over an odd leading dimension:
    on an H100 at 600,000 x 36,601 (``tools/dense_stride.py``) each
    product ran 1.9x (64-column operand) to 3.2x (152) slower over the
    odd stride than over the padded one."""

    return -(-p // 8) * 8


def _dense_zeros(n: int, p: int, device) -> torch.Tensor:
    """A zeroed bf16 ``[n, _row_stride(p)]`` half, whole (the caller keeps
    its ``[:, :p]`` view)."""

    return torch.zeros((n, _row_stride(p)), dtype=torch.bfloat16, device=device)


def _padded_half(h: torch.Tensor, device, block_bytes: int) -> torch.Tensor:
    """bf16 ``h`` ([n, p], any device) -> its ``[:, :p]`` view in padded
    storage on ``device``, copied in row blocks of about ``block_bytes``
    (a strided copy of the whole would stage a second dense copy)."""

    n, p = h.shape
    out = _dense_zeros(n, p, device)[:, :p]
    step = max(block_bytes // max(2 * p, 1), 1)
    for r0 in range(0, n, step):
        out[r0:r0 + step].copy_(h[r0:r0 + step])
    return out


@dataclasses.dataclass
class DensifiedOperator:
    """Dense-bf16 engine for matrices whose dense form fits device memory.

    At single-cell densities a ``[n, p]`` bf16 densification often fits,
    and the sketching products then run as dense tensor-core GEMMs.

    * ``hi`` holds bf16(x): exact for raw counts up to 256.
    * ``lo`` holds bf16(x - hi), together ~16 mantissa bits; it is dropped
      (None) when the values are bf16-exact.
    * ``mv``/``rmv`` multiply ``hi`` by the operand rounded to bf16 (what
      the randomized power iterations ride); ``mv_precise``/``rmv_precise``
      multiply both halves by the operand split into ``OPERAND_TERMS``
      bf16 terms, stacked into one ``[., 3k]`` operand so that each half
      of the payload is read once. Every product accumulates in float32.

    The dense array is laid out ``[n, p]``; ``rmv`` contracts over rows
    through a transposed view, never a transposed copy. The halves that
    :meth:`from_matrix` and :meth:`from_arrays` build are ``[:, :p]`` views
    of storage whose rows are padded to :func:`_row_stride` elements (at
    most 7 zero columns, never read). The capacity rule (:meth:`fits`): the
    padded dense form (twice that with ``lo``) must fit 0.6 of device
    memory, the rest being the solvers' workspace.
    """

    hi: torch.Tensor  # [n, p] bfloat16
    lo: torch.Tensor | None  # [n, p] bfloat16, None when exact
    shape: Tuple[int, int]

    #: rows of a device-densify block / a col_stats block (f32 temporaries)
    _BLOCK_BYTES = 256 << 20

    # -- construction ------------------------------------------------------

    @staticmethod
    def densify_host(m):
        """Host densification -> CPU bf16 tensors ``(hi, lo | None)``
        through the native ``csr_densify_bf16`` (a memset plus an
        nnz-only scatter with the f32 -> bf16 rounding fused), or the
        same in torch when no compiler is available."""

        from ..native import build as _native

        indptr, indices, data = m._row_csr()
        n, p = m.shape
        vals = np.ascontiguousarray(data, np.float32)
        exact = m.values_bf16_exact()
        nat = _native.csr_densify_bf16(indptr, indices, vals, n, p, need_lo=not exact)
        if nat is not None:
            hi_u16, lo_u16, _ = nat
            return _bf16_from_bits(hi_u16), (
                None if exact else _bf16_from_bits(lo_u16)
            )
        return _scatter_bf16(
            torch.from_numpy(indptr), torch.from_numpy(indices), torch.from_numpy(vals),
            n, p, DensifiedOperator._BLOCK_BYTES,
        )

    @classmethod
    def from_matrix(cls, m, *, device: bool | None = None) -> "DensifiedOperator":
        """The operator on ``m.device``. ``device=True`` uploads the CSR
        arrays and densifies there (a scatter per row block, the JAX
        package's device route); ``device=False`` densifies on the host
        and uploads the dense halves. Both give the same ``hi``/``lo``.
        The default is the device route on a card (faster there:
        ``build_seconds`` keeps each step's time) and the host route on
        the CPU."""

        if device is None:
            device = m.device.type == "cuda"
        t0 = time.perf_counter()
        with span("dense.build", route="device" if device else "host"):
            if device:
                indptr, indices, data = m._row_csr()
                arrays = (indptr, indices, np.ascontiguousarray(data, np.float32))
                count("dense.upload_bytes", sum(a.nbytes for a in arrays))
                indptr, indices, vals = (torch.from_numpy(a).to(m.device) for a in arrays)
                _sync(m.device)
                t1 = time.perf_counter()
                hi, lo = _scatter_bf16(indptr, indices, vals, *m.shape, cls._BLOCK_BYTES)
                _sync(m.device)
                seconds = {"upload": t1 - t0, "device_densify": time.perf_counter() - t1}
            else:
                halves = cls.densify_host(m)
                t1 = time.perf_counter()
                count("dense.upload_bytes",
                      sum(h.numel() * h.element_size() for h in halves if h is not None))
                hi, lo = (None if h is None else _padded_half(h, m.device, cls._BLOCK_BYTES)
                          for h in halves)
                _sync(m.device)
                seconds = {"host_densify": t1 - t0, "upload": time.perf_counter() - t1}
        op = cls(hi, lo, m.shape)
        op.build_seconds = seconds
        return op

    @classmethod
    def from_arrays(cls, hi, lo, shape, *, device="cuda") -> "DensifiedOperator":
        """Operator on ``device`` from numpy halves: bf16 bit patterns as
        uint16 or ``ml_dtypes.bfloat16`` arrays, e.g. the JAX operator's
        ``np.asarray(op.hi)`` / ``np.asarray(op.lo)`` (``lo`` may be None),
        copied into padded-stride storage."""

        n, p = int(shape[0]), int(shape[1])
        halves = []
        for a in (hi, lo):
            if a is None:
                halves.append(None)
                continue
            t = _bf16_from_bits(a)
            if tuple(t.shape) != (n, p):
                raise ValueError(f"dense half must be [{n}, {p}], got {tuple(t.shape)}")
            halves.append(_padded_half(t, device, cls._BLOCK_BYTES))
        return cls(halves[0], halves[1], (n, p))

    # -- capacity planning (the 'auto' engine selector's input) ---------

    @staticmethod
    def hbm_budget_bytes(device: torch.device | str) -> int:
        """0.6 of the CUDA device's memory. Other devices get the JAX
        package's 9 GiB fallback, so CPU runs plan as it does there."""

        total = hbm_bytes(device)
        return int(total * 0.6) if total is not None else 9 << 30

    @classmethod
    def fits(
        cls, shape, budget_bytes: int | None = None, needs_lo: bool = False, *,
        device: torch.device | str,
    ) -> bool:
        if budget_bytes is None:
            budget_bytes = cls.hbm_budget_bytes(device)
        n, p = shape
        return 2 * n * _row_stride(p) * (2 if needs_lo else 1) <= budget_bytes

    # -- products --------------------------------------------------------

    @property
    def dtype(self):
        return torch.float32

    @property
    def device(self):
        return self.hi.device

    def _product(self, name: str, operand, over_rows: bool, half: str, precise: bool):
        n, p = self.shape
        with span(name, width=int(operand.shape[1]), precise=precise, half=half):
            count("dense.bytes_read", 2 * n * p)
            return _bf16_dot(getattr(self, half), operand, over_rows)

    def _mv(self, B, half: str = "hi", precise: bool = False):
        """``A_half @ B`` for a bf16 operand ``B`` ([p, w]) -> float32
        [n, w]: the one product primitive of this direction, one pass over
        the payload half ``half`` ("hi" or "lo")."""

        return self._product("dense.mv", B, False, half, precise)

    def _rmv(self, C, half: str = "hi", precise: bool = False):
        """``A_half^T @ C`` for a bf16 operand ``C`` ([n, w]) -> float32
        [p, w]: the one product primitive of this direction."""

        return self._product("dense.rmv", C, True, half, precise)

    def mv(self, B):
        """A @ B: hi by the bf16-rounded operand, float32 accumulation."""

        return self._mv(B.to(torch.bfloat16)).to(B.dtype)

    def rmv(self, C):
        """A^T @ C: hi by the bf16-rounded operand, float32 accumulation."""

        return self._rmv(C.to(torch.bfloat16)).to(C.dtype)

    def _precise(self, B, over_rows: bool):
        # the matrix AND the operand are split: rounding the operand (the
        # orthonormal Q of the final projection, a Lanczos vector) would
        # put first-order error into the singular values
        k = B.shape[1]
        stacked = torch.cat(bf16_terms(B.float(), OPERAND_TERMS), dim=1)  # [., 3k]
        product = self._rmv if over_rows else self._mv
        out = None
        for half in ("hi", "lo"):
            if getattr(self, half) is None:
                continue
            parts = product(stacked, half, precise=True)
            term = parts[:, :k] + parts[:, k:2 * k]
            for i in range(2, OPERAND_TERMS):
                term = term + parts[:, i * k:(i + 1) * k]
            out = term if out is None else out + term
        return out.to(B.dtype)

    def mv_precise(self, B):
        """A @ B at f32-class accuracy (both halves, three operand terms)."""

        return self._precise(B, False)

    def rmv_precise(self, C):
        """A^T @ C at f32-class accuracy."""

        return self._precise(C, True)

    def col_stats(self):
        """(sum, sum_sq) per column in float32, over row blocks of
        ``x = hi + lo`` rebuilt exactly in float32 before squaring."""

        n, p = self.shape
        s = torch.zeros(p, dtype=torch.float32, device=self.device)
        sq = torch.zeros(p, dtype=torch.float32, device=self.device)
        step = max(self._BLOCK_BYTES // max(4 * p, 1), 1)
        for r0 in range(0, n, step):
            x = self.hi[r0:r0 + step].float()
            if self.lo is not None:
                x += self.lo[r0:r0 + step].float()
            s += x.sum(dim=0)
            sq += (x * x).sum(dim=0)
        return s, sq


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _scatter_bf16(indptr, indices, vals, n: int, p: int, block_bytes: int):
    """CSR arrays (tensors on one device, no duplicate entries) -> dense
    bf16 ``(hi [n, p], lo | None)`` there: hi = bf16(v), lo = bf16(v - hi)
    scattered into zeroed padded-stride arrays (:func:`_dense_zeros`; the
    ``[:, :p]`` views are returned) one row block at a time (about
    ``block_bytes`` of int64 indices each), so nothing dense is ever held
    in float32. ``lo`` is None when every value is bf16-exact."""

    dev = vals.device
    hv = vals.to(torch.bfloat16)
    lv = (vals - hv.float()).to(torch.bfloat16)
    exact = not bool((lv != 0).any())
    hi = _dense_zeros(n, p, dev)
    lo = None if exact else _dense_zeros(n, p, dev)
    stride = hi.shape[1]
    per_row = max(vals.numel() / max(n, 1), 1.0)
    step = max(int(block_bytes / 16 / per_row), 1)  # rows per block
    counts = indptr[1:] - indptr[:-1]
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        a, b = int(indptr[r0]), int(indptr[r1])
        rows = torch.repeat_interleave(
            torch.arange(r0, r1, device=dev, dtype=torch.int64), counts[r0:r1]
        )
        flat = rows * stride + indices[a:b].to(torch.int64)
        hi.view(-1)[flat] = hv[a:b]
        if lo is not None:
            lo.view(-1)[flat] = lv[a:b]
    return hi[:, :p], None if lo is None else lo[:, :p]


def _kp(k: int) -> int:
    """Operand rows of a kernel call: k rounded up to a multiple of 8."""

    return max(-(-k // 8) * 8, 8)


def _padded_t(M: torch.Tensor, width: int, dtype) -> torch.Tensor:
    """``[r, k]`` -> ``M^T`` zero-padded to ``[kp, width]`` in ``dtype``."""

    k = M.shape[1]
    Mt = torch.zeros((_kp(k), width), dtype=dtype, device=M.device)
    Mt[:k, : M.shape[0]] = M.T
    return Mt


@dataclasses.dataclass
class TiledSparseOperator:
    """Sparse products through the ``tiled_ell_spmm_t`` / ``tiled_ell_rmv_t``
    kernels.

    The engine for matrices too large to densify in device memory and too
    wide for the Gram (p > 40,960), whose ~(2-3x nnz) column-tiled payload
    fits. One row-major tiled payload serves both products; the rare
    entries past the main level's width ``wt`` live in plain-ELL side
    arrays, one per direction (``ov_*`` rows -> global column ids for
    ``mv``, ``ovt_*`` columns -> global row ids for ``rmv``), added by
    :func:`~..ops.spmm.ell_spmm` in float32.

    Accuracy classes (float32 matrices), as in the JAX operator: the
    payload is bf16 ``hi`` (+ bf16 ``lo`` residual unless the values are
    bf16-exact, e.g. raw counts) while ``wt <= BF16_WT_MAX``, else float32.
    ``mv_fast``/``rmv_fast`` multiply ``hi`` by the operand rounded to bf16
    (one kernel call); ``mv``/``rmv`` (= ``*_precise``) multiply ``hi``
    and then ``lo`` by the float32 operand, each slot's product formed in
    float32 (see the module docs). float64 matrices keep a float64 payload
    with exact products on the CPU; the CUDA kernels refuse float64.

    On a card the operator keeps, per payload array (``hi``, and ``lo``
    where there is one), the bucketed form that ``tiled_ell_rmv_t`` sums
    (:class:`~..ops.spmm_kernel.RmvForm`), built at the first ``rmv*``
    that needs it, so later ``rmv*`` calls skip the bucketing; the
    ``tiled.rmv`` span's ``form`` attribute says ``built``, ``reused`` or
    ``none`` (the CPU's plain route needs no form).

    ``meta = (wt, ntiles, ct, br, ovw, ovtw)``.
    """

    tdata: torch.Tensor  # [nt * wt, Rp]  bf16 hi, f32 (wide) or f64 values
    tdata_lo: torch.Tensor | None  # bf16 residual; None when exact / unsplit
    tlocal: torch.Tensor  # [nt * wt, Rp]  int32 tile-local column ids
    ov_data: torch.Tensor  # [Rp, ovw]   overflow rows -> global col ids (mv)
    ov_ids: torch.Tensor
    ovt_data: torch.Tensor  # [Pp, ovtw] overflow cols -> global row ids (rmv)
    ovt_ids: torch.Tensor
    shape: Tuple[int, int]
    meta: Tuple[int, int, int, int, int, int]
    _forms: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)  # "hi" / "lo" -> RmvForm

    COL_TILE = 256
    BLOCK_ROWS = 1024
    # the JAX package's width gate for the bf16 split (measured there on
    # the TPU); kept so both packages store the same payload
    BF16_WT_MAX = 16
    _SPLIT_CHUNK = 64 << 20  # elements per step of the split's f32 temporaries

    # -- construction ------------------------------------------------------

    @classmethod
    def build_host(cls, m):
        """The unsplit payload as numpy, on the host:
        ``(td, tl, ovd, ovi, otd, oti, shape, meta)``."""

        from ..sparse import convert as cv

        ct, br = cls.COL_TILE, cls.BLOCK_ROWS
        n, p = m.shape
        td, tl, wt, nt, ovd, ovi, ovw = cv.csr_to_tiled_ell_split_numpy(
            *m._row_csr(), n, p, col_tile=ct, rows_padded_to=br,
        )
        # transposed overflow (column-major plain ELL over just the overflow
        # entries) so rmv needs no scatter; padding slots carry v=0
        if ovw > 0:
            r_idx, w_idx = np.nonzero(ovd)
            t_indptr, t_indices, t_vals = _coo_to_csr_arrays(
                ovi[r_idx, w_idx], r_idx, ovd[r_idx, w_idx], p, n
            )
            otd, oti, _ = cv.csr_to_ell_numpy(t_indptr, t_indices, t_vals, p)
            ovtw = otd.shape[1]
        else:
            pp = cv.pad_rows(p)
            otd = np.zeros((pp, 0), ovd.dtype)
            oti = np.zeros((pp, 0), np.int32)
            ovtw = 0
        return td, tl, ovd, ovi, otd, oti, (n, p), (wt, nt, ct, br, ovw, ovtw)

    @classmethod
    def _split_payload(cls, td: torch.Tensor, wt: int):
        """float32 payload -> (bf16 hi, bf16 lo | None) while ``wt <=
        BF16_WT_MAX``; other dtypes and wide payloads pass through unsplit.
        Runs wherever ``td`` lies (the engine splits on its device, after
        the upload); the result is the JAX package's host split."""

        if td.dtype != torch.float32 or wt > cls.BF16_WT_MAX:
            return td, None
        hi = td.to(torch.bfloat16)
        step = max(1, cls._SPLIT_CHUNK // max(td.shape[1], 1))
        exact = all(
            torch.equal(hi[i:i + step].float(), td[i:i + step])
            for i in range(0, td.shape[0], step)
        )
        if exact:
            return hi, None
        lo = torch.empty_like(hi)
        for i in range(0, td.shape[0], step):
            lo[i:i + step] = td[i:i + step] - hi[i:i + step].float()
        return hi, lo

    @classmethod
    def from_matrix(cls, m) -> "TiledSparseOperator":
        """Host payload build, then upload to ``m.device`` and the bf16
        split there; the two times are kept in ``build_seconds``."""

        t0 = time.perf_counter()
        with span("tiled.build_host"):
            td, tl, ovd, ovi, otd, oti, shape, meta = cls.build_host(m)
        t1 = time.perf_counter()

        def put(a):
            return torch.from_numpy(a).to(m.device)

        with span("tiled.upload_split"):
            hi, lo = cls._split_payload(put(td), meta[0])
            op = cls(hi, lo, put(tl), put(ovd), put(ovi), put(otd), put(oti), shape, meta)
            _sync(op.device)
        op.build_seconds = {
            "host_payload": t1 - t0, "upload_split": time.perf_counter() - t1,
        }
        return op

    # -- capacity planning (the 'auto' engine selector's input) ---------

    @classmethod
    def payload_bytes(cls, m) -> int:
        """Device-payload size of the tiled layout for ``m``, charged as the
        JAX package charges it (f32 values + int32 ids, 8 bytes a slot; two
        O(nnz) host passes over the structure, kept on the matrix), so both
        packages price the payload alike. :meth:`fits` adds
        :meth:`form_bytes`."""

        from ..sparse import convert as cv

        n, p = m.shape
        wt, ntiles, ovw, _ = m._tiled_widths(cls.COL_TILE)
        rp = cls._rows(n)
        main = ntiles * wt * rp * 8
        over = rp * ovw * 8
        if ovw:
            # the rmv-side transposed overflow has its own width (the max
            # per-column overflow count)
            ovtw = m._tiled_overflow_col_width(cls.COL_TILE)
            over += cv.pad_rows(p) * cv.round_up(max(ovtw, 1), 8) * 8
        return main + over

    @classmethod
    def form_bytes(cls, m) -> int:
        """Device bytes of the rmv forms the operator keeps for ``m`` past
        :meth:`payload_bytes` (:func:`form_charge`, from the widths that
        :meth:`payload_bytes` keeps on the matrix); 0 off CUDA, where no
        form is kept."""

        if m.device.type != "cuda":
            return 0
        wt, ntiles, _, _ = m._tiled_widths(cls.COL_TILE)
        return form_charge(m, wt, ntiles, cls._rows(m.shape[0]))

    @classmethod
    def _rows(cls, n: int) -> int:
        return max(-(-n // cls.BLOCK_ROWS), 1) * cls.BLOCK_ROWS

    @classmethod
    def fits(cls, m, budget_bytes: int | None = None) -> bool:
        """The payload and, on a card, the rmv forms the operator will keep
        fit ``budget_bytes`` (0.6 of the card's memory by default)."""

        if budget_bytes is None:
            budget_bytes = DensifiedOperator.hbm_budget_bytes(m.device)
        return cls.payload_bytes(m) + cls.form_bytes(m) <= budget_bytes

    # -- products --------------------------------------------------------

    @property
    def dtype(self):
        return torch.float64 if self.tdata.dtype == torch.float64 else torch.float32

    @property
    def device(self):
        return self.tdata.device

    @property
    def _bf16(self) -> bool:
        return self.tdata.dtype == torch.bfloat16

    def _kw(self):
        wt, nt, ct, br, _, _ = self.meta
        return dict(wt=wt, ntiles=nt, col_tile=ct, block_rows=br)

    def _mv(self, B, fast: bool):
        _, nt, ct, _, ovw, _ = self.meta
        n, k = self.shape[0], B.shape[1]
        fast = fast and self._bf16
        with span("tiled.mv", width=k, fast=fast):
            Bt = _padded_t(B, nt * ct, torch.bfloat16 if fast else B.dtype)
            out = tiled_ell_spmm_t(self.tdata, self.tlocal, Bt, **self._kw())
            if self.tdata_lo is not None and not fast:
                out = out + tiled_ell_spmm_t(self.tdata_lo, self.tlocal, Bt, **self._kw())
            result = out[:k, :n].T
            if ovw > 0:
                result = result + ell_spmm(self.ov_data, self.ov_ids, B)[:n]
            return result.to(B.dtype)

    def _rmv_form(self, half: str, td: torch.Tensor):
        """The kept bucketed form of payload array ``half`` ("hi" or "lo",
        ``td``), built now if missing; None off CUDA. -> (form, built now)."""

        if self.device.type != "cuda":
            return None, False
        form = self._forms.get(half)
        if form is not None:
            return form, False
        wt, nt, ct = self.meta[:3]
        form = self._forms[half] = tiled_ell_rmv_form(td, self.tlocal, wt=wt, ntiles=nt,
                                                       col_tile=ct)
        return form, True

    def _rmv(self, C, fast: bool):
        _, _, _, _, _, ovtw = self.meta
        p, k = self.shape[1], C.shape[1]
        fast = fast and self._bf16
        with span("tiled.rmv", width=k, fast=fast) as sp:
            Ct = _padded_t(C, self.tdata.shape[1], torch.bfloat16 if fast else C.dtype)
            halves = [("hi", self.tdata)]
            if self.tdata_lo is not None and not fast:
                halves.append(("lo", self.tdata_lo))
            out, built = None, False
            for half, td in halves:
                form, new = self._rmv_form(half, td)
                built |= new
                part = tiled_ell_rmv_t(td, self.tlocal, Ct, form=form, **self._kw())
                out = part if out is None else out + part
            sp.set(form="built" if built else "none" if form is None else "reused")
            result = out[:p, :k]
            if ovtw > 0:
                result = result + ell_spmm(self.ovt_data, self.ovt_ids, C)[:p]
            return result.to(C.dtype)

    def mv(self, B):
        """A @ B at f32-class accuracy (hi, then lo, by the f32 operand)."""

        return self._mv(B, fast=False)

    def mv_fast(self, B):
        """A @ B with the hi payload by the bf16-rounded operand."""

        return self._mv(B, fast=True)

    def rmv(self, C):
        """A^T @ C at f32-class accuracy."""

        return self._rmv(C, fast=False)

    def rmv_fast(self, C):
        """A^T @ C with the hi payload by the bf16-rounded operand."""

        return self._rmv(C, fast=True)


def form_charge(m, wt: int, ntiles: int, rows: int) -> int:
    """Bytes that the rmv forms (:class:`~..ops.spmm_kernel.RmvForm`) of
    the tiled payload of ``m`` at ``rows`` payload rows (all slabs
    together) take beyond the 8 bytes a slot that ``payload_bytes``
    charges. ``m.nnz`` bounds the entries a form stores. A float32 payload
    (``wt > BF16_WT_MAX``) takes its 8 bytes a slot and keeps one form of
    8-byte entries; a payload with a ``lo`` half takes 8 bytes a slot and
    keeps two forms of 4-byte entries; a bf16-exact payload takes 6 bytes
    a slot and its one form of 4-byte entries is charged past the 2 bytes
    a slot left over. At the tiled path's 500,736 x 237 tiles x 16 slots
    (15.7 % stored) that is 0 for counts, 2 x 1.79 GB with a ``lo``
    half."""

    ct, slots = TiledSparseOperator.COL_TILE, ntiles * wt * rows
    if wt > TiledSparseOperator.BF16_WT_MAX:
        return rmv_form_nbytes(m.nnz, rows, ntiles, ct, torch.float32)
    one = rmv_form_nbytes(m.nnz, rows, ntiles, ct, torch.bfloat16)
    return max(0, one - 2 * slots) if m.values_bf16_exact() else 2 * one


def _coo_to_csr_arrays(rows, cols, vals, n, p):
    """COO triplets -> (indptr, indices, data) CSR arrays (host numpy)."""

    import scipy.sparse as sp

    csr = sp.coo_matrix((vals, (rows, cols)), shape=(n, p)).tocsr()
    csr.sort_indices()
    return (
        csr.indptr.astype(np.int64),
        csr.indices.astype(np.int32),
        csr.data,
    )
