"""``tiled_ell_spmm_t`` and ``tiled_ell_rmv_t``: the tiled engine's kernels.

Counterpart of the Pallas kernels of the same names in
``single_algebra_tpu/ops/pallas/spmm_kernel.py``, with their argument
layout, so each can be fed the arrays of its ``interpret=True`` twin:

* ``tiled_ell_spmm_t(tdata_t, tlocal_t, Bt)`` -> ``[kp, R]``: ``(A @ B)^T``
  with ``Bt = B^T`` padded to ``[kp, ntiles * col_tile]``.
* ``tiled_ell_rmv_t(tdata_t, tlocal_t, Ct)`` -> ``[ntiles * col_tile, kp]``:
  ``A^T @ C`` from the same row-major payload, with ``Ct = C^T`` padded to
  ``[kp, R]``.

The payload is the transposed column-tiled padded-ELL layout of
``ops/densify.py`` (``[ntiles * wt, R]`` values and int32 tile-local ids,
padding slots ``(0, 0)``). ``kp`` is a multiple of 8 and ``R`` of
``block_rows``, as the JAX wrappers assert.

**Routes.** On CUDA tensors each wrapper launches its hand-written Hopper
kernel (``csrc/tiled_ell_spmm.cu``, built with nvcc for ``sm_90a`` on first
use) or raises; on CPU tensors it runs its ``*_plain`` twin. The kernels
take bf16 or float32 payloads and operands and accumulate and return
float32; float64 and non-contiguous inputs are refused, as
``_check_mosaic_dtype`` refuses 64-bit payloads on the TPU, and so are
payloads whose rows (``R``) are not a multiple of 8 or whose storage is
not 16-byte aligned, which the kernels' bulk copies need. Each slot's
product ``v * x`` is formed in float32, so a bf16 payload against a
float32 operand is an f32-class product in one call (the TPU kernel's
matrix unit rounds an f32 operand to bf16, which is why the JAX operator
splits operands into three bf16 terms).

Before each launch the wrapper lays the operand out for the kernel, in
its own dtype: spmm's ``Bt`` tile-major (:func:`_spmm_operand`), rmv's
``Ct`` back to the rows of ``C`` (:func:`_rmv_operand`); a launch plan
(:func:`_spmm_plan`, :func:`_rmv_plan`) fixes the block shape and the
shared memory, which must fit the card's 232,448 bytes.

The plain versions are the TPU kernels' arithmetic in plain PyTorch: the
one-hot densify of a group of column tiles
(:func:`~.densify.tiled_ell_densify_t_plain`), then a float32 (float64 for
float64 payloads) contraction per group. They run on any device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_lib
from .cuda_lib import launch_counts, reset_launch_counts  # noqa: F401
from .densify import tiled_ell_densify_t_plain

__all__ = [
    "tiled_ell_spmm_t",
    "tiled_ell_spmm_t_plain",
    "tiled_ell_rmv_t",
    "tiled_ell_rmv_t_plain",
    "launch_counts",
    "reset_launch_counts",
]

DEFAULT_COL_TILE = 256
DEFAULT_BLOCK_ROWS = 1024
MAX_COL_TILE = 1024
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block can use
_PLAIN_GROUP_BYTES = 256 << 20  # dense one-hot slab of one plain-version step


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tiled_ell_spmm_t_launch.argtypes = [
        p, p, p, p, ll, i, i, i, i, i, i, i, i, ll, i, i, p,
    ]
    lib.tiled_ell_spmm_t_launch.restype = i
    lib.tiled_ell_rmv_t_launch.argtypes = [
        p, p, p, p, p, ll, i, i, i, i, i, ll, i, i, i, i, ll, i, i, p,
    ]
    lib.tiled_ell_rmv_t_launch.restype = i


def _default_out_dtype(payload, operand):
    """The JAX wrappers' default: float32 for 16-bit payloads, else the
    payload's (spmm) or the operand's (rmv) dtype."""

    if payload.dtype.itemsize == 2:
        return torch.float32
    return torch.promote_types(payload.dtype, operand.dtype)


def _check(tdata, tlocal, op, *, wt, ntiles, col_tile, block_rows, op_width):
    if tdata.dim() != 2 or tlocal.shape != tdata.shape:
        raise ValueError(
            f"payload must be two [ntiles*wt, R] arrays, got "
            f"{tuple(tdata.shape)} and {tuple(tlocal.shape)}"
        )
    if tdata.shape[0] != ntiles * wt:
        raise ValueError(
            f"payload has {tdata.shape[0]} slot rows, expected ntiles*wt = {ntiles * wt}"
        )
    if tlocal.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {tlocal.dtype}")
    R = tdata.shape[1]
    if block_rows < 1 or R % block_rows:
        raise ValueError(f"R = {R} must be a multiple of block_rows = {block_rows}")
    if op.dim() != 2 or op.shape[0] % 8 or op.shape[1] != op_width:
        raise ValueError(
            f"operand must be [kp (a multiple of 8), {op_width}], got {tuple(op.shape)}"
        )
    if not (tdata.device == tlocal.device == op.device):
        raise ValueError("payload and operand must be on one device")


def _plain_groups(ntiles, col_tile, R):
    """Column-tile groups of the plain versions, each densified at once."""

    g = max(1, _PLAIN_GROUP_BYTES // max(col_tile * R * 4, 1))
    return [(t0, min(t0 + g, ntiles)) for t0 in range(0, ntiles, g)]


def _densify_group(tdata, tlocal, t0, t1, *, wt, col_tile, acc):
    return tiled_ell_densify_t_plain(
        tdata[t0 * wt:t1 * wt], tlocal[t0 * wt:t1 * wt], wt=wt, ntiles=t1 - t0,
        col_tile=col_tile, out_dtype=acc,
    )


def tiled_ell_spmm_t_plain(
    tdata_t: torch.Tensor,
    tlocal_t: torch.Tensor,
    Bt: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = DEFAULT_COL_TILE,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch ``(A @ B)^T`` -> ``[kp, R]``: one-hot densify, then
    ``Bt[:, tile] @ D`` accumulated over the column tiles."""

    _check(tdata_t, tlocal_t, Bt, wt=wt, ntiles=ntiles, col_tile=col_tile,
           block_rows=block_rows, op_width=ntiles * col_tile)
    out_dtype = out_dtype or _default_out_dtype(tdata_t, Bt)
    acc = torch.float64 if torch.float64 in (tdata_t.dtype, Bt.dtype) else torch.float32
    R = tdata_t.shape[1]
    out = torch.zeros((Bt.shape[0], R), dtype=acc, device=tdata_t.device)
    for t0, t1 in _plain_groups(ntiles, col_tile, R):
        D = _densify_group(tdata_t, tlocal_t, t0, t1, wt=wt, col_tile=col_tile, acc=acc)
        out += Bt[:, t0 * col_tile:t1 * col_tile].to(acc) @ D
    return out.to(out_dtype)


def tiled_ell_rmv_t_plain(
    tdata_t: torch.Tensor,
    tlocal_t: torch.Tensor,
    Ct: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = DEFAULT_COL_TILE,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain PyTorch ``A^T @ C`` -> ``[ntiles * col_tile, kp]``: one-hot
    densify, then ``D @ Ct^T`` per group of column tiles."""

    R = tdata_t.shape[1]
    _check(tdata_t, tlocal_t, Ct, wt=wt, ntiles=ntiles, col_tile=col_tile,
           block_rows=block_rows, op_width=R)
    out_dtype = out_dtype or _default_out_dtype(tdata_t, Ct)
    acc = torch.float64 if torch.float64 in (tdata_t.dtype, Ct.dtype) else torch.float32
    out = torch.empty((ntiles * col_tile, Ct.shape[0]), dtype=acc, device=tdata_t.device)
    CtT = Ct.to(acc).T
    for t0, t1 in _plain_groups(ntiles, col_tile, R):
        D = _densify_group(tdata_t, tlocal_t, t0, t1, wt=wt, col_tile=col_tile, acc=acc)
        out[t0 * col_tile:t1 * col_tile] = D @ CtT
    return out.to(out_dtype)


def _check_cuda(name, tdata, tlocal, op, out_dtype):
    if tdata.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, got {tdata.device}")
    if tdata.dtype not in _KERNEL_DTYPES or op.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"the CUDA {name} kernel takes bf16 or float32 payloads and operands, "
            f"got {tdata.dtype} and {op.dtype}"
        )
    if out_dtype not in (None, torch.float32):
        raise TypeError(f"the CUDA {name} kernel returns float32, not {out_dtype}")
    if not (tdata.is_contiguous() and tlocal.is_contiguous() and op.is_contiguous()):
        raise ValueError(f"the CUDA {name} kernel needs contiguous inputs")
    if tdata.shape[1] % 8 or tdata.data_ptr() % 16 or tlocal.data_ptr() % 16:
        raise ValueError(
            f"the CUDA {name} kernel copies payload rows in 16-byte units: R must be a "
            f"multiple of 8 and the payload 16-byte aligned (R = {tdata.shape[1]})"
        )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_plan_args(kp: int, col_tile: int) -> None:
    if kp < 8 or kp % 8:
        raise ValueError(f"kp must be a positive multiple of 8, got {kp}")
    if not 1 <= col_tile <= MAX_COL_TILE:
        raise ValueError(f"col_tile must be in [1, {MAX_COL_TILE}], got {col_tile}")


class SpmmPlan(NamedTuple):
    kc: int  # output columns per block (register accumulators): 16, 32 or 64
    rows: int  # rows per block, one per consumer thread
    slots: int  # payload slots per pipeline stage
    stages: int  # payload stages in the ring (the operand ring has 2)
    smem: int  # bytes of shared memory a block uses


_SPMM_ROWS = (512, 256, 128)
_SPMM_STAGES = (3, 2)
_SPMM_SLOTS = 16
_SPMM_BAR_BYTES = 128  # the kernel's mbarriers


def _spmm_plan(wt: int, col_tile: int, kp: int, payload_dtype, operand_dtype) -> SpmmPlan:
    """The spmm launch: the widest output chunk (up to 64) that kp needs,
    then the most rows per block and payload stages whose shared memory
    (two [col_tile, kc] operand stages plus the payload stages) fits;
    narrower chunks only where nothing else fits."""

    _check_plan_args(kp, col_tile)
    psize = payload_dtype.itemsize + 4  # value + int32 id
    osize = operand_dtype.itemsize
    slots = max(1, min(wt, _SPMM_SLOTS))
    kc = 16 if kp <= 16 else 32 if kp <= 32 else 64
    while kc >= 16:
        for rows in _SPMM_ROWS:
            for stages in _SPMM_STAGES:
                smem = (_SPMM_BAR_BYTES + 2 * col_tile * kc * osize
                        + stages * slots * rows * psize)
                if smem <= _SMEM_LIMIT:
                    return SpmmPlan(kc, rows, slots, stages, smem)
        kc //= 2
    raise ValueError(f"no spmm launch fits col_tile = {col_tile}")


class RmvPlan(NamedTuple):
    kc: int  # output columns per block (register accumulators of a thread): 32 or 64
    chunks: int  # output column chunks, ceil(kp / kc)
    col_groups: int  # 256-column groups of a tile, ceil(col_tile / 256)
    rows: int  # rows per range, a multiple of 256
    nranges: int  # row ranges, ceil(R / rows)
    stages: int  # payload stages in shared memory: 2 where two blocks still fit a SM
    smem: int  # bytes of shared memory a block uses


_RMV_ROWS = 256  # rows per item (threads per block)
_RMV_COLS = 256  # columns per group
_RMV_SLOTS = 16  # slots per item
_RMV_BLOCKS = 1024  # blocks the row ranges aim for
_RMV_BAR_BYTES = 128  # the kernel's mbarriers
_SM_SMEM = 233_472  # bytes of shared memory a SM holds, 1,024 of them reserved per block


def _rmv_plan(R: int, kp: int, ntiles: int, col_tile: int, payload_dtype=torch.bfloat16,
              operand_dtype=torch.bfloat16) -> RmvPlan:
    """The rmv launch: 64 output columns per block when kp > 32, else 32;
    row ranges of 256-row multiples so that the grid holds ~1024 blocks
    (their [ntiles * col_tile, kp] partial sums are added in range order);
    two payload stages where two thread blocks still fit a SM, else one
    where that lets two fit, else two."""

    _check_plan_args(kp, col_tile)
    kc = 64 if kp > 32 else 32
    chunks, groups = _cdiv(kp, kc), _cdiv(col_tile, _RMV_COLS)
    target = max(1, _cdiv(_RMV_BLOCKS, ntiles * chunks * groups))
    rows = _cdiv(max(_cdiv(R, target), 1), _RMV_ROWS) * _RMV_ROWS
    ent = 4 if payload_dtype == torch.bfloat16 else 8  # packed (value, row)
    # the item buffer (per warp: bucket starts, a 16-byte multiple of ints,
    # and the warp's entries), the operand block and the payload stages
    warps = _RMV_ROWS // 32
    fixed = (_RMV_BAR_BYTES + warps * (4 * (_RMV_COLS + 4) + 32 * _RMV_SLOTS * ent)
             + _RMV_ROWS * kc * operand_dtype.itemsize)
    stage = _RMV_SLOTS * _RMV_ROWS * (payload_dtype.itemsize + 4)
    stages = next((s for s in (2, 1) if 2 * (fixed + s * stage + 1024) <= _SM_SMEM), 2)
    return RmvPlan(kc, chunks, groups, rows, max(_cdiv(R, rows), 1), stages,
                   fixed + stages * stage)


def _swizzle(x: torch.Tensor) -> torch.Tensor:
    """``x [..., n, kc]`` with the 16-byte units of each row ``r`` (last
    axis) permuted: unit ``u`` is stored at unit ``u ^ (r & m)``, ``m =
    min(units per row, 8) - 1``. The kernels read unit u of row r at
    ``u ^ (r & m)``, so the rows that the lanes of a warp gather fall on
    different shared-memory banks."""

    n, kc = x.shape[-2:]
    per = 16 // x.element_size()  # elements per 16-byte unit
    units = kc // per
    mask = min(units, 8) - 1
    if not mask:
        return x.contiguous()
    period = 8 if n % 8 == 0 else n  # the permutation repeats every 8 rows
    dev = x.device
    r = torch.arange(period, device=dev)
    unit = torch.arange(units, device=dev)[None, :] ^ (r[:, None] & mask)
    idx = (unit[:, :, None] * per + torch.arange(per, device=dev)).reshape(period, kc)
    xr = x.reshape(*x.shape[:-2], n // period, period, kc)
    return torch.gather(xr, -1, idx.expand(xr.shape)).reshape(x.shape)


def _spmm_operand(Bt: torch.Tensor, ntiles: int, col_tile: int, kc: int) -> torch.Tensor:
    """``Bt [kp, ntiles*col_tile]`` -> ``[nch, ntiles, col_tile, kc]`` in
    Bt's dtype, nch = ceil(kp / kc): zero-padded to nch*kc output columns,
    tile-major, so each (chunk, tile) operand block is one contiguous copy,
    and swizzled by tile column (:func:`_swizzle`)."""

    kp = Bt.shape[0]
    nch = _cdiv(kp, kc)
    x = Bt
    if nch * kc != kp:
        x = Bt.new_zeros((nch * kc, ntiles * col_tile))
        x[:kp] = Bt
    return _swizzle(x.view(nch, kc, ntiles, col_tile).permute(0, 2, 3, 1))


def _rmv_operand(Ct: torch.Tensor, kc: int) -> torch.Tensor:
    """``Ct [kp, R]`` -> ``[nch, R, kc]`` in Ct's dtype, nch = ceil(kp /
    kc): the rows of ``C``, zero-padded to nch*kc columns, chunk by chunk,
    so a block of rows is one contiguous copy, and swizzled by row
    (:func:`_swizzle`)."""

    kp, R = Ct.shape
    nch = _cdiv(kp, kc)
    x = Ct
    if nch * kc != kp:
        x = Ct.new_zeros((nch * kc, R))
        x[:kp] = Ct
    return _swizzle(x.view(nch, kc, R).transpose(1, 2))


def tiled_ell_spmm_t(
    tdata_t: torch.Tensor,
    tlocal_t: torch.Tensor,
    Bt: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = DEFAULT_COL_TILE,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``out[k, r] = sum_nnz v * B[col, k]`` -> ``[kp, R]`` (see the module
    docs). CUDA tensors run the Hopper kernel and raise on anything it does
    not take; CPU tensors run :func:`tiled_ell_spmm_t_plain`."""

    kw = dict(wt=wt, ntiles=ntiles, col_tile=col_tile, block_rows=block_rows)
    if tdata_t.device.type == "cpu":
        return tiled_ell_spmm_t_plain(tdata_t, tlocal_t, Bt, out_dtype=out_dtype, **kw)
    _check(tdata_t, tlocal_t, Bt, op_width=ntiles * col_tile, **kw)
    _check_cuda("tiled_ell_spmm_t", tdata_t, tlocal_t, Bt, out_dtype)
    R, kp = tdata_t.shape[1], Bt.shape[0]
    plan = _spmm_plan(wt, col_tile, kp, tdata_t.dtype, Bt.dtype)
    out = torch.empty((kp, R), dtype=torch.float32, device=tdata_t.device)
    if R == 0:
        return out
    lib = cuda_lib.load("tiled_ell_spmm", _bind)
    with torch.cuda.device(tdata_t.device):
        bt = _spmm_operand(Bt, ntiles, col_tile, plan.kc)
        err = lib.tiled_ell_spmm_t_launch(
            tdata_t.data_ptr(), tlocal_t.data_ptr(), bt.data_ptr(), out.data_ptr(),
            R, wt, ntiles, col_tile, kp, plan.kc, plan.rows, plan.slots, plan.stages,
            plan.smem, int(tdata_t.dtype == torch.bfloat16),
            int(Bt.dtype == torch.bfloat16), cuda_lib.stream_of(tdata_t),
        )
    if err != 0:
        raise RuntimeError(f"tiled_ell_spmm_t launch failed: cudaError {err}")
    launch_counts["tiled_ell_spmm_t"] += 1
    return out


def tiled_ell_rmv_t(
    tdata_t: torch.Tensor,
    tlocal_t: torch.Tensor,
    Ct: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = DEFAULT_COL_TILE,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``out[c, k] = sum_nnz v(r, c) * C[r, k]`` -> ``[ntiles * col_tile,
    kp]`` (see the module docs). CUDA tensors run the Hopper kernel and
    raise on anything it does not take; CPU tensors run
    :func:`tiled_ell_rmv_t_plain`."""

    kw = dict(wt=wt, ntiles=ntiles, col_tile=col_tile, block_rows=block_rows)
    if tdata_t.device.type == "cpu":
        return tiled_ell_rmv_t_plain(tdata_t, tlocal_t, Ct, out_dtype=out_dtype, **kw)
    R, kp = tdata_t.shape[1], Ct.shape[0]
    _check(tdata_t, tlocal_t, Ct, op_width=R, **kw)
    _check_cuda("tiled_ell_rmv_t", tdata_t, tlocal_t, Ct, out_dtype)
    plan = _rmv_plan(R, kp, ntiles, col_tile, tdata_t.dtype, Ct.dtype)
    out = torch.empty((ntiles * col_tile, kp), dtype=torch.float32, device=tdata_t.device)
    if R == 0:
        return out.zero_()
    part = out
    if plan.nranges > 1:
        part = torch.empty((plan.nranges, ntiles * col_tile, kp), dtype=torch.float32,
                           device=tdata_t.device)
    lib = cuda_lib.load("tiled_ell_spmm", _bind)
    with torch.cuda.device(tdata_t.device):
        cop = _rmv_operand(Ct, plan.kc)
        err = lib.tiled_ell_rmv_t_launch(
            tdata_t.data_ptr(), tlocal_t.data_ptr(), cop.data_ptr(), part.data_ptr(),
            out.data_ptr(), R, wt, ntiles, col_tile, kp, plan.kc, plan.rows,
            plan.nranges, plan.chunks, plan.col_groups, plan.stages, plan.smem,
            int(tdata_t.dtype == torch.bfloat16), int(Ct.dtype == torch.bfloat16),
            cuda_lib.stream_of(tdata_t),
        )
    if err != 0:
        raise RuntimeError(f"tiled_ell_rmv_t launch failed: cudaError {err}")
    launch_counts["tiled_ell_rmv_t"] += 1
    return out
