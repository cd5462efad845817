"""``tiled_ell_densify_t``: the Gram engine's densify kernel and its twin.

Counterpart of the Pallas kernel ``tiled_ell_densify_t`` in
``single_algebra_tpu/ops/pallas/spmm_kernel.py``.

**Payload.** The column-tiled padded-ELL layout in transposed
orientation: ``tdata``/``tlocal`` are ``[ntiles * wt, ld]`` float32
values and int32 tile-local column ids; slot ``w`` of tile ``t`` for
row ``r`` sits at ``[t * wt + w, r]``. Padding slots are ``(0, 0)``.

**Result.** One row slab ``[row_offset, row_offset + rows)`` expanded to
the dense transposed ``[ntiles * col_tile, rows]`` array in ``out_dtype``
(int8, bf16 or f32): entry ``[t * col_tile + c, r]`` is the float32 sum
of the row's tile-``t`` values whose id is ``c``, in slot order, cast
once. Ids outside ``[0, col_tile)`` contribute nothing. The slab is a
window into the bucket payload (offset and stride), so a slab costs no
copy of its payload.

**Routes.** On CUDA tensors :func:`tiled_ell_densify_t` launches a
hand-written Hopper kernel of ``csrc/tiled_ell_densify.cu`` (built with
``nvcc`` for ``sm_90a`` on first use, bound with ctypes) or raises; on
CPU tensors it runs :func:`tiled_ell_densify_t_plain`, the one-hot
select-add of the TPU kernel in plain PyTorch. All give bit-identical
results. The kernel (the tile kernel of the source's note) forms each
id's sum in registers, stages the tile in the output type and writes it
with 16-byte vector stores; rows wider than 16 slots are taken 16 slots
at a time by the same kernel. :func:`tiled_ell_densify_t_warp` launches
the port's first densify kernel (one warp a block, a float32 accumulator
tile in shared memory): no path of the package calls it, it is the
reference the kernel is held to on the card. The kernels take float32
payloads only: the Gram engine's host build always produces float32
payloads, and a float64 payload is refused rather than silently
narrowed. The plain version also takes float64 (the tiled engine's
float64 payloads on the CPU). The nvcc build, the ctypes loading and the
launch counts are shared with the other kernels (``ops/cuda_lib.py``).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cuda_lib import densify_launches_by_dtype, launch_counts, reset_launch_counts  # noqa: F401

__all__ = [
    "tiled_ell_densify_t",
    "tiled_ell_densify_t_plain",
    "tiled_ell_densify_t_warp",
    "launch_counts",
    "reset_launch_counts",
]

_OUT_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_ROW_MULTIPLE = 32  # slab rows come in whole warps
MAX_COL_TILE = 1024  # the reference kernel's [col_tile, 32] f32 accumulator = 128 KB


def _bind(lib) -> None:
    for fn in (lib.tiled_ell_densify_t_f32, lib.tiled_ell_densify_t_warp_f32):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int


def _check(tdata, tlocal, wt, ntiles, col_tile, out_dtype, row_offset, rows):
    if tdata.dim() != 2 or tlocal.shape != tdata.shape:
        raise ValueError(
            f"payload must be two [ntiles*wt, R] arrays, got "
            f"{tuple(tdata.shape)} and {tuple(tlocal.shape)}"
        )
    if tdata.shape[0] != ntiles * wt:
        raise ValueError(
            f"payload has {tdata.shape[0]} slot rows, expected "
            f"ntiles*wt = {ntiles * wt}"
        )
    if tlocal.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {tlocal.dtype}")
    if out_dtype not in _OUT_KIND and out_dtype != torch.float64:
        raise TypeError(
            f"out_dtype must be int8, bfloat16, float32 or float64, got {out_dtype}"
        )
    if rows is None:
        rows = tdata.shape[1] - row_offset
    if row_offset < 0 or rows < 0 or row_offset + rows > tdata.shape[1]:
        raise ValueError(
            f"slab [{row_offset}, {row_offset + rows}) outside the payload's "
            f"{tdata.shape[1]} rows"
        )
    if tdata.device != tlocal.device:
        raise ValueError("values and ids must be on one device")
    return rows


def tiled_ell_densify_t_plain(
    tdata: torch.Tensor,
    tlocal: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = 256,
    out_dtype: torch.dtype = torch.bfloat16,
    row_offset: int = 0,
    rows: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: the one-hot select-add over the ``wt`` slots
    in slot order (``_onehot_densify`` of the TPU kernel), accumulated in
    float32 (float64 for a float64 ``out_dtype``) and cast once. Runs on
    any device.

    Each slot's select-add is one scatter-add of its values into their
    columns: the one-hot form adds +0 to every other column, which leaves
    a sum that starts at +0 unchanged, so both give the same bits. An id
    outside ``[0, col_tile)`` selects no column: it adds +0 to column 0."""

    rows = _check(tdata, tlocal, wt, ntiles, col_tile, out_dtype, row_offset, rows)
    acc = torch.float64 if out_dtype == torch.float64 else torch.float32
    td = tdata[:, row_offset:row_offset + rows].to(acc).reshape(ntiles, wt, rows)
    tl = tlocal[:, row_offset:row_offset + rows].reshape(ntiles, wt, rows)
    dense = torch.zeros((ntiles, col_tile, rows), dtype=acc, device=tdata.device)
    zero = torch.zeros((), dtype=acc, device=tdata.device)
    for w in range(wt):
        ids = tl[:, w:w + 1]
        inside = (ids >= 0) & (ids < col_tile)
        dense.scatter_add_(1, torch.where(inside, ids, 0).long(),
                           torch.where(inside, td[:, w:w + 1], zero))
    dense = dense.reshape(ntiles * col_tile, rows)
    if out_dtype == torch.int8:
        # saturating, NaN -> 0: XLA's float -> int8 convert
        dense = torch.nan_to_num(dense, nan=0.0).clamp_(-128, 127)
    return dense.to(out_dtype)


def tiled_ell_densify_t(
    tdata: torch.Tensor,
    tlocal: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = 256,
    out_dtype: torch.dtype = torch.bfloat16,
    row_offset: int = 0,
    rows: int | None = None,
) -> torch.Tensor:
    """Densify slab ``[row_offset, row_offset + rows)`` of the payload to
    ``[ntiles * col_tile, rows]`` (see the module docs). CUDA tensors run
    the Hopper kernel and raise on anything it does not take; CPU tensors
    run :func:`tiled_ell_densify_t_plain`."""

    if tdata.device.type == "cpu" and tlocal.device.type == "cpu":
        return tiled_ell_densify_t_plain(
            tdata, tlocal, wt=wt, ntiles=ntiles, col_tile=col_tile,
            out_dtype=out_dtype, row_offset=row_offset, rows=rows,
        )
    out = _launch("tiled_ell_densify_t_f32", tdata, tlocal, wt, ntiles, col_tile,
                  out_dtype, row_offset, rows)
    if out.numel():
        launch_counts["tiled_ell_densify_t"] += 1
        name = str(out_dtype).split(".")[-1]
        densify_launches_by_dtype[name] = densify_launches_by_dtype.get(name, 0) + 1
    return out


def tiled_ell_densify_t_warp(
    tdata: torch.Tensor,
    tlocal: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = 256,
    out_dtype: torch.dtype = torch.bfloat16,
    row_offset: int = 0,
    rows: int | None = None,
) -> torch.Tensor:
    """The same function through the port's first densify kernel (CUDA
    tensors only): the reference :func:`tiled_ell_densify_t` is held to.
    Its launches are not counted."""

    return _launch("tiled_ell_densify_t_warp_f32", tdata, tlocal, wt, ntiles,
                   col_tile, out_dtype, row_offset, rows)


def _launch(entry, tdata, tlocal, wt, ntiles, col_tile, out_dtype, row_offset, rows):
    """Check the arguments and launch the library's kernel ``entry`` on the
    tensors' card."""

    if tdata.device.type != "cuda":
        raise ValueError(f"the densify kernels run on CUDA tensors, got {tdata.device}")
    rows = _check(tdata, tlocal, wt, ntiles, col_tile, out_dtype, row_offset, rows)
    if tdata.dtype != torch.float32 or out_dtype not in _OUT_KIND:
        raise TypeError(
            f"the CUDA densify kernels take float32 payloads and int8, bf16 or "
            f"float32 outputs, got {tdata.dtype} -> {out_dtype}"
        )
    if not (tdata.is_contiguous() and tlocal.is_contiguous()):
        raise ValueError("the CUDA densify kernels need contiguous payload arrays")
    if rows % _ROW_MULTIPLE or rows // _ROW_MULTIPLE > 65535:
        raise ValueError(
            f"slab rows must be a multiple of {_ROW_MULTIPLE} and at most "
            f"{65535 * _ROW_MULTIPLE}, got {rows}"
        )
    if not 1 <= col_tile <= MAX_COL_TILE:
        raise ValueError(f"col_tile must be in [1, {MAX_COL_TILE}], got {col_tile}")
    if wt < 1 or not 1 <= ntiles <= 65535:
        raise ValueError(
            f"wt must be positive and ntiles in [1, 65535], got {wt}, {ntiles}"
        )
    out = torch.empty(
        (ntiles * col_tile, rows), dtype=out_dtype, device=tdata.device
    )
    if rows == 0:
        return out
    lib = cuda_lib.load("tiled_ell_densify", _bind)
    with torch.cuda.device(tdata.device):
        stream = cuda_lib.stream_of(tdata)
        err = getattr(lib, entry)(
            tdata.data_ptr(), tlocal.data_ptr(), out.data_ptr(),
            tdata.shape[1], row_offset, rows, wt, ntiles, col_tile,
            _OUT_KIND[out_dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out
