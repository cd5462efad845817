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

**rmv's form.** The rmv kernel sums a bucketed form of the payload
(:class:`RmvForm`: each 256-row chunk's stored entries by column, their
offsets and a schedule of the columns over the kernel's warps), built by
:func:`tiled_ell_rmv_form` once per payload array. ``tiled_ell_rmv_t``
takes it as ``form=``; without one it builds it first (one wait on the
card, for the entries' count). A caller that keeps its payload keeps the
form (``TiledSparseOperator`` does). :func:`tiled_ell_rmv_form_plain` is
the form's plain reference.

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
    "RmvForm",
    "tiled_ell_rmv_form",
    "tiled_ell_rmv_form_plain",
    "rmv_form_nbytes",
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
        p, p, p, p, p, p, p, ll, i, i, i, i, ll, i, i, i, i, i, ll, i, i, p,
    ]
    lib.tiled_ell_rmv_t_launch.restype = i
    lib.tiled_ell_rmv_form_launch.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, i, i, p]
    lib.tiled_ell_rmv_form_launch.restype = i


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
    kc: int  # output columns per block: 32 or 64
    chunks: int  # output column chunks, ceil(kp / kc)
    col_groups: int  # 256-column groups of a tile, ceil(col_tile / 256)
    rows: int  # rows per range, a multiple of 256
    nranges: int  # row ranges, ceil(R / rows)
    stages: int  # piece stages in shared memory (2 to 4)
    smem: int  # bytes of shared memory a block uses


_RMV_ROWS = 256  # rows per item
_RMV_COLS = 256  # columns per group
_RMV_BLOCKS = 1024  # blocks the row ranges aim for
_RMV_BAR_BYTES = 128  # the kernel's mbarriers
# a piece stage: header, the column offsets of a group (256 + 4 int32), its
# schedule (256 bytes), 8 KB of entries and 16 bytes for the copy's alignment
_RMV_STAGE_BYTES = 16 + 4 * (_RMV_COLS + 4) + _RMV_COLS + 8192 + 16
_RMV_STAGES = (4, 3, 2)
_RMV_SCHED_COLS = 4  # a schedule's columns of similar counts, side by side


def _rmv_plan(R: int, kp: int, ntiles: int, col_tile: int,
              operand_dtype=torch.bfloat16) -> RmvPlan:
    """The rmv launch: 64 output columns per block when kp > 32, else 32;
    row ranges of 256-row multiples so that the grid holds ~1024 blocks
    (their [ntiles * col_tile, kp] partial sums are added in range order);
    one block a SM, with two [256, kc] operand stages, the [256, kc]
    float32 sums and the most piece stages (up to 4) that fit. The stages
    hold the form's bytes, so the payload's dtype does not change the
    plan."""

    _check_plan_args(kp, col_tile)
    kc = 64 if kp > 32 else 32
    chunks, groups = _cdiv(kp, kc), _cdiv(col_tile, _RMV_COLS)
    target = max(1, _cdiv(_RMV_BLOCKS, ntiles * chunks * groups))
    rows = _cdiv(max(_cdiv(R, target), 1), _RMV_ROWS) * _RMV_ROWS
    fixed = _RMV_BAR_BYTES + 2 * _RMV_ROWS * kc * operand_dtype.itemsize + 4 * _RMV_COLS * kc
    stages = next(s for s in _RMV_STAGES if fixed + s * _RMV_STAGE_BYTES <= _SMEM_LIMIT)
    return RmvPlan(kc, chunks, groups, rows, max(_cdiv(R, rows), 1), stages,
                   fixed + stages * _RMV_STAGE_BYTES)


class RmvForm(NamedTuple):
    """The bucketed form of one payload array, which ``tiled_ell_rmv_t``
    sums: item ``i = t * nrc + rc`` (``nrc = ceil(R / 256)``) is column tile
    ``t``'s rows ``[256 rc, 256 rc + 256)``. Its stored entries (``v != 0``,
    id in ``[0, col_tile)``; duplicate ids each keep theirs) lie from
    ``starts[i]`` on, by column, and within a column in (slot // 16, row //
    32, slot % 16, row % 32) order. ``entries`` is int32: per entry the bf16
    value bits over the row in the item (``bits << 16 | row``), or for a
    float32 payload two words (value bits, row); then 16 zero bytes.
    ``offsets[i, c]`` counts item i's entries before column c (its total
    from c = col_tile on)."""

    entries: torch.Tensor  # int32, flat
    offsets: torch.Tensor  # int32 [ntiles * nrc, round_up(col_tile + 1, 4)]
    starts: torch.Tensor  # int64 [ntiles * nrc + 1]
    schedule: torch.Tensor  # uint8 [ntiles * nrc, ceil(col_tile / 256), 256]
    dtype: torch.dtype  # the payload's: bfloat16 or float32
    R: int
    ntiles: int
    col_tile: int

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.entries, self.offsets, self.starts, self.schedule))


_FORM_PAD = 4  # int32 words of zeros after the entries: the kernel's copies end on 16 bytes


def rmv_form_nbytes(stored: int, R: int, ntiles: int, col_tile: int, dtype) -> int:
    """Bytes of the :class:`RmvForm` of a payload of ``R`` rows that
    stores ``stored`` entries (``RmvForm.nbytes`` of the built form)."""

    items = ntiles * _cdiv(R, _RMV_ROWS)
    words = 1 if dtype == torch.bfloat16 else 2
    ostride = -(-(col_tile + 1) // 4) * 4
    return (4 * (stored * words + _FORM_PAD) + items * 4 * ostride + 8 * (items + 1)
            + items * _cdiv(col_tile, _RMV_COLS) * _RMV_COLS)


def _form_geometry(tdata, tlocal, wt, ntiles, col_tile):
    if tdata.dim() != 2 or tlocal.shape != tdata.shape or tdata.shape[0] != ntiles * wt:
        raise ValueError(f"payload must be two [ntiles*wt, R] arrays, got "
                         f"{tuple(tdata.shape)} and {tuple(tlocal.shape)}")
    if tdata.dtype not in _KERNEL_DTYPES or tlocal.dtype != torch.int32:
        raise TypeError(f"a form takes bf16 or float32 values and int32 ids, got "
                        f"{tdata.dtype} and {tlocal.dtype}")
    if not 1 <= col_tile <= MAX_COL_TILE:
        raise ValueError(f"col_tile must be in [1, {MAX_COL_TILE}], got {col_tile}")
    R = tdata.shape[1]
    return R, ntiles * _cdiv(R, _RMV_ROWS), -(-(col_tile + 1) // 4) * 4


def tiled_ell_rmv_form_plain(
    tdata_t: torch.Tensor,
    tlocal_t: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = DEFAULT_COL_TILE,
) -> RmvForm:
    """Plain PyTorch :class:`RmvForm` of a payload (the form's reference):
    one sort of the stored slots by (item, column, order key)."""

    R, nitems, ostride = _form_geometry(tdata_t, tlocal_t, wt, ntiles, col_tile)
    dev, ct = tdata_t.device, col_tile
    nrc = nitems // max(ntiles, 1)
    v = tdata_t.reshape(ntiles, wt, R)
    ids = tlocal_t.reshape(ntiles, wt, R)
    t, w, r = ((v != 0) & (ids >= 0) & (ids < ct)).nonzero(as_tuple=True)
    col = ids[t, w, r].long()
    row = r % _RMV_ROWS
    cell = (t * nrc + r // _RMV_ROWS) * ct + col  # (item, column)
    order = (((w // 16) * 8 + row // 32) * 16 + w % 16) * 32 + row % 32
    perm = torch.argsort(cell * (_cdiv(wt, 16) * 4096) + order)
    counts = torch.bincount(cell, minlength=nitems * ct).view(nitems, ct)
    offsets = torch.empty((nitems, ostride), dtype=torch.int64, device=dev)
    offsets[:, 0] = 0
    offsets[:, 1:ct + 1] = counts.cumsum(1)
    offsets[:, ct + 1:] = offsets[:, ct:ct + 1]
    starts = torch.zeros(nitems + 1, dtype=torch.int64, device=dev)
    starts[1:] = counts.sum(1).cumsum(0)
    vals, rows = v[t, w, r][perm], row[perm]
    if tdata_t.dtype == torch.bfloat16:
        words = (vals.view(torch.int16).long() & 0xFFFF) << 16 | rows
        words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    else:
        words = torch.stack([vals.view(torch.int32), rows.to(torch.int32)], 1).reshape(-1)
    entries = torch.cat([words, torch.zeros(_FORM_PAD, dtype=torch.int32, device=dev)])
    return RmvForm(entries, offsets.to(torch.int32), starts, _schedule(counts, ct),
                   tdata_t.dtype, R, ntiles, ct)


def _schedule(counts: torch.Tensor, ct: int) -> torch.Tensor:
    """Per item and 256-column group, the group's columns by entry count,
    descending (ties: the higher column first), in quadruples dealt to the
    kernel's 16 warps in snake order: warp w sums the columns in slots ``16
    w`` .. ``16 w + 15``, round r's quadruple in slots ``16 w + 4 r`` ...
    -> uint8 [items, groups, 256]."""

    nitems, dev = counts.shape[0], counts.device
    ng = _cdiv(ct, _RMV_COLS)
    padded = torch.zeros((nitems, ng * _RMV_COLS), dtype=torch.int64, device=dev)
    padded[:, :ct] = counts
    col = torch.arange(_RMV_COLS, device=dev)
    keys = (padded.view(nitems, ng, _RMV_COLS) << 8 | col).sort(dim=2, descending=True).values
    i = torch.arange(_RMV_COLS, device=dev)
    r, pos = i // (16 * _RMV_SCHED_COLS), (i // _RMV_SCHED_COLS) % 16
    slot = 16 * torch.where(r % 2 == 1, 15 - pos, pos) + _RMV_SCHED_COLS * r + i % _RMV_SCHED_COLS
    sched = torch.empty((nitems, ng, _RMV_COLS), dtype=torch.uint8, device=dev)
    sched[:, :, slot] = (keys & 255).to(torch.uint8)
    return sched


def tiled_ell_rmv_form(
    tdata_t: torch.Tensor,
    tlocal_t: torch.Tensor,
    *,
    wt: int,
    ntiles: int,
    col_tile: int = DEFAULT_COL_TILE,
) -> RmvForm:
    """The :class:`RmvForm` of a payload, for ``tiled_ell_rmv_t(...,
    form=)``. CUDA tensors run the count and bucket kernels (one wait on the
    card between them, for the entries' count); CPU tensors the plain
    builder."""

    if tdata_t.device.type == "cpu":
        return tiled_ell_rmv_form_plain(tdata_t, tlocal_t, wt=wt, ntiles=ntiles,
                                        col_tile=col_tile)
    R, nitems, ostride = _form_geometry(tdata_t, tlocal_t, wt, ntiles, col_tile)
    if tdata_t.device != tlocal_t.device or tdata_t.device.type != "cuda":
        raise ValueError(f"a form is built on CPU or CUDA, the values and ids on one "
                         f"device, got {tdata_t.device} and {tlocal_t.device}")
    if not (tdata_t.is_contiguous() and tlocal_t.is_contiguous()):
        raise ValueError("the CUDA form kernels need a contiguous payload")
    dev = tdata_t.device
    starts = torch.zeros(nitems + 1, dtype=torch.int64, device=dev)
    words = 1 if tdata_t.dtype == torch.bfloat16 else 2  # int32 words an entry
    ng = _cdiv(col_tile, _RMV_COLS)
    if nitems == 0:
        return RmvForm(torch.zeros(_FORM_PAD, dtype=torch.int32, device=dev),
                       torch.zeros((0, ostride), dtype=torch.int32, device=dev), starts,
                       torch.zeros((0, ng, _RMV_COLS), dtype=torch.uint8, device=dev),
                       tdata_t.dtype, R, ntiles, col_tile)
    lib = cuda_lib.load("tiled_ell_spmm", _bind)
    bf16 = int(tdata_t.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = cuda_lib.stream_of(tdata_t)
        counts = torch.empty(nitems, dtype=torch.int64, device=dev)
        err = lib.tiled_ell_rmv_form_launch(
            tdata_t.data_ptr(), tlocal_t.data_ptr(), None, counts.data_ptr(), None, None, None,
            R, wt, ntiles, col_tile, ostride, bf16, stream,
        )
        if err != 0:
            raise RuntimeError(f"tiled_ell_rmv_form count launch failed: cudaError {err}")
        torch.cumsum(counts, 0, out=starts[1:])
        n = int(starts[-1])
        entries = torch.empty(n * words + _FORM_PAD, dtype=torch.int32, device=dev)
        entries[n * words:] = 0
        offsets = torch.empty((nitems, ostride), dtype=torch.int32, device=dev)
        schedule = torch.empty((nitems, ng, _RMV_COLS), dtype=torch.uint8, device=dev)
        err = lib.tiled_ell_rmv_form_launch(
            tdata_t.data_ptr(), tlocal_t.data_ptr(), starts.data_ptr(), None,
            entries.data_ptr(), offsets.data_ptr(), schedule.data_ptr(), R, wt, ntiles,
            col_tile, ostride, bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"tiled_ell_rmv_form bucket launch failed: cudaError {err}")
    launch_counts["tiled_ell_rmv_form"] += 1
    return RmvForm(entries, offsets, starts, schedule, tdata_t.dtype, R, ntiles, col_tile)


def _check_form(form: RmvForm, tdata, *, ntiles, col_tile) -> None:
    if not isinstance(form, RmvForm):
        raise TypeError(f"form must be an RmvForm, got {type(form).__name__}")
    got = (form.dtype, form.R, form.ntiles, form.col_tile, form.entries.device)
    want = (tdata.dtype, tdata.shape[1], ntiles, col_tile, tdata.device)
    if got != want:
        raise ValueError(f"the form is of another payload: (dtype, R, ntiles, col_tile, "
                         f"device) {got}, the payload's {want}")


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
    form: RmvForm | None = None,
) -> torch.Tensor:
    """``out[c, k] = sum_nnz v(r, c) * C[r, k]`` -> ``[ntiles * col_tile,
    kp]`` (see the module docs). CUDA tensors run the Hopper kernel over
    ``form``, the payload's :class:`RmvForm` (:func:`tiled_ell_rmv_form`),
    built first when none is given, and raise on anything it does not take;
    CPU tensors run :func:`tiled_ell_rmv_t_plain` (a form given is checked
    against the payload, not read)."""

    kw = dict(wt=wt, ntiles=ntiles, col_tile=col_tile, block_rows=block_rows)
    if tdata_t.device.type == "cpu":
        if form is not None:
            _check_form(form, tdata_t, ntiles=ntiles, col_tile=col_tile)
        return tiled_ell_rmv_t_plain(tdata_t, tlocal_t, Ct, out_dtype=out_dtype, **kw)
    R, kp = tdata_t.shape[1], Ct.shape[0]
    _check(tdata_t, tlocal_t, Ct, op_width=R, **kw)
    _check_cuda("tiled_ell_rmv_t", tdata_t, tlocal_t, Ct, out_dtype)
    plan = _rmv_plan(R, kp, ntiles, col_tile, Ct.dtype)
    out = torch.empty((ntiles * col_tile, kp), dtype=torch.float32, device=tdata_t.device)
    if R == 0:
        return out.zero_()
    if form is None:
        form = tiled_ell_rmv_form(tdata_t, tlocal_t, wt=wt, ntiles=ntiles, col_tile=col_tile)
    _check_form(form, tdata_t, ntiles=ntiles, col_tile=col_tile)
    if any(a.data_ptr() % 16 for a in (form.entries, form.offsets, form.schedule)):
        raise ValueError("the CUDA rmv kernel copies the form in 16-byte units: its "
                         "entries, offsets and schedule must be 16-byte aligned")
    part = out
    if plan.nranges > 1:
        part = torch.empty((plan.nranges, ntiles * col_tile, kp), dtype=torch.float32,
                           device=tdata_t.device)
    lib = cuda_lib.load("tiled_ell_spmm", _bind)
    with torch.cuda.device(tdata_t.device):
        cop = _rmv_operand(Ct, plan.kc)
        err = lib.tiled_ell_rmv_t_launch(
            form.entries.data_ptr(), form.offsets.data_ptr(), form.starts.data_ptr(),
            form.schedule.data_ptr(), cop.data_ptr(), part.data_ptr(), out.data_ptr(), R,
            ntiles, col_tile, kp, plan.kc, plan.rows, plan.nranges, plan.chunks,
            plan.col_groups, plan.stages,
            form.offsets.shape[1], plan.smem, int(tdata_t.dtype == torch.bfloat16),
            int(Ct.dtype == torch.bfloat16), cuda_lib.stream_of(tdata_t),
        )
    if err != 0:
        raise RuntimeError(f"tiled_ell_rmv_t launch failed: cudaError {err}")
    launch_counts["tiled_ell_rmv_t"] += 1
    return out
