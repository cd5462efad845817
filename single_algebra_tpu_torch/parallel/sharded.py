"""Row-sharded operators over a single-process device mesh.

Counterpart of ``single_algebra_tpu/parallel/sharded.py``. The JAX package
shards the cell (row) axis over a ``jax.sharding.Mesh`` with ``shard_map``
and one ``psum`` per ``A^T @ ...`` product. Here one process drives every
device of a :class:`Mesh`:

* **Slabs.** Row slab ``d`` (natural rows ``[d * rs, (d + 1) * rs)``, the
  JAX package's ``rs`` and padding) lives on ``mesh.devices[d]`` as a
  single-card operator of the port: the gather engine's
  ``SparseOperator`` over the slab's row ELL and its slab-local
  transposed ELL (:class:`ShardedSpMM`), the tiled engine's
  ``TiledSparseOperator`` over the slab's column-tiled payload, built
  with the global width plan (:class:`ShardedTiled`: the
  ``tiled_ell_spmm_t`` / ``tiled_ell_rmv_t`` kernels run per slab), or
  the densified engine's ``DensifiedOperator`` over the slab's dense
  bf16 rows (:class:`ShardedDensified`). The payload never moves.
* **Skinny arrays.** Operands and results (``B [p, k]``, ``C [n, k]``,
  the scores) live on the home device ``mesh.devices[0]``. ``mv`` copies
  ``B`` once to each distinct device and gathers the slabs' rows on the
  home device (no reduction); ``rmv`` sends each slab its rows of ``C``
  and adds the slabs' ``[p, k]`` parts with :func:`_psum`, the
  counterpart of every ``lax.psum``: on the home device, in slab order,
  so repeats are bit for bit equal. The solvers (``linalg/svd.py``,
  ``lanczos.py``, ``block_lanczos.py``) therefore run unchanged over a
  sharded operator, whose ``device`` is the home device: a sharded fit
  draws the single-card fit's sketch and start vector.
* **Repeated entries.** A mesh may name one device several times: the CPU
  tests hold 8 slabs on the host, a one-card machine 4 slabs on its card.
  Every slab's kernels then run on that device, and a copy between two
  entries of one device is no copy.

Nothing inside a product synchronizes the host, so the slabs' launches on
distinct cards overlap.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..linalg.operators import (
    DensifiedOperator,
    SparseOperator,
    TiledSparseOperator,
    form_charge,
    _coo_to_csr_arrays,
    _dense_zeros,
    _scatter_bf16,
)
from ..sparse import convert as _cv
from ..types import precision_policy

__all__ = [
    "Mesh",
    "make_mesh",
    "ShardedSpMM",
    "ShardedTiled",
    "ShardedDensified",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh of one process: slab ``d`` of a row-sharded
    array lives on ``devices[d]``. Entries may repeat a device.

    ``shape`` and ``axis_names`` read as the JAX mesh's do
    (``mesh.shape["rows"]`` is the slab count)."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "rows"

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where the skinny operands, the results and the reductions live."""

        return self.devices[0]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in mesh order."""

        return tuple(dict.fromkeys(self.devices))


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, axis_name: str = "rows",
              device: str = "cuda") -> Mesh:
    """A mesh of ``n_devices`` entries. ``device="cuda"``: the distinct
    cards ``cuda:0 .. cuda:n-1`` (all of them by default); raises when
    fewer are present than asked for, and never repeats a card. ``device=
    "cpu"``: ``n_devices`` (default 1) entries of the host, the
    counterpart of the JAX tests' forced host devices. A mesh that repeats
    a card is built with :class:`Mesh` directly."""

    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n < 1 or n > count:
            raise RuntimeError(
                f"make_mesh asked for {n} CUDA devices; {count} present "
                "(Mesh((cuda:0,) * n) repeats one card on purpose)"
            )
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be positive, got {n}")
        return Mesh((torch.device("cpu"),) * n, axis_name)
    raise ValueError(f"make_mesh builds CUDA or CPU meshes, not {device!r}")


def _psum(parts, home: torch.device) -> torch.Tensor:
    """Sum of the slabs' parts (any iterable, consumed one at a time) on
    ``home``, in slab order: the counterpart of ``lax.psum``. No part is
    written to, and only the running sum and the current part are held."""

    acc, owned = None, False
    for part in parts:
        part = part.to(home)
        if acc is None:
            acc = part
        elif owned:
            acc += part
        else:
            acc, owned = acc + part, True
        del part  # before the next part is made
    return acc


def _replicas(x: torch.Tensor, mesh: Mesh) -> dict:
    """``x`` on each distinct device of the mesh (``x`` itself where it
    already lies)."""

    return {dev: x.to(dev) for dev in mesh.distinct}


def mesh_budget_bytes(mesh: Mesh, per_device) -> int:
    """The memory budget of a mesh: ``per_device(device)`` summed over its
    DISTINCT devices. Entries that repeat a card share its memory, so a
    4-entry mesh on one card plans for that card's budget, not four."""

    return int(sum(per_device(dev) for dev in mesh.distinct))


def _slab_rows(indptr: np.ndarray, n: int, d: int, rs: int):
    """Host CSR rows of slab ``d``: ``(r0, r1, lo, hi, slab indptr)``,
    both bounds clamped to ``n`` (trailing slabs may be empty)."""

    r0, r1 = min(d * rs, n), min((d + 1) * rs, n)
    lo, hi = int(indptr[r0]), int(indptr[r1])
    s_ip = indptr[r0:r1 + 1] - lo if r1 > r0 else np.zeros(1, np.int64)
    return r0, r1, lo, hi, s_ip


class _RowSharded:
    """The products of a row-sharded operator from its per-slab operators
    (``slabs``, each ``[rs, p]`` on its mesh entry): ``mv``-like products
    gather the slabs' rows on the home device, ``rmv``-like products add
    the slabs' parts there (:func:`_psum`)."""

    slabs: Tuple[object, ...]
    shape: Tuple[int, int]
    rs: int  # natural rows of each slab
    mesh: Mesh

    @property
    def dtype(self):
        return self.slabs[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    @property
    def ndev(self) -> int:
        return len(self.slabs)

    def _mv_with(self, name: str, B: torch.Tensor) -> torch.Tensor:
        reps = _replicas(B, self.mesh)
        outs = [getattr(op, name)(reps[dev]) for op, dev in zip(self.slabs, self.mesh.devices)]
        home = self.mesh.home
        return torch.cat([o.to(home) for o in outs])[: self.shape[0]]

    def _rmv_with(self, name: str, C: torch.Tensor) -> torch.Tensor:
        rs, rows = self.rs, self.ndev * self.rs
        if C.shape[0] != rows:
            Cp = torch.zeros((rows, C.shape[1]), dtype=C.dtype, device=C.device)
            Cp[: C.shape[0]] = C
            C = Cp
        return _psum(
            (getattr(op, name)(C[d * rs:(d + 1) * rs].to(dev))
             for d, (op, dev) in enumerate(zip(self.slabs, self.mesh.devices))),
            self.mesh.home,
        )

    @precision_policy()
    def mv(self, B: torch.Tensor) -> torch.Tensor:
        """``A @ B`` -> ``[n, k]`` on the home device; no reduction."""

        return self._mv_with("mv", B)

    @precision_policy()
    def rmv(self, C: torch.Tensor) -> torch.Tensor:
        """``A^T @ C`` -> ``[p, k]`` on the home device; one reduction."""

        return self._rmv_with("rmv", C)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@dataclasses.dataclass
class ShardedSpMM(_RowSharded):
    """Row-sharded gather engine: slab ``d``'s row ELL ``[rs, Wr]`` and its
    slab-local transposed ELL ``[Pp, Wt]`` (widths padded to their maxima
    over all slabs, as the JAX package's uniform shapes) in one
    ``SparseOperator``, plus the transposed layout's row counts for the
    column statistics. ``rs = round_up(ceil(n / ndev), 8)``."""

    slabs: Tuple[SparseOperator, ...]
    tr_nnz: Tuple[torch.Tensor, ...]  # per slab [Pp] int32
    shape: Tuple[int, int]
    rs: int
    mesh: Mesh

    @classmethod
    def from_matrix(cls, m, mesh: Mesh, axis_name: str = "rows") -> "ShardedSpMM":
        n, p = m.shape
        ndev = mesh.shape[axis_name]
        rs = _cv.round_up(-(-n // ndev), 8)
        pp = _cv.pad_rows(p)
        indptr, indices, data = m._row_csr()

        rows, trs, wr, wt = [], [], 1, 1
        for d in range(ndev):
            r0, r1, lo, hi, s_ip = _slab_rows(indptr, n, d, rs)
            nr = r1 - r0
            s_idx, s_dat = indices[lo:hi], data[lo:hi]
            wr = max(wr, int(np.diff(s_ip).max()) if nr else 1)
            t = _cv.csr_transpose_numpy(s_ip, s_idx, s_dat, nr, p)
            wt = max(wt, int(np.diff(t[0]).max()) if len(t[1]) else 1)
            rows.append((s_ip, s_idx, s_dat, nr))
            trs.append(t)
        wr, wt = _cv.pad_width(wr), _cv.pad_width(wt)

        slabs, tr_nnz = [], []
        for d, dev in enumerate(mesh.devices):
            s_ip, s_idx, s_dat, nr = rows[d]
            if nr:
                rd, ri, _ = _cv.csr_to_ell_numpy(s_ip, s_idx, s_dat, nr, width=wr, rows_padded=rs)
            else:
                rd, ri = np.zeros((rs, wr), data.dtype), np.zeros((rs, wr), np.int32)
            t_ip, t_ix, t_dt = trs[d]
            td, ti, tn = _cv.csr_to_ell_numpy(t_ip, t_ix, t_dt, p, width=wt, rows_padded=pp)
            slabs.append(SparseOperator(_upload(rd, dev), _upload(ri, dev), _upload(td, dev),
                                        _upload(ti, dev), (rs, p)))
            tr_nnz.append(_upload(tn, dev))
        return cls(tuple(slabs), tuple(tr_nnz), (n, p), rs, mesh)

    @property
    def rows_per_shard(self) -> int:
        return self.rs

    @property
    def n_padded(self) -> int:
        return self.ndev * self.rs

    @precision_policy()
    def col_stats(self):
        """(sum, sum_sq, nnz_count) per column: width reductions of each
        slab's transposed ELL, then one reduction each."""

        home, p = self.mesh.home, self.shape[1]
        s = _psum((op.col_data.sum(dim=1) for op in self.slabs), home)
        sq = _psum(((op.col_data * op.col_data).sum(dim=1) for op in self.slabs), home)
        cnt = _psum((c for c in self.tr_nnz), home)
        return s[:p], sq[:p], cnt[:p]


@dataclasses.dataclass
class ShardedTiled(_RowSharded):
    """Row-sharded tiled engine: slab ``d``'s transposed column-tiled
    payload ``[nt * wt, Rsp]`` (bf16 hi, + bf16 lo unless the values are
    bf16-exact, while ``wt <= BF16_WT_MAX``), its mv-side overflow
    ``[Rsp, ovw]`` (global column ids) and its rmv-side overflow ``[Pp,
    ovtw]`` (slab-local row ids) in one ``TiledSparseOperator``: ``mv``
    launches ``tiled_ell_spmm_t`` per slab, ``rmv`` ``tiled_ell_rmv_t``
    per slab and one reduction.

    Every slab is converted with the GLOBAL width plan (the whole-matrix
    quantile width ``wt`` and overflow width ``ovw``;
    ``csr_to_tiled_ell_split_numpy(force_wt=, force_ov_w=)``) and padded
    to the JAX package's ``Rsp``: ``rs = ceil(n / ndev)`` rounded up to a
    multiple of 1,024 (the kernels' ``block_rows``) from 1,024 rows, else
    to 128. Column statistics are exact host moments (float64
    accumulation, cast to the matrix dtype)."""

    slabs: Tuple[TiledSparseOperator, ...]
    shape: Tuple[int, int]
    rs: int
    mesh: Mesh
    col_stats_host: tuple

    @staticmethod
    def _padded_rows(rs: int) -> Tuple[int, int]:
        """``(Rsp, block_rows)`` for ``rs`` natural rows per slab."""

        if rs >= 1024:
            return _cv.round_up(rs, 1024), 1024
        rsp = max(_cv.round_up(rs, 128), 128)
        return rsp, rsp

    @classmethod
    def from_matrix(cls, m, mesh: Mesh, axis_name: str = "rows",
                    col_tile: int | None = None) -> "ShardedTiled":
        n, p = m.shape
        ndev = mesh.shape[axis_name]
        rs = -(-n // ndev)
        rsp, br = cls._padded_rows(rs)
        ct = col_tile or TiledSparseOperator.COL_TILE
        pp = _cv.pad_rows(p)
        indptr, indices, data = m._row_csr()
        wt, nt, ovw, _ = m._tiled_widths(ct)

        host, ovt_csr, ovtw = [], [], 0
        for d in range(ndev):
            r0, r1, lo, hi, s_ip = _slab_rows(indptr, n, d, rs)
            td, tl, _, _, ovd, ovi, _ = _cv.csr_to_tiled_ell_split_numpy(
                s_ip, indices[lo:hi], data[lo:hi], r1 - r0, p, col_tile=ct,
                rows_padded_to=rsp, force_wt=wt, force_ov_w=ovw,
            )
            t = None
            if ovw:
                r_idx, w_idx = np.nonzero(ovd)
                t = _coo_to_csr_arrays(ovi[r_idx, w_idx], r_idx, ovd[r_idx, w_idx], p, rsp)
                if len(t[1]):
                    ovtw = max(ovtw, int(np.diff(t[0]).max()))
            host.append((td, tl, ovd, ovi))
            ovt_csr.append(t)
        ovtw = _cv.round_up(ovtw, 8) if ovtw else 0

        parts = []
        for d, dev in enumerate(mesh.devices):
            td, tl, ovd, ovi = host[d]
            if ovtw:
                otd, oti, _ = _cv.csr_to_ell_numpy(*ovt_csr[d], p, width=ovtw, rows_padded=pp)
            else:
                otd, oti = np.zeros((pp, 0), data.dtype), np.zeros((pp, 0), np.int32)
            hi, lo = TiledSparseOperator._split_payload(_upload(td, dev), wt)
            parts.append([hi, lo, _upload(tl, dev), _upload(ovd, dev), _upload(ovi, dev),
                          _upload(otd, dev), _upload(oti, dev)])
            host[d] = None  # each slab's host payload goes once it is uploaded
        if any(part[1] is not None for part in parts):
            # one payload dtype class for every slab: an exact slab's
            # residual is zero
            for part in parts:
                if part[1] is None:
                    part[1] = torch.zeros_like(part[0])
        meta = (wt, nt, ct, br, ovw, ovtw)
        slabs = tuple(TiledSparseOperator(*part, (rs, p), meta) for part in parts)

        s64, sq64 = m._host_col_stats()
        cnt = np.bincount(indices, minlength=p)[:p]
        dt = slabs[0].dtype
        home = mesh.home
        stats = (torch.as_tensor(s64, device=home).to(dt), torch.as_tensor(sq64, device=home).to(dt),
                 torch.as_tensor(cnt.astype(np.int32), device=home))
        return cls(slabs, (n, p), rs, mesh, stats)

    @property
    def meta(self) -> Tuple[int, int, int, int, int, int]:
        """``(wt, nt, ct, br, ovw, ovtw)``, every slab's."""

        return self.slabs[0].meta

    @property
    def rows_per_shard(self) -> int:
        """``Rsp``: each slab's payload rows."""

        return self.slabs[0].tdata.shape[1]

    @property
    def rows_natural(self) -> int:
        return self.rs

    @precision_policy()
    def mv_fast(self, B: torch.Tensor) -> torch.Tensor:
        """``A @ B`` with the hi payload by the bf16-rounded operand."""

        return self._mv_with("mv_fast", B)

    @precision_policy()
    def rmv_fast(self, C: torch.Tensor) -> torch.Tensor:
        """``A^T @ C`` with the hi payload by the bf16-rounded operand."""

        return self._rmv_with("rmv_fast", C)

    def col_stats(self):
        """(sum, sum_sq, nnz_count) per column: the exact host moments."""

        return self.col_stats_host

    @classmethod
    def payload_bytes(cls, m, ndev: int) -> int:
        """Device payload estimate of the sharded layout, charged as the
        JAX package charges it (values f32 + ids i32 for the main level
        and both overflow orientations)."""

        n, p = m.shape
        ct = TiledSparseOperator.COL_TILE
        wt, nt, ovw, _ = m._tiled_widths(ct)
        rsp, _ = cls._padded_rows(-(-n // ndev))
        main = ndev * nt * wt * rsp * 8
        over = ndev * rsp * ovw * 8
        if ovw:
            # rmv-side width: the whole-matrix per-column overflow maximum
            # (an upper bound on every slab's)
            ovtw = m._tiled_overflow_col_width(ct)
            over += ndev * _cv.pad_rows(p) * _cv.round_up(max(ovtw, 1), 8) * 8
        return main + over

    @classmethod
    def form_bytes(cls, m, ndev: int) -> int:
        """Device bytes of the slabs' rmv forms past :meth:`payload_bytes`
        on a CUDA mesh (``form_charge`` over every slab's rows)."""

        wt, nt, _, _ = m._tiled_widths(TiledSparseOperator.COL_TILE)
        rsp, _ = cls._padded_rows(-(-m.shape[0] // ndev))
        return form_charge(m, wt, nt, ndev * rsp)


@dataclasses.dataclass
class ShardedDensified(_RowSharded):
    """Row-sharded dense-bf16 engine: slab ``d``'s dense rows ``[rs, p]``
    (bf16 hi, + lo unless the values are bf16-exact) in one
    ``DensifiedOperator``, scattered on its device from the slab's CSR
    rows (the dense form of the whole matrix is never held in one place).
    ``rs = round_up(ceil(n / ndev), 8)``; padding rows are zero."""

    slabs: Tuple[DensifiedOperator, ...]
    shape: Tuple[int, int]
    rs: int
    mesh: Mesh

    @classmethod
    def from_matrix(cls, m, mesh: Mesh, axis_name: str = "rows") -> "ShardedDensified":
        n, p = m.shape
        ndev = mesh.shape[axis_name]
        rs = _cv.round_up(-(-n // ndev), 8)
        indptr, indices, data = m._row_csr()
        vals = np.ascontiguousarray(data, np.float32)
        halves = []
        for d, dev in enumerate(mesh.devices):
            r0, r1, lo, hi, s_ip = _slab_rows(indptr, n, d, rs)
            ip = np.full(rs + 1, s_ip[-1], np.int64)  # padding rows hold nothing
            ip[: len(s_ip)] = s_ip
            halves.append(list(_scatter_bf16(
                _upload(ip, dev), _upload(indices[lo:hi], dev), _upload(vals[lo:hi], dev),
                rs, p, DensifiedOperator._BLOCK_BYTES,
            )))
        if any(h[1] is not None for h in halves):
            for h in halves:
                if h[1] is None:  # an exact slab's residual is zero
                    h[1] = _dense_zeros(rs, p, h[0].device)[:, :p]
        slabs = tuple(DensifiedOperator(hi, lo, (rs, p)) for hi, lo in halves)
        return cls(slabs, (n, p), rs, mesh)

    @precision_policy()
    def mv_precise(self, B: torch.Tensor) -> torch.Tensor:
        """``A @ B`` at f32-class accuracy (both halves, three operand terms)."""

        return self._mv_with("mv_precise", B)

    @precision_policy()
    def rmv_precise(self, C: torch.Tensor) -> torch.Tensor:
        """``A^T @ C`` at f32-class accuracy; one reduction."""

        return self._rmv_with("rmv_precise", C)

    @precision_policy()
    def col_stats(self):
        """(sum, sum_sq) per column in float32: each slab's, then one
        reduction each."""

        stats = [op.col_stats() for op in self.slabs]
        home = self.mesh.home
        return _psum((s for s, _ in stats), home), _psum((sq for _, sq in stats), home)
