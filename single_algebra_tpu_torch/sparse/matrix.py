"""``SparseMatrix`` — the port's sparse container and its operation surface.

Counterpart of ``single_algebra_tpu/sparse/matrix.py``: one class with
the reference's statistics, ``Normalize`` / ``Log1P`` maps and products.

* The host keeps the major axis as numpy CSR (``indptr``/``indices``/
  ``data``): format conversion, scipy round trips, the transpose and the
  engines' host payload builds read it. ``from_scipy`` stays host-only.
* The **device layout** is the JAX container's padded-ELL grid
  (``ell_data``, ``ell_ids``, ``row_nnz``) along the major axis, on
  ``device``. It is built on the first call that needs it (a statistic, a
  map, a product) by ``convert.csr_to_ell_numpy`` plus one upload, and
  cached; ``ell_build_seconds`` keeps the two times. Major-axis
  statistics are masked reductions over it (``ops/stats.py``), minor-axis
  statistics the same reductions over the cached transpose.
* A value map (``normalize``, ``log1p_normalize``, ``map_stored``) returns
  a matrix whose values live on the device only: its host structure
  (``indptr``/``indices``) is kept and its host values are pulled once,
  from the ELL, by the first caller that needs them (``_csr_data_host``).
* The engines read the row-major host CSR through one seam,
  ``_row_csr``, and keep what they derive from it (column statistics,
  the Gram bucket plan, the tiled widths, the value gates) in one memo
  per matrix, ``_memo``.

Divergences from the reference, as in the JAX package:

* ``normalize``/``log1p`` return a **new** matrix instead of mutating;
  zero-sum lines stay untouched, as in the reference.
* ``sum_row_squared`` returns ``nrows`` values (the reference sizes it by
  ``ncols``).
* ``var_row`` divides by the length of the reduced axis, ``ncols`` (the
  reference divides row variances by ``nrows``).
* ``*_chunk`` methods are functional: they take the accumulator and
  return the updated value.

``device`` defaults to the card (``"cuda"``): device layouts and every
engine built from the matrix live there, and nothing switches to the CPU
behind the caller's back. CPU runs pass ``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..native import build as _native
from ..ops import stats as _st
from ..ops.spmm import ell_onehot_spmm, ell_spmm
from ..types import Direction, canonical_float_dtype, precision_policy, torch_dtype
from ..utils.tracing import count, span
from . import convert as _cv

__all__ = ["SparseMatrix", "csr_matrix", "csc_matrix", "random_sparse"]


def _log1p_fn(v, r, c):
    # torch.log1p is within 1 ULP of float64 on the CPU build; the card's
    # is measured by chip_smoke.py's log1p_ulp phase (ROADMAP records the
    # precise_math decision)
    return torch.log1p(v)


def _expm1_fn(v, r, c):
    # torch.expm1 is within 1 ULP of float64 on the CPU build
    # (tests/test_torch_feature_selection.py); the card's is measured by
    # chip_smoke.py's scrna phase (ROADMAP records the precise_math
    # decision)
    return torch.expm1(v)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SparseMatrix:
    """Host CSR (or CSC) structure plus a lazily built device padded-ELL
    layout on ``device``."""

    def __init__(
        self,
        indptr: Optional[np.ndarray],
        indices: Optional[np.ndarray],
        data: Optional[np.ndarray],
        shape: Tuple[int, int],
        fmt: str = "csr",
        device: torch.device | str = "cuda",
        *,
        ell: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
        nnz: Optional[int] = None,
    ):
        """``data`` None means the values live on the device only, in
        ``ell = (ell_data, ell_ids, row_nnz)``; ``indptr``/``indices`` None
        means the host structure is rebuilt from ``ell`` when needed."""

        if fmt not in ("csr", "csc"):
            raise ValueError(f"format must be 'csr' or 'csc', got {fmt!r}")
        if data is None and ell is None:
            raise ValueError("a matrix needs host values or a device layout")
        self._h_indptr = None if indptr is None else np.asarray(indptr, np.int64)
        self._h_indices = None if indices is None else np.asarray(indices, np.int32)
        self._h_data = None if data is None else np.asarray(data)
        self.shape = (int(shape[0]), int(shape[1]))
        self.format = fmt
        self.device = torch.device(device)
        self._nnz = int(len(self._h_indices)) if nnz is None else int(nnz)
        self._ell = ell
        self.ell_build_seconds: Optional[dict] = None
        self.pull_seconds: Optional[float] = None
        self._h_data_pulled: Optional[np.ndarray] = None
        self._transpose_cache: Optional["SparseMatrix"] = None
        self._operator_cache: dict = {}  # engine name -> operator
        self._derived: dict = {}  # _memo's: key -> what was derived from the CSR

    # -- factory methods -------------------------------------------------

    @classmethod
    def from_scipy(
        cls, mat, fmt: Optional[str] = None, dtype=None, device="cuda"
    ) -> "SparseMatrix":
        """Build from any scipy.sparse matrix. ``fmt`` selects the major
        layout ('csr' default, 'csc' for CSC inputs); float64 values stay
        float64, integer values become float32. ``device`` is where its
        device layouts and engines live: the card unless the caller names
        another. Nothing is uploaded here."""

        import scipy.sparse as sp

        with span("sparse.from_scipy"):
            if fmt is None:
                fmt = "csc" if sp.issparse(mat) and mat.format == "csc" else "csr"
            if dtype is not None:
                dt = canonical_float_dtype(dtype)
            elif np.issubdtype(mat.dtype, np.floating):
                dt = canonical_float_dtype(mat.dtype)
            else:
                dt = np.dtype(np.float32)
            major = mat.tocsr() if fmt == "csr" else mat.tocsc()
            major.sort_indices()
            return cls(
                major.indptr.astype(np.int64),
                major.indices.astype(np.int32),
                major.data.astype(dt),
                major.shape,
                fmt,
                device,
            )

    @classmethod
    def from_dense(cls, arr, fmt: str = "csr", dtype=None, device="cuda") -> "SparseMatrix":
        import scipy.sparse as sp

        arr = np.asarray(arr)
        mat = sp.csr_matrix(arr) if fmt == "csr" else sp.csc_matrix(arr)
        return cls.from_scipy(mat, fmt=fmt, dtype=dtype, device=device)

    @classmethod
    def from_coo(
        cls, rows, cols, vals, shape: Tuple[int, int], fmt: str = "csr",
        dtype=None, device="cuda",
    ) -> "SparseMatrix":
        import scipy.sparse as sp

        coo = sp.coo_matrix((vals, (rows, cols)), shape=shape)
        return cls.from_scipy(coo, fmt=fmt, dtype=dtype, device=device)

    @classmethod
    def from_ell_arrays(
        cls, ell_data, ell_ids, row_nnz, shape, nnz: int, fmt: str = "csr", *,
        h_indptr=None, h_indices=None, device="cuda",
    ) -> "SparseMatrix":
        """A matrix whose values live on ``device`` only, from numpy ELL
        arrays: e.g. a JAX ``SparseMatrix``'s ``np.asarray(m.ell_data)``,
        ``ell_ids`` and ``row_nnz`` after a value map, with its host
        structure (``m._h_indptr``/``m._h_indices``) when it has one."""

        def put(a, dtype):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:  # e.g. np.asarray of a JAX array
                a = a.copy()
            return torch.as_tensor(a, dtype=dtype, device=device)

        data = np.asarray(ell_data)
        ell = (put(data, torch_dtype(canonical_float_dtype(data.dtype))),
               put(ell_ids, torch.int32), put(row_nnz, torch.int32))
        return cls(h_indptr, h_indices, None, shape, fmt, device, ell=ell, nnz=nnz)

    def _with_ell(self, ell, fmt=None, shape=None, indptr=None, indices=None, nnz=None):
        """A device-valued matrix sharing this one's host structure unless
        given another."""

        return SparseMatrix(
            self._h_indptr if indptr is None else indptr,
            self._h_indices if indices is None else indices,
            None, self.shape if shape is None else shape, fmt or self.format,
            self.device, ell=ell, nnz=self.nnz if nnz is None else nnz,
        )

    # -- properties ------------------------------------------------------

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self._nnz

    @property
    def dtype(self) -> torch.dtype:
        if self._h_data is not None:
            return torch_dtype(self._h_data.dtype)
        return self._ell[0].dtype

    @property
    def n_major(self) -> int:
        """Logical length of the major (stored) axis."""

        return self.shape[0] if self.format == "csr" else self.shape[1]

    @property
    def n_minor(self) -> int:
        return self.shape[1] if self.format == "csr" else self.shape[0]

    # -- the device layout -------------------------------------------------

    def _device_layout(self):
        """``(ell_data, ell_ids, row_nnz)`` on ``device``: built from the
        host CSR on first use (host padded-ELL build, then one upload) and
        cached."""

        if self._ell is None:
            t0 = time.perf_counter()
            arrays = _cv.csr_to_ell_numpy(
                self._h_indptr, self._h_indices, self._h_data, self.n_major
            )
            t1 = time.perf_counter()
            self._ell = tuple(torch.from_numpy(a).to(self.device) for a in arrays)
            _sync(self.device)
            self.ell_build_seconds = {
                "host_build": t1 - t0, "upload": time.perf_counter() - t1,
            }
        return self._ell

    @property
    def ell_data(self) -> torch.Tensor:
        return self._device_layout()[0]

    @property
    def ell_ids(self) -> torch.Tensor:
        return self._device_layout()[1]

    @property
    def row_nnz(self) -> torch.Tensor:
        return self._device_layout()[2]

    @property
    def ell_width(self) -> int:
        return self.ell_data.shape[1]

    # -- host structure --------------------------------------------------

    def _require_host_structure(self):
        """Rebuild ``indptr``/``indices`` from the device layout when the
        matrix came without them (``from_ell_arrays``)."""

        if self._h_indptr is None or self._h_indices is None:
            _, ids, row_nnz = self._device_layout()
            nnz_line = row_nnz[: self.n_major].cpu().numpy().astype(np.int64)
            indptr = np.zeros(self.n_major + 1, dtype=np.int64)
            np.cumsum(nnz_line, out=indptr[1:])
            valid = _st.valid_mask(ids, row_nnz)
            self._h_indices = ids[valid].cpu().numpy().astype(np.int32)
            self._h_indptr = indptr

    def _csr_data_host(self) -> np.ndarray:
        """Stored values in major-CSR order (host numpy). A device-valued
        matrix pulls them from its ELL once (the valid slots, row by row,
        are CSR order) and keeps them; ``pull_seconds`` records the pull."""

        self._require_host_structure()
        if self._h_data is not None:
            return self._h_data
        if self._h_data_pulled is None:
            t0 = time.perf_counter()
            d, ids, row_nnz = self._device_layout()
            self._h_data_pulled = d[_st.valid_mask(ids, row_nnz)].cpu().numpy()
            self.pull_seconds = time.perf_counter() - t0
        return self._h_data_pulled

    # -- the engines' seam: the row-major host CSR and what is derived -------

    def _row_csr(self, values: bool = True):
        """``(indptr, indices, data)`` of the row-major host CSR (the
        transpose's for a column-major matrix). ``data`` is None unless
        ``values``: the structure alone never pulls a device-valued
        matrix's payload."""

        src = self._layout_for("row")
        src._require_host_structure()
        return src._h_indptr, src._h_indices, src._csr_data_host() if values else None

    def _memo(self, key, build):
        """``build()``, kept under ``key`` for the life of the matrix: the
        one memo of what the engines derive from its CSR."""

        if key not in self._derived:
            self._derived[key] = build()
        return self._derived[key]

    def _host_col_stats(self):
        """(sum_col, sum_col_squared) per column, float64 numpy, from the
        host CSR arrays; kept. float32 values take one threaded native pass
        (``native.build.csr_col_stats``), others, or no native library,
        numpy's two ``bincount``s; the span's ``route`` says which."""

        cached = self._derived.get("col_stats")
        with span("pca.host_col_stats", cached=cached is not None) as current:
            if cached is not None:
                return cached
            _, idx, data = self._row_csr()
            p = self.ncols
            stats = _native.csr_col_stats(data, idx, p)
            if stats is not None:
                current.set(route="native")
                count("pca.col_stats_native")
            else:
                current.set(route="numpy")
                data = data.astype(np.float64)
                stats = (np.bincount(idx, weights=data, minlength=p)[:p],
                         np.bincount(idx, weights=data * data, minlength=p)[:p])
            self._derived["col_stats"] = stats
            return stats

    def _tiled_widths(self, col_tile: int):
        """``(wt, ntiles, ov_w, n_overflow)`` of the two-level tiled layout
        at ``col_tile`` (``convert.tiled_split_widths``, one O(nnz) pass
        over the structure); kept per ``col_tile``."""

        def build():
            indptr, indices, _ = self._row_csr(values=False)
            return _cv.tiled_split_widths(indptr, indices, *self.shape, col_tile=col_tile)

        return self._memo(("tiled_widths", col_tile), build)

    def _tiled_overflow_col_width(self, col_tile: int) -> int:
        """The rmv-side overflow width of the tiled layout at ``col_tile``
        (``convert.tiled_overflow_col_width`` at its ``wt``); kept."""

        def build():
            indptr, indices, _ = self._row_csr(values=False)
            wt = self._tiled_widths(col_tile)[0]
            return _cv.tiled_overflow_col_width(indptr, indices, *self.shape, col_tile, wt)

        return self._memo(("tiled_overflow_col_width", col_tile), build)

    # -- value gates -------------------------------------------------------

    def values_bf16_exact(self) -> bool:
        """True when every stored value survives f32 -> bf16 round-tripping
        (raw counts always do) — the gate of the bf16 Gram tier. Decided on
        the device for a device-valued matrix (padding slots are zero, so
        exact), never by pulling its payload. Cached."""

        def build():
            if self._h_data is None:
                d = self.ell_data
                return bool(torch.equal(d.to(torch.bfloat16).to(d.dtype), d))
            v = np.ascontiguousarray(self._h_data, np.float32)
            lib = _native.get_lib()
            if lib is not None:
                return bool(lib.f32_bf16_exact(v, len(v)))
            t = torch.from_numpy(v)
            return bool(torch.equal(t.to(torch.bfloat16).to(torch.float32), t))

        return self._memo("bf16_exact", build)

    def values_int8_exact(self) -> bool:
        """True when every stored value is an integer in ``[-127, 127]`` —
        the gate of the int8 Gram tier (exact int8 x int8 -> int32 slab
        products). Decided on the device for a device-valued matrix.
        Cached."""

        def build():
            if self._h_data is None:
                d = self.ell_data
                return bool(((d.abs() <= 127) & (d == torch.round(d))).all())
            v = self._h_data
            return bool(np.all(np.abs(v) <= 127) and not np.any(v != np.rint(v)))

        return self._memo("int8_exact", build)

    # -- conversion ----------------------------------------------------------

    def to_scipy(self):
        import scipy.sparse as sp

        self._require_host_structure()
        ctor = sp.csr_matrix if self.format == "csr" else sp.csc_matrix
        return ctor(
            (self._csr_data_host(), self._h_indices, self._h_indptr), shape=self.shape
        )

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    # -- selection -----------------------------------------------------------

    def _as_selection(self, sel, axis_len: int, what: str) -> np.ndarray:
        sel = np.asarray(sel.cpu() if isinstance(sel, torch.Tensor) else sel)
        if sel.dtype == bool:
            if sel.shape[0] != axis_len:
                raise ValueError(
                    f"Mask length ({sel.shape[0]}) does not match number "
                    f"of {what} ({axis_len})"
                )
            return np.where(sel)[0].astype(np.int64)
        sel = sel.astype(np.int64)
        if sel.size and (sel.min() < 0 or sel.max() >= axis_len):
            raise ValueError(f"{what} indices must be in [0, {axis_len})")
        return sel

    def _select(self, sel, axis: str) -> "SparseMatrix":
        """Keep the given rows or columns (bool mask or index array, in the
        given order): the extraction runs on the host structure of the
        layout whose major axis is ``axis``. A device-valued matrix keeps
        its values on the device: they move by one gather."""

        import scipy.sparse as sp

        n_axis, what = (self.nrows, "rows") if axis == "row" else (self.ncols, "columns")
        idx = self._as_selection(sel, n_axis, what)
        base = self._layout_for(axis)
        base._require_host_structure()
        if base._h_data is None:
            out = base._select_major_structural(idx)
            return out if out.format == self.format else out.transpose()
        indptr, indices, data = _cv.extract_rows_csr(
            base._h_indptr, base._h_indices, base._h_data, idx
        )
        if axis == "row":
            out = sp.csr_matrix((data, indices, indptr), shape=(len(idx), self.ncols))
        else:
            out = sp.csc_matrix((data, indices, indptr), shape=(self.nrows, len(idx)))
        return SparseMatrix.from_scipy(out, fmt=self.format, device=self.device)

    def select_rows(self, sel) -> "SparseMatrix":
        """New matrix keeping the given rows (bool mask or index array)."""

        return self._select(sel, "row")

    def select_cols(self, sel) -> "SparseMatrix":
        """New matrix keeping the given columns (bool mask or index array),
        e.g. a highly-variable-gene mask."""

        return self._select(sel, "col")

    def _slot_positions(self) -> np.ndarray:
        """Flat position of each stored entry (CSR order) in the ELL grid."""

        indptr = self._h_indptr
        # entry j of line r sits at r * W + (j - indptr[r])
        start = np.arange(self.n_major, dtype=np.int64) * self.ell_width - indptr[:-1]
        return np.repeat(start, np.diff(indptr)) + np.arange(len(self._h_indices), dtype=np.int64)

    def _gather_values(self, pos_indptr, pos_indices, pos, n_lines, fmt, shape):
        """A device-valued matrix whose layout is the CSR ``(pos_indptr,
        pos_indices)`` and whose values are this matrix's ELL slots at the
        flat positions ``pos``: the structure and the position map are
        built on the host, the values move by one device gather."""

        ell_pos, ell_ids, nnz_line = _cv.csr_to_ell_numpy(
            pos_indptr, pos_indices, pos, n_lines
        )
        tmap = torch.from_numpy(ell_pos).to(self.device)
        ids = torch.from_numpy(ell_ids).to(self.device)
        row_nnz = torch.from_numpy(nnz_line).to(self.device)
        vals = self.ell_data.reshape(-1)[tmap]
        vals = torch.where(_st.valid_mask(ids, row_nnz), vals, torch.zeros_like(vals))
        return self._with_ell((vals, ids, row_nnz), fmt=fmt, shape=shape,
                              indptr=pos_indptr, indices=pos_indices,
                              nnz=int(pos_indptr[-1]))

    def _select_major_structural(self, idx: np.ndarray) -> "SparseMatrix":
        s_indptr, s_indices, s_pos = _cv.extract_rows_csr(
            self._h_indptr, self._h_indices, self._slot_positions(), idx
        )
        shape = ((len(idx), self.shape[1]) if self.format == "csr"
                 else (self.shape[0], len(idx)))
        return self._gather_values(s_indptr, s_indices, s_pos, len(idx), self.format, shape)

    # -- transpose -----------------------------------------------------------

    def transpose(self) -> "SparseMatrix":
        """The same logical matrix stored along the other axis (cached).
        Host values: one host O(nnz) pass (its device layout is built when
        first needed). Device values: the transposed structure and a slot
        map are built on the host and the values move by one device
        gather, with no host round trip of the values."""

        if self._transpose_cache is None:
            self._require_host_structure()
            fmt = "csc" if self.format == "csr" else "csr"
            if self._h_data is None:
                t_indptr, t_indices, t_pos = _cv.csr_transpose_numpy(
                    self._h_indptr, self._h_indices, self._slot_positions(),
                    self.n_major, self.n_minor,
                )
                other = self._gather_values(t_indptr, t_indices, t_pos, self.n_minor,
                                            fmt, self.shape)
            else:
                t_indptr, t_indices, t_data = _cv.csr_transpose_numpy(
                    self._h_indptr, self._h_indices, self._h_data,
                    self.n_major, self.n_minor,
                )
                other = SparseMatrix(t_indptr, t_indices, t_data, self.shape, fmt,
                                     self.device)
            other._transpose_cache = self
            self._transpose_cache = other
        return self._transpose_cache

    def _layout_for(self, axis: str) -> "SparseMatrix":
        """Matrix whose MAJOR axis is ``axis`` ('row' or 'col')."""

        major_axis = "row" if self.format == "csr" else "col"
        return self if axis == major_axis else self.transpose()

    def _n_of(self, axis: str) -> int:
        return self.nrows if axis == "row" else self.ncols

    def _check_mask(self, mask, expected: int, what: str) -> torch.Tensor:
        if not isinstance(mask, torch.Tensor):
            mask = np.asarray(mask)
        n = mask.shape[0]
        if n != expected:
            # strict parity: the reference bails on ANY length mismatch,
            # longer masks included
            raise ValueError(
                f"Mask length ({n}) does not match number of {what} ({expected})"
            )
        return torch.as_tensor(mask, device=self.device).bool()

    def _major_stat(self, axis: str, fn, *extra):
        m = self._layout_for(axis)
        out = fn(m.ell_data, m.ell_ids, m.row_nnz, *extra)
        return out[: self._n_of(axis)]

    @staticmethod
    def _cast(out: torch.Tensor, dtype) -> torch.Tensor:
        return out.to(dtype) if dtype else out

    # -- MatrixNonZero ---------------------------------------------------

    def nonzero_row(self, dtype=torch.int32) -> torch.Tensor:
        return self._layout_for("row").row_nnz[: self.nrows].to(dtype)

    def nonzero_col(self, dtype=torch.int32) -> torch.Tensor:
        return self._layout_for("col").row_nnz[: self.ncols].to(dtype)

    def nonzero_row_masked(self, mask, dtype=torch.int32) -> torch.Tensor:
        """Per-row stored-entry count over masked-in COLUMNS."""

        mk = self._check_mask(mask, self.ncols, "columns")
        m = self._layout_for("row")
        return _st.count_major_masked(m.ell_ids, m.row_nnz, mk)[: self.nrows].to(dtype)

    def nonzero_col_masked(self, mask, dtype=torch.int32) -> torch.Tensor:
        """Per-column stored-entry count over masked-in ROWS."""

        mk = self._check_mask(mask, self.nrows, "rows")
        m = self._layout_for("col")
        return _st.count_major_masked(m.ell_ids, m.row_nnz, mk)[: self.ncols].to(dtype)

    def nonzero_row_chunk(self, acc) -> np.ndarray:
        return _accumulate_chunk(acc, self.nonzero_row().cpu().numpy())

    def nonzero_col_chunk(self, acc) -> np.ndarray:
        return _accumulate_chunk(acc, self.nonzero_col().cpu().numpy())

    # -- MatrixSum -------------------------------------------------------

    def sum_row(self, dtype=None) -> torch.Tensor:
        return self._cast(self._major_stat("row", lambda d, i, n: _st.sum_major(d)), dtype)

    def sum_col(self, dtype=None) -> torch.Tensor:
        return self._cast(self._major_stat("col", lambda d, i, n: _st.sum_major(d)), dtype)

    def sum_row_squared(self, dtype=None) -> torch.Tensor:
        return self._cast(
            self._major_stat("row", lambda d, i, n: _st.sum_major_squared(d)), dtype)

    def sum_col_squared(self, dtype=None) -> torch.Tensor:
        return self._cast(
            self._major_stat("col", lambda d, i, n: _st.sum_major_squared(d)), dtype)

    def sum_row_masked(self, mask, dtype=None) -> torch.Tensor:
        mk = self._check_mask(mask, self.ncols, "columns")
        return self._cast(self._major_stat("row", _st.sum_major_masked, mk), dtype)

    def sum_col_masked(self, mask, dtype=None) -> torch.Tensor:
        mk = self._check_mask(mask, self.nrows, "rows")
        return self._cast(self._major_stat("col", _st.sum_major_masked, mk), dtype)

    def sum_row_chunk(self, acc) -> np.ndarray:
        return _accumulate_chunk(acc, self.sum_row().cpu().numpy())

    def sum_col_chunk(self, acc) -> np.ndarray:
        return _accumulate_chunk(acc, self.sum_col().cpu().numpy())

    # -- MatrixVariance --------------------------------------------------

    def var_col(self, dtype=None) -> torch.Tensor:
        """Bessel-corrected column variance over ALL rows, implicit zeros
        included."""

        out = _st.var_bessel_dense(self.sum_col(), self.sum_col_squared(), self.nrows)
        return self._cast(out, dtype)

    def var_row(self, dtype=None) -> torch.Tensor:
        """Bessel-corrected row variance over ALL columns, implicit zeros
        included (divides by ncols; the reference divides by nrows)."""

        out = _st.var_bessel_dense(self.sum_row(), self.sum_row_squared(), self.ncols)
        return self._cast(out, dtype)

    def _var_chunk(self, axis: str, acc, dtype, what: str) -> np.ndarray:
        out = self._cast(self._major_stat(axis, _st.var_stored_major), dtype).cpu().numpy()
        if acc is None:
            return out
        acc = np.asarray(acc)
        n = self._n_of(axis)
        if acc.shape[0] != n:
            raise ValueError(
                f"Reference slice length {acc.shape[0]} does not match "
                f"number of {what} {n}"
            )
        return out.astype(acc.dtype)

    def var_col_chunk(self, acc=None, dtype=None) -> np.ndarray:
        """Population variance of stored entries per column (overwrites the
        accumulator, as the reference does)."""

        return self._var_chunk("col", acc, dtype, "columns")

    def var_row_chunk(self, acc=None, dtype=None) -> np.ndarray:
        return self._var_chunk("row", acc, dtype, "rows")

    def var_col_masked(self, mask, dtype=None) -> torch.Tensor:
        """Population variance of stored entries in masked-in rows."""

        mk = self._check_mask(mask, self.nrows, "rows")
        return self._cast(self._major_stat("col", _st.var_stored_major_masked, mk), dtype)

    def var_row_masked(self, mask, dtype=None) -> torch.Tensor:
        mk = self._check_mask(mask, self.ncols, "columns")
        return self._cast(self._major_stat("row", _st.var_stored_major_masked, mk), dtype)

    # -- MatrixMinMax ----------------------------------------------------

    def min_max_row(self) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self._layout_for("row")
        mins, maxs = _st.min_max_major(m.ell_data, m.ell_ids, m.row_nnz)
        return mins[: self.nrows], maxs[: self.nrows]

    def min_max_col(self) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self._layout_for("col")
        mins, maxs = _st.min_max_major(m.ell_data, m.ell_ids, m.row_nnz)
        return mins[: self.ncols], maxs[: self.ncols]

    def min_max_row_chunk(self, acc: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        mins, maxs = self.min_max_row()
        return _merge_min_max(acc, mins.cpu().numpy(), maxs.cpu().numpy())

    def min_max_col_chunk(self, acc: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        mins, maxs = self.min_max_col()
        return _merge_min_max(acc, mins.cpu().numpy(), maxs.cpu().numpy())

    # -- batch group-by stats ------------------------------------------------

    def _batch_codes(self, batches: Sequence, expected: int, what: str):
        if len(batches) != expected:
            raise ValueError(
                f"Batch vector length ({len(batches)}) doesn't match matrix "
                f"{what} count ({expected})"
            )
        labels = list(dict.fromkeys(batches))  # stable unique
        code_of = {b: i for i, b in enumerate(labels)}
        codes = np.fromiter((code_of[b] for b in batches), dtype=np.int64,
                            count=len(batches))
        return labels, codes

    def _batch_spmm(self, axis: str, codes: np.ndarray, transform: str) -> torch.Tensor:
        """[axis-length, n_batches] per-batch sums of the layout of
        ``axis``: the one-hot batch-indicator product of the JAX package
        (``ell_spmm(data, ids, onehot)``), as one scatter-add
        (``ell_onehot_spmm``)."""

        m = self._layout_for(axis)
        nb = int(codes.max()) + 1 if len(codes) else 1
        if transform == "sum":
            data = m.ell_data
        elif transform == "sumsq":
            data = m.ell_data * m.ell_data
        elif transform == "count":
            data = _st.valid_mask(m.ell_ids, m.row_nnz).to(m.ell_data.dtype)
        else:  # pragma: no cover
            raise ValueError(transform)
        codes_t = torch.from_numpy(codes).to(self.device)
        return ell_onehot_spmm(data, m.ell_ids, codes_t, nb)[: self._n_of(axis)]

    def _batch_mean(self, labels, codes, axis: str) -> Dict:
        sums = self._batch_spmm(axis, codes, "sum")
        sizes = torch.from_numpy(
            np.bincount(codes, minlength=len(labels))).to(device=sums.device, dtype=sums.dtype)
        means = sums / sizes[None, :]
        return {b: means[:, i] for i, b in enumerate(labels)}

    def mean_batch_row(self, batches: Sequence) -> Dict:
        """Per-row means within COLUMN batches, zeros included in the
        denominator (batches has ncols entries; mean = batch sum / batch
        column count)."""

        labels, codes = self._batch_codes(batches, self.ncols, "column")
        return self._batch_mean(labels, codes, "row")

    def mean_batch_col(self, batches: Sequence) -> Dict:
        """Per-column means within ROW batches."""

        labels, codes = self._batch_codes(batches, self.nrows, "row")
        return self._batch_mean(labels, codes, "col")

    def var_batch_row(self, batches: Sequence) -> Dict:
        """Per-column variance of stored entries within ROW batches,
        ``(sumsq - sum^2/count)/(count - 1)``, 0 when count <= 1."""

        labels, codes = self._batch_codes(batches, self.nrows, "row")
        return self._batch_var(labels, codes, axis="col")

    def var_batch_col(self, batches: Sequence) -> Dict:
        """Per-row variance of stored entries within COLUMN batches."""

        labels, codes = self._batch_codes(batches, self.ncols, "column")
        return self._batch_var(labels, codes, axis="row")

    def _batch_var(self, labels, codes, axis: str) -> Dict:
        sums = self._batch_spmm(axis, codes, "sum")
        sumsq = self._batch_spmm(axis, codes, "sumsq")
        counts = self._batch_spmm(axis, codes, "count")
        safe = torch.clamp(counts, min=1.0)
        ss = sumsq - sums * sums / safe
        var = torch.where(counts > 1, ss / torch.clamp(counts - 1, min=1.0),
                          torch.zeros_like(ss))
        return {b: var[:, i] for i, b in enumerate(labels)}

    # -- MatrixNTop ------------------------------------------------------

    def sum_row_n_top(self, n: int, dtype=None) -> torch.Tensor:
        return self._cast(self._major_stat("row", _st.sum_major_n_top, n), dtype)

    # -- Normalize / Log1P -----------------------------------------------

    def _map_both(self, apply) -> "SparseMatrix":
        """``apply(layout) -> new ell_data`` on this matrix and, when its
        transpose is cached, on the transpose too: an elementwise map
        commutes with transposition, so the two results are linked as
        transpose twins (no rebuild of the other layout)."""

        out = self._with_ell((apply(self),) + self._device_layout()[1:])
        tc = self._transpose_cache
        if tc is not None:
            twin = tc._with_ell((apply(tc),) + tc._device_layout()[1:])
            twin._transpose_cache = out
            out._transpose_cache = twin
        return out

    def normalize(self, sums, target, direction: Direction) -> "SparseMatrix":
        """Scale rows/columns so each sums to ``target``. Zero-or-negative
        sum lines stay untouched (the reference's guard: scale = target /
        sum when sum > 0, else 0, applied only where scale > 0). Returns a
        new matrix. On the layout whose major axis is ``direction`` the
        factor is a per-line broadcast; on the other it is gathered by the
        stored ids."""

        axis = "row" if direction == Direction.ROW else "col"
        sums = torch.as_tensor(sums, device=self.device).to(self.dtype)
        n_axis = self._n_of(axis)
        if sums.shape[0] != n_axis:
            raise ValueError(
                f"Length of sums ({sums.shape[0]}) does not match number of "
                f"{axis}s ({n_axis})"
            )
        target = torch.as_tensor(target, dtype=self.dtype, device=self.device)
        factor = torch.where(sums > 0, target / sums, torch.zeros_like(sums))

        def apply(m):
            d, ids, row_nnz = m._device_layout()
            if ("row" if m.format == "csr" else "col") == axis:
                f = torch.zeros(d.shape[0], dtype=d.dtype, device=d.device)
                f[: factor.shape[0]] = factor
                f = f[:, None]
            else:
                f = factor[ids.long()]
            new = torch.where(f > 0, d * f, d)
            return torch.where(_st.valid_mask(ids, row_nnz), new, torch.zeros_like(d))

        return self._map_both(apply)

    def log1p_normalize(self) -> "SparseMatrix":
        """ln(1 + v) on stored values; implicit zeros stay zero."""

        return self.map_stored(_log1p_fn)

    def map_stored(self, fn, *operands) -> "SparseMatrix":
        """Elementwise map over stored entries, keeping BOTH cached layouts.

        ``fn(values, row_ids, col_ids, *operands) -> values`` runs on the
        device over the ELL payload (``[R, W]`` tensors; padded slots are
        set back to zero afterwards). ``operands`` go to the matrix's
        device."""

        operands = tuple(torch.as_tensor(o, device=self.device) for o in operands)

        def apply(m):
            d, ids, row_nnz = m._device_layout()
            iota = torch.arange(d.shape[0], dtype=torch.int32, device=d.device)[:, None]
            iota = iota.expand(d.shape)
            r, c = (iota, ids) if m.format == "csr" else (ids, iota)
            new = fn(d, r, c, *operands)
            return torch.where(_st.valid_mask(ids, row_nnz), new, torch.zeros_like(new))

        return self._map_both(apply)

    # -- products ----------------------------------------------------------

    def _operand(self, B) -> torch.Tensor:
        return torch.as_tensor(B, device=self.device)

    @precision_policy()
    def matmul_dense(self, B) -> torch.Tensor:
        """``self @ B`` for dense ``B [ncols, k]`` -> ``[nrows, k]``."""

        m = self._layout_for("row")
        return ell_spmm(m.ell_data, m.ell_ids, self._operand(B))[: self.nrows]

    @precision_policy()
    def rmatmul_dense(self, C) -> torch.Tensor:
        """``self.T @ C`` for dense ``C [nrows, k]`` -> ``[ncols, k]``."""

        m = self._layout_for("col")
        return ell_spmm(m.ell_data, m.ell_ids, self._operand(C))[: self.ncols]

    def __matmul__(self, B):
        return self.matmul_dense(B)

    def __repr__(self):
        return (
            f"SparseMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"format={self.format!r}, dtype={self.dtype}, device={self.device})"
        )


# ---------------------------------------------------------------------------
# chunk helpers (functional versions of the reference's in-place streams)
# ---------------------------------------------------------------------------


def _accumulate_chunk(acc, stat: np.ndarray) -> np.ndarray:
    """acc + stat over the overlapping prefix (the reference skips
    out-of-range indices)."""

    acc = np.array(acc, copy=True)
    k = min(acc.shape[0], stat.shape[0])
    acc[:k] = acc[:k] + stat[:k].astype(acc.dtype)
    return acc


def _merge_min_max(acc, mins: np.ndarray, maxs: np.ndarray):
    amin = np.array(acc[0], copy=True)
    amax = np.array(acc[1], copy=True)
    k = min(amin.shape[0], mins.shape[0])
    amin[:k] = np.minimum(amin[:k], mins[:k].astype(amin.dtype))
    amax[:k] = np.maximum(amax[:k], maxs[:k].astype(amax.dtype))
    return amin, amax


# ---------------------------------------------------------------------------
# convenience constructors
# ---------------------------------------------------------------------------


def csr_matrix(mat, dtype=None, device="cuda") -> SparseMatrix:
    """Reference ``CsrMatrix`` equivalent (row-major storage)."""

    return SparseMatrix.from_scipy(mat, fmt="csr", dtype=dtype, device=device)


def csc_matrix(mat, dtype=None, device="cuda") -> SparseMatrix:
    """Reference ``CscMatrix`` equivalent (column-major storage)."""

    return SparseMatrix.from_scipy(mat, fmt="csc", dtype=dtype, device=device)


def random_sparse(
    n_rows: int,
    n_cols: int,
    density: float,
    seed: int = 42,
    fmt: str = "csr",
    dtype=np.float32,
    rng_format: str = "uniform",
    device="cuda",
) -> SparseMatrix:
    """Seeded synthetic matrix mirroring the reference benches' generator
    (uniform values in [0, 1), or standard normal)."""

    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    mat = sp.random(
        n_rows, n_cols, density=density, format=fmt, dtype=np.float64,
        random_state=rng,
        data_rvs=(rng.standard_normal if rng_format == "normal" else rng.random),
    )
    return SparseMatrix.from_scipy(mat, fmt=fmt, dtype=dtype, device=device)
