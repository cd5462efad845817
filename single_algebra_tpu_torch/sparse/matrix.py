"""``SparseMatrix`` — the port's sparse container (core only).

Counterpart of ``single_algebra_tpu/sparse/matrix.py``. The Gram engine
builds its device payload from the host CSR arrays alone, so this slice
keeps the matrix as host numpy CSR (``indptr``/``indices``/``data`` of
the major axis) plus the ``device`` every engine built from it lives on.
The device-resident ELL layouts, the statistics and the value maps of
the JAX container come with the engines that use them.

``device`` defaults to the card (``"cuda"``): an engine built from the
matrix puts its tensors there, and nothing switches to the CPU behind the
caller's back. On a machine without a card, building an engine from a
default matrix raises; CPU runs pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..types import canonical_float_dtype, torch_dtype
from . import convert as _cv

__all__ = ["SparseMatrix"]


class SparseMatrix:
    """Host CSR (or CSC) arrays plus the device its engines use."""

    def __init__(
        self,
        indptr: np.ndarray,
        indices: np.ndarray,
        data: np.ndarray,
        shape: Tuple[int, int],
        fmt: str = "csr",
        device: torch.device | str = "cuda",
    ):
        if fmt not in ("csr", "csc"):
            raise ValueError(f"format must be 'csr' or 'csc', got {fmt!r}")
        self._h_indptr = np.asarray(indptr, np.int64)
        self._h_indices = np.asarray(indices, np.int32)
        self._h_data = np.asarray(data)
        self.shape = (int(shape[0]), int(shape[1]))
        self.format = fmt
        self.device = torch.device(device)
        self._transpose_cache: Optional["SparseMatrix"] = None
        self._operator_cache: dict = {}  # engine name -> operator

    @classmethod
    def from_scipy(
        cls, mat, fmt: Optional[str] = None, dtype=None, device="cuda"
    ) -> "SparseMatrix":
        """Build from any scipy.sparse matrix. ``fmt`` selects the major
        layout ('csr' default, 'csc' for CSC inputs); float64 values stay
        float64, integer values become float32. ``device`` is where its
        engines run: the card unless the caller names another."""

        import scipy.sparse as sp

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

    # -- properties ------------------------------------------------------

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(len(self._h_indices))

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self._h_data.dtype)

    @property
    def n_major(self) -> int:
        return self.shape[0] if self.format == "csr" else self.shape[1]

    @property
    def n_minor(self) -> int:
        return self.shape[1] if self.format == "csr" else self.shape[0]

    # -- host structure --------------------------------------------------

    def _require_host_structure(self):
        if self._h_indptr is None or self._h_indices is None:
            raise RuntimeError("matrix has no host CSR structure")

    def _csr_data_host(self) -> np.ndarray:
        """Stored values in major-CSR order (host numpy)."""

        return self._h_data

    def transpose(self) -> "SparseMatrix":
        """The same logical matrix stored along the other axis (cached;
        one host O(nnz) pass)."""

        if self._transpose_cache is None:
            t_indptr, t_indices, t_data = _cv.csr_transpose_numpy(
                self._h_indptr, self._h_indices, self._h_data,
                self.n_major, self.n_minor,
            )
            other = SparseMatrix(
                t_indptr, t_indices, t_data, self.shape,
                "csc" if self.format == "csr" else "csr", self.device,
            )
            other._transpose_cache = self
            self._transpose_cache = other
        return self._transpose_cache

    def _layout_for(self, axis: str) -> "SparseMatrix":
        """Matrix whose MAJOR axis is ``axis`` ('row' or 'col')."""

        major_axis = "row" if self.format == "csr" else "col"
        return self if axis == major_axis else self.transpose()

    # -- value gates -------------------------------------------------------

    def values_bf16_exact(self) -> bool:
        """True when every stored value survives f32 -> bf16 round-tripping
        (raw counts always do) — the gate of the bf16 Gram tier. Cached."""

        cached = getattr(self, "_bf16_exact_cache", None)
        if cached is not None:
            return cached
        v = np.ascontiguousarray(self._h_data, np.float32)
        from ..native import build as _native

        lib = _native.get_lib()
        if lib is not None:
            out = bool(lib.f32_bf16_exact(v, len(v)))
        else:
            t = torch.from_numpy(v)
            out = bool(torch.equal(t.to(torch.bfloat16).to(torch.float32), t))
        self._bf16_exact_cache = out
        return out

    def values_int8_exact(self) -> bool:
        """True when every stored value is an integer in ``[-127, 127]`` —
        the gate of the int8 Gram tier (exact int8 x int8 -> int32 slab
        products). Cached."""

        cached = getattr(self, "_int8_exact_cache", None)
        if cached is not None:
            return cached
        v = self._h_data
        out = bool(np.all(np.abs(v) <= 127) and not np.any(v != np.rint(v)))
        self._int8_exact_cache = out
        return out

    # -- conversion ----------------------------------------------------------

    def to_scipy(self):
        import scipy.sparse as sp

        ctor = sp.csr_matrix if self.format == "csr" else sp.csc_matrix
        return ctor(
            (self._h_data, self._h_indices, self._h_indptr), shape=self.shape
        )

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    def __repr__(self):
        return (
            f"SparseMatrix(shape={self.shape}, nnz={self.nnz}, "
            f"format={self.format!r}, dtype={self.dtype}, device={self.device})"
        )
