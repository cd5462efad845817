"""Lazy g++ build + ctypes bindings of the host converters and of Leiden.

``ell_convert.cpp`` and ``leiden.cpp`` are the JAX package's native
sources (the JAX package's own loader cannot be imported: its package
``__init__`` imports jax), ``leiden.cpp`` copied unchanged and
``ell_convert.cpp`` with one function of the port's added,
``csr_col_stats_f64`` (the fit's column statistics). Each is compiled with g++
on first use into the build directory (``build/native/`` beside the
package, or ``$SINGLE_ALGEBRA_TORCH_BUILD_DIR/native``), under a name
keyed by the source's hash so an edited source never loads a stale
library, through a temporary file and an atomic rename (concurrent test
workers race safely). Every converter caller falls back to the numpy
implementation in ``sparse.convert``, and ``cluster.leiden`` to its
Python Leiden, when no compiler is available or
``SINGLE_ALGEBRA_TPU_NO_NATIVE=1`` is set.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ell_convert.cpp")
_LEIDEN_SRC = os.path.join(_HERE, "leiden.cpp")
_lock = threading.Lock()
_lib = None
_tried = False
_leiden_lib = None
_leiden_tried = False


def build_dir(kind: str) -> str:
    """``<root>/build/<kind>`` where root is the directory holding the
    package, unless ``SINGLE_ALGEBRA_TORCH_BUILD_DIR`` names another."""

    root = os.environ.get("SINGLE_ALGEBRA_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(_HERE)), "build"
    )
    path = os.path.join(root, kind)
    os.makedirs(path, exist_ok=True)
    return path


def source_tag(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _build(src: str = _SRC) -> str | None:
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(build_dir("native"), f"{stem}_{source_tag(src)}.so")
    if os.path.exists(so):
        return so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            src, "-o", tmp]
    # OpenMP parallelizes the row loops; fall back to serial if the
    # toolchain lacks it
    try:
        for cmd in (base[:1] + ["-fopenmp"] + base[1:], base):
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(tmp, so)  # atomic: concurrent builders race safely
            return so
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded ctypes library, or None when native is unavailable."""

    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SINGLE_ALGEBRA_TPU_NO_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        c64 = ctypes.c_int64

        lib.csr_to_ell_f32.argtypes = [i64p, i32p, f32p, c64, c64, f32p, i32p, i32p]
        lib.csr_to_ell_f32.restype = None
        lib.csr_transpose_f32.argtypes = [
            i64p, i32p, f32p, c64, c64, i64p, i32p, f32p, i64p,
        ]
        lib.csr_transpose_f32.restype = None
        # returns the count of entries whose rank overflowed wt (a stale
        # width plan when nonzero)
        lib.csr_to_tiled_ell_t_f32.argtypes = [
            i64p, i32p, f32p, c64, c64, c64, c64, c64, f32p, i32p,
        ]
        lib.csr_to_tiled_ell_t_f32.restype = c64
        lib.csr_tile_group_hist.argtypes = [i64p, i32p, c64, c64, i64p, c64]
        lib.csr_tile_group_hist.restype = None
        lib.csr_overflow_width.argtypes = [i64p, i32p, c64, c64, c64]
        lib.csr_overflow_width.restype = c64
        lib.csr_to_tiled_ell_split_t_f32.argtypes = [
            i64p, i32p, f32p, c64, c64, c64, c64, c64,
            f32p, i32p, f32p, i32p, c64,
        ]
        lib.csr_to_tiled_ell_split_t_f32.restype = None
        lib.csr_row_tile_widths.argtypes = [i64p, i32p, c64, c64, i64p]
        lib.csr_row_tile_widths.restype = None
        lib.csr_extract_rows_f32.argtypes = [
            i64p, i32p, f32p, i64p, c64, i64p, i32p, f32p,
        ]
        lib.csr_extract_rows_f32.restype = None
        lib.csr_densify_bf16.argtypes = [
            i64p, i32p, f32p, c64, c64, u16p, ctypes.c_void_p,
        ]
        lib.csr_densify_bf16.restype = ctypes.c_int32
        lib.f32_bf16_exact.argtypes = [f32p, c64]
        lib.f32_bf16_exact.restype = ctypes.c_int32
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.csr_col_stats_f64.argtypes = [f32p, i32p, c64, c64, f64p, f64p, ctypes.c_int32]
        lib.csr_col_stats_f64.restype = None
        _lib = lib
        return _lib


def get_leiden_lib():
    """The loaded Leiden ctypes library, or None when native is
    unavailable."""

    global _leiden_lib, _leiden_tried
    if _leiden_tried:
        return _leiden_lib
    with _lock:
        if _leiden_tried:
            return _leiden_lib
        _leiden_tried = True
        if os.environ.get("SINGLE_ALGEBRA_TPU_NO_NATIVE"):
            return None
        so = _build(_LEIDEN_SRC)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.leiden_cluster.argtypes = [
            i64p, i32p, f32p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_uint64, ctypes.c_int64, i32p,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.leiden_cluster.restype = ctypes.c_int64
        _leiden_lib = lib
        return _leiden_lib


def leiden_native(indptr, indices, weights, n, resolution, seed, max_levels):
    """Native Leiden: ``(labels int32 [n], n_communities, quality)``, or
    None when the native library is unavailable."""

    lib = get_leiden_lib()
    if lib is None:
        return None
    labels = np.empty(n, np.int32)
    q = ctypes.c_double(0.0)
    k = lib.leiden_cluster(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(weights, np.float32),
        n,
        float(resolution),
        int(seed) & 0xFFFFFFFFFFFFFFFF,
        int(max_levels),
        labels,
        ctypes.byref(q),
    )
    if k < 0:
        return None
    return labels, int(k), float(q.value)


def csr_to_ell(indptr, indices, data, n_rows, width, rows_padded):
    """Native CSR -> padded ELL ``(ell_data, ell_ids, row_nnz)``, or None
    (use the numpy fallback)."""

    lib = get_lib()
    if lib is None or data.dtype != np.float32:
        return None
    ell_data = np.zeros((rows_padded, width), np.float32)
    ell_ids = np.zeros((rows_padded, width), np.int32)
    row_nnz = np.zeros(rows_padded, np.int32)
    lib.csr_to_ell_f32(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(data, np.float32),
        n_rows,
        width,
        ell_data,
        ell_ids,
        row_nnz,
    )
    return ell_data, ell_ids, row_nnz


def csr_transpose(indptr, indices, data, n_rows, n_cols):
    """Native CSR transpose, or None (use the numpy fallback)."""

    lib = get_lib()
    if lib is None or data.dtype != np.float32:
        return None
    nnz = len(indices)
    out_indptr = np.zeros(n_cols + 1, np.int64)
    out_indices = np.empty(nnz, np.int32)
    out_data = np.empty(nnz, np.float32)
    work = np.empty(max(n_cols, 1), np.int64)
    lib.csr_transpose_f32(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(data, np.float32),
        n_rows,
        n_cols,
        out_indptr,
        out_indices,
        out_data,
        work,
    )
    return out_indptr, out_indices, out_data


def csr_densify_bf16(indptr, indices, data, n_rows, n_cols, need_lo):
    """Native CSR -> dense bf16 bit patterns: ``(hi_u16 [n, p], lo_u16 or
    None, exact)``, or None (use the torch fallback)."""

    lib = get_lib()
    if lib is None or data.dtype != np.float32:
        return None
    hi = np.zeros((n_rows, n_cols), np.uint16)
    lo = np.zeros((n_rows, n_cols), np.uint16) if need_lo else None
    exact = lib.csr_densify_bf16(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(data, np.float32),
        n_rows,
        n_cols,
        hi,
        lo.ctypes.data if lo is not None else None,
    )
    return hi, lo, bool(exact)


def csr_col_stats(data, indices, p, n_threads=0):
    """Native float64 ``(sum, sum of squares)`` per column of CSR values,
    one threaded pass (``csr_col_stats_f64``), or None (use the numpy
    fallback). ``n_threads`` 0 is OpenMP's default; the result does not
    depend on it."""

    lib = get_lib()
    if lib is None or data.dtype != np.float32:
        return None
    if len(indices) != len(data):
        raise ValueError(f"{len(data)} values but {len(indices)} column indices")
    s = np.empty(p, np.float64)
    sq = np.empty(p, np.float64)
    lib.csr_col_stats_f64(
        np.ascontiguousarray(data, np.float32),
        np.ascontiguousarray(indices, np.int32),
        len(data),
        p,
        s,
        sq,
        int(n_threads),
    )
    return s, sq
