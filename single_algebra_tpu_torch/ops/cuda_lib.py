"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, on first use, into
``build/kernels/`` (``native.build.build_dir``) under a name keyed by the
source's hash, so an edited source never loads a stale library. The
libraries are bound with ctypes; each wrapper passes tensor pointers and
the current stream as integers and raises when the C entry point returns
a ``cudaError_t`` other than 0.

:data:`launch_counts` counts kernel launches per wrapper since the last
:func:`reset_launch_counts`; a wrapper adds one only where it launches its
kernel (the plain CPU route does not count).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from ..native.build import build_dir, source_tag

__all__ = [
    "SOURCES",
    "launch_counts",
    "densify_launches_by_dtype",
    "reset_launch_counts",
    "nvcc",
    "build",
    "build_all",
    "load",
    "stream_of",
    "build_logs",
]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

#: kernel library name -> its CUDA source
SOURCES = {
    "tiled_ell_densify": os.path.join(_CSRC, "tiled_ell_densify.cu"),
    "tiled_ell_spmm": os.path.join(_CSRC, "tiled_ell_spmm.cu"),
}

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
launch_counts = {"tiled_ell_densify_t": 0, "tiled_ell_spmm_t": 0, "tiled_ell_rmv_t": 0,
                 "tiled_ell_rmv_form": 0}

#: The densify kernel's launches in :data:`launch_counts`, split by the
#: output dtype's name ("int8", "bfloat16", "float32"): the Gram tier a
#: pass ran.
densify_launches_by_dtype: dict = {}

#: library name -> compiler report (``-Xptxas -v``) of its last verbose build
build_logs: dict = {}

_lock = threading.Lock()
_libs: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    densify_launches_by_dtype.clear()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _so_path(name: str) -> str:
    return os.path.join(build_dir("kernels"), f"{name}_{source_tag(SOURCES[name])}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile library ``name`` with nvcc unless it is already built from
    the same source; -> its path. ``verbose`` rebuilds it and keeps the
    compiler report in :data:`build_logs`."""

    so = _so_path(name)
    if os.path.exists(so) and not verbose:
        return so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir("kernels"))
    os.close(fd)
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", SOURCES[name], "-o", tmp,
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                               f"{SOURCES[name]}:\n{res.stdout}{res.stderr}")
        build_logs[name] = res.stdout + res.stderr
        os.replace(tmp, so)  # atomic: concurrent builders race safely
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def build_all(verbose: bool = False) -> dict:
    """Every library, one nvcc per source, all started together;
    -> {name: library path}."""

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = pool.map(lambda name: build(name, verbose), SOURCES)
        return dict(zip(SOURCES, paths))


def load(name: str, bind):
    """The loaded ctypes library ``name`` (built on first use). ``bind``
    sets the argtypes/restype of its entry points, once."""

    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            bind(lib)
            _libs[name] = lib
        return lib


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""

    return torch.cuda.current_stream(t.device).cuda_stream
