"""Stage tracing: named profiler annotations + wall-clock stage timings.

Counterpart of ``single_algebra_tpu/utils/tracing.py``. The reference's
observability is verbose printlns plus ``Instant`` stage timings
(``sparse_masked/mod.rs:257,288``; SURVEY.md §5). Here each stage is a
``torch.profiler.record_function`` range (and an NVTX range once CUDA is
initialised), so stages show up named in a profiler capture, plus the same
wall-clock dict the printlns provided.

Torch launches work on the card asynchronously, so a bare wall clock
around a stage would time the launches only. Once CUDA is initialised,
:func:`stage` synchronises the current device before it stops the clock:
its seconds are the card's work, as the JAX package's are once its
results are pulled.

Usage::

    from single_algebra_tpu_torch.utils.tracing import stage, stage_timings

    with stage("densify"):
        op = DensifiedOperator.from_matrix(m)
    with stage("fit"):
        pca.fit(m)
    print(stage_timings())   # {'densify': 12.3, 'fit': 0.2}

    with profile_trace("build/trace"):   # Chrome / TensorBoard trace file
        pca.fit(m)
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time

import torch

__all__ = ["stage", "stage_timings", "reset_stage_timings", "profile_trace"]

_local = threading.local()


def _timings() -> dict:
    if not hasattr(_local, "timings"):
        _local.timings = {}
    return _local.timings


@contextlib.contextmanager
def stage(name: str):
    """Context manager: a profiler range + wall-clock accumulation under
    ``name`` (per-thread). With CUDA initialised, an NVTX range too, and
    the current device is synchronised before the clock stops."""

    cuda = torch.cuda.is_initialized()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.nvtx.range_pop()
    _timings()[name] = _timings().get(name, 0.0) + (time.perf_counter() - t0)


def stage_timings() -> dict:
    """Accumulated wall-clock seconds per stage (this thread)."""

    return dict(_timings())


def reset_stage_timings() -> None:
    _timings().clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Full trace capture around a block: host and, where CUDA is
    available, card activity, written into ``log_dir`` as a Chrome trace
    file ``<host>.<pid>.<ms>.pt.trace.json`` (view with Perfetto,
    ``chrome://tracing`` or TensorBoard's profile plugin). Yields the
    ``torch.profiler.profile``."""

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns() // 10**6}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))
