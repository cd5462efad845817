"""Stage tracing, spans and host-wait counts.

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

Spans name the port's layers from inside: :func:`span` at each layer
boundary, :func:`count` for what a layer counts. They cost one check of
a per-thread flag unless a :func:`recording` is open on the thread. In
one, each span keeps its name, attributes, ids, host start and end on
``time.time_ns``'s clock (the clock the profiler stamps its events on),
its device seconds between two CUDA events on the current stream, and
its counters; while a profiler records, it is also a range of its name
there. The recording
counts each point where the host blocks on the card (``host_waits``)
against the innermost open span. A span never synchronises.

Usage::

    from single_algebra_tpu_torch.utils.tracing import stage, stage_timings

    with stage("densify"):
        op = DensifiedOperator.from_matrix(m)
    with stage("fit"):
        pca.fit(m)
    print(stage_timings())   # {'densify': 12.3, 'fit': 0.2}

    with profile_trace("build/trace"):   # Chrome / TensorBoard trace file
        pca.fit(m)

    with recording() as rec:             # the port's spans of one fit
        T = pca.fit_transform(m)
        torch.cuda.synchronize()
    for s in rec.spans():                # name, ids, host_s, device_s, counters
        print(s["name"], s["host_s"], s["device_s"], s["counters"])
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import threading
import time
import warnings

import torch

__all__ = ["stage", "stage_timings", "reset_stage_timings", "profile_trace",
           "span", "count", "recording", "Recording"]

_local = threading.local()


def _timings() -> dict:
    if not hasattr(_local, "timings"):
        _local.timings = {}
    return _local.timings


# -- spans -----------------------------------------------------------------


class _NoSpan:
    """What :func:`span` returns with no recording open: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    """One open or closed span of a :class:`Recording`: ``events`` holds
    its start and end CUDA events and the stream they are recorded on."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "trace", "start_ns", "end_ns",
                 "counters", "events", "range")

    def __init__(self, rec: "Recording", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.counters: dict = {}
        self.events = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""

        self.attrs.update(attrs)

    def __enter__(self):
        rec = self.rec
        parent = rec.stack[-1] if rec.stack else None
        self.id = next(rec.ids)
        self.parent = parent.id if parent is not None else None
        self.trace = parent.trace if parent is not None else self.id
        # a range only where a profiler listens: it costs a dispatcher call
        self.range = (torch.profiler.record_function(self.name)
                      if torch.autograd._profiler_enabled() else None)
        if self.range is not None:
            self.range.__enter__()
        rec.stack.append(self)
        self.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self.events = (start, torch.cuda.Event(enable_timing=True), stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.events[2])
        self.end_ns = time.time_ns()
        self.rec.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec.closed.append(self)
        return False

    def device_s(self):
        """Seconds between the span's two CUDA events, once both have run
        on the card (``None`` before, and off CUDA)."""

        if self.events is None or not self.events[1].query():
            return None
        return self.events[0].elapsed_time(self.events[1]) / 1e3

    def as_dict(self) -> dict:
        return {"name": self.name, "attrs": dict(self.attrs), "id": self.id,
                "parent": self.parent, "trace": self.trace, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "host_s": (self.end_ns - self.start_ns) / 1e9,
                "device_s": self.device_s(), "counters": dict(self.counters)}


class Recording:
    """The spans and counters one :func:`recording` block collected on its
    thread. Read them after the block's work has been synchronised: a
    span's ``device_s`` is ``None`` while its end event has not run."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.stack: list = []
        self.closed: list = []
        self.totals: dict = {}

    def add(self, name: str, n) -> None:
        self.totals[name] = self.totals.get(name, 0) + n
        if self.stack:
            c = self.stack[-1].counters
            c[name] = c.get(name, 0) + n

    def spans(self) -> list:
        """Every closed span as a dict (``name``, ``attrs``, ``id``,
        ``parent``, ``trace``, ``start_ns``, ``end_ns``, ``host_s``,
        ``device_s``, ``counters``), in the order they closed."""

        return [s.as_dict() for s in self.closed]

    def counters(self) -> dict:
        """Each counter's total over the block, spans or none."""

        return dict(self.totals)


def span(name: str, **attrs):
    """A span named ``name`` with ``attrs`` around a ``with`` block: the
    shared no-op unless a :func:`recording` is open on this thread. The
    object entered has ``set(**attrs)`` for attributes known later."""

    rec = getattr(_local, "rec", None)
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, attrs)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span (and
    the recording's total); nothing unless a recording is open."""

    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.add(name, n)


# -- host waits --------------------------------------------------------------

_SYNC_WARNING = "called a synchronizing CUDA operation"


class _HostWaits:
    """Counts the points where the host blocks on the card while any
    thread records: torch's sync debug mode (``warn``) flags ``.item()``,
    ``.cpu()``, blocking copies and the ``torch.linalg`` error checks, and
    its warnings are counted instead of shown; an explicit
    ``torch.cuda.synchronize`` is counted by a wrapper. Both are process
    settings, so they are installed for the first recording that opens and
    restored when the last one closes; a thread that is not recording
    sees the sync warnings as warnings."""

    def __init__(self):
        self.lock = threading.Lock()
        self.users = 0
        self.saved = None

    def install(self) -> None:
        with self.lock:
            self.users += 1
            if self.users > 1 or not torch.cuda.is_available():
                return
            catch = warnings.catch_warnings()
            catch.__enter__()
            warnings.filterwarnings("always", message=_SYNC_WARNING)
            warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
            shown = warnings.showwarning
            sync = torch.cuda.synchronize
            mode = torch.cuda.get_sync_debug_mode()

            def showwarning(message, category, filename, lineno, file=None, line=None):
                rec = getattr(_local, "rec", None)
                if rec is not None and str(message).startswith(_SYNC_WARNING):
                    if not getattr(_local, "in_sync", False):
                        rec.add("host_waits", 1)
                    return
                shown(message, category, filename, lineno, file, line)

            def synchronize(device=None):
                rec = getattr(_local, "rec", None)
                if rec is None:
                    return sync(device)
                rec.add("host_waits", 1)
                _local.in_sync = True
                try:
                    return sync(device)
                finally:
                    _local.in_sync = False

            warnings.showwarning = showwarning
            torch.cuda.synchronize = synchronize
            torch.cuda.set_sync_debug_mode("warn")
            self.saved = (catch, sync, mode)

    def remove(self) -> None:
        with self.lock:
            self.users -= 1
            if self.users or self.saved is None:
                return
            catch, sync, mode = self.saved
            self.saved = None
            torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.synchronize = sync
            catch.__exit__(None, None, None)


_host_waits = _HostWaits()


@contextlib.contextmanager
def recording():
    """Record the spans, counters and host waits of this thread's ``with``
    block; yields the :class:`Recording`. A recording opened inside
    another on the same thread collects on its own and hands the outer
    one back when it closes."""

    rec, outer = Recording(), getattr(_local, "rec", None)
    _host_waits.install()
    _local.rec = rec
    try:
        yield rec
    finally:
        _local.rec = outer
        _host_waits.remove()


# -- stages ------------------------------------------------------------------


@contextlib.contextmanager
def stage(name: str):
    """Context manager: a profiler range + wall-clock accumulation under
    ``name`` (per-thread). With CUDA initialised, an NVTX range too, and
    the current device is synchronised before the clock stops. In a
    :func:`recording` the stage is a span of its name."""

    cuda = torch.cuda.is_initialized()
    rng = span(name)
    if rng is _NO_SPAN:
        rng = torch.profiler.record_function(name)
    t0 = time.perf_counter()
    with rng:
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
    ``torch.profiler.profile``. Spans of an open :func:`recording` appear
    in it as ranges of their names."""

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
