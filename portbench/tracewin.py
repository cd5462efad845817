"""A traced window: ``torch.profiler`` over the measured requests, reduced
to device intervals, kernel time by name, the idle share and the longest
idle gaps with what the host was doing in each.

The busy time is the union of the device events' intervals (kernels,
copies, memsets), so overlapping events count once and host rows never
count: the reduction of ``chip_smoke.py::device_idle``, frozen here.

The profiler records the device's activity only; what the host was doing
comes from the benchmark's own spans (:class:`Spans`), placed on the
profiler's clock by the offset between its start and the spans' clock.
Recording every host operator as well would cost minutes of processing
for a window of a hundred refits.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["Spans", "Trace", "traced"]

TOP = 10  # entries of each breakdown list


class Spans:
    """The benchmark's host spans: ``(name, start_ns, end_ns)`` on
    ``time.time_ns``'s clock; nested spans are recorded inside out."""

    def __init__(self):
        self.items = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, start, time.time_ns()))


class Trace:
    """Device events and host spans of one window, in seconds from its
    start."""

    def __init__(self, device: list, host: list, window_s: float):
        # device / host: (name, start_s, end_s)
        self.device = sorted(device, key=lambda e: e[1])
        self.host = host
        self.window_s = window_s
        self._intervals = None

    def busy_intervals(self) -> list:
        if self._intervals is None:
            merged = []
            for _, s, e in self.device:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._intervals = merged
        return self._intervals

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_s(self, match) -> float:
        """Device seconds of the events whose name satisfies ``match``."""

        return sum(e - s for name, s, e in self.device if match(name))

    def top_ops(self, top: int = TOP) -> list:
        by_name = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by_name.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = TOP) -> list:
        """The longest stretches with no device event, each named by the
        innermost host span around its middle; the window's edges count."""

        edges = [[0.0, 0.0]] + self.busy_intervals() + [[self.window_s, self.window_s]]
        gaps = sorted(((edges[i + 1][0] - edges[i][1], edges[i][1], edges[i + 1][0])
                       for i in range(len(edges) - 1)), reverse=True)[:top]
        out = []
        for length, s, e in gaps:
            if length <= 0:
                break
            mid = 0.5 * (s + e)
            around = [h for h in self.host if h[1] <= mid <= h[2]]
            name = min(around, key=lambda h: h[2] - h[1])[0] if around else "(no host span)"
            out.append([name, length])
        return out


def _device_events(prof):
    """(name, start_ns, end_ns) of the device events on the profiler's
    clock; the device-side copies of host ranges are not device work."""

    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start = e.start_ns()
        yield e.name(), start, start + e.duration_ns()


@contextlib.contextmanager
def traced(spans: Spans, into: list):
    """Profile the ``with`` body (which records its host spans in
    ``spans``) as one window; appends the :class:`Trace` to ``into``."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        yield
        t1 = time.time_ns()
    res = prof.profiler.kineto_results
    begin = res.trace_start_ns() if hasattr(res, "trace_start_ns") else 1000 * res.trace_start_us()
    offset = begin - t0  # the profiler's clock less the spans' clock
    start, end = t0 + offset, t1 + offset
    device = [(n, (max(s, start) - start) / 1e9, (min(e, end) - start) / 1e9)
              for n, s, e in _device_events(prof) if s < end and e > start]
    host = [(n, (s - t0) / 1e9, (e - t0) / 1e9) for n, s, e in spans.items if e > t0 and s < t1]
    into.append(Trace(device, host, (t1 - t0) / 1e9))
