"""What the per-layer readers in ``metrics/`` share: means of the
benchmark's spans and of the program's counters over a window's
requests, the device's idle share, and roofline shares. Each returns
``None`` where there is nothing to read."""

from __future__ import annotations

__all__ = ["span_mean", "counter_mean", "idle_pct", "roofline_pct", "least_s"]


def _mean(values: list):
    return sum(values) / len(values) if values else None


def span_mean(run, name: str):
    """Mean seconds of the benchmark's span ``name`` per request."""

    return _mean([r["spans"][name] for r in run.records if name in r["spans"]])


def counter_mean(run, group: str, key: str, where=None):
    """Mean of the program's counter ``group[key]`` over the requests that
    have it (and satisfy ``where(record)``)."""

    return _mean([r["counters"][group][key] for r in run.records
                  if key in r["counters"].get(group, {}) and (where is None or where(r))])


def idle_pct(run):
    """Share of the traced window in which no device event ran, in %."""

    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def least_s(flops: float, nbytes: float, flops_per_s: float, bytes_per_s: float) -> float:
    """The least time of an operation: its operations at the peak rate or
    its bytes at the memory rate, whichever is longer."""

    return max(flops / flops_per_s, nbytes / bytes_per_s)


def roofline_pct(run, match, least: float):
    """``least`` seconds over the device seconds of the kernels whose name
    satisfies ``match``, in %."""

    if run.trace is None or not least:
        return None
    device_s = run.trace.kernel_s(match)
    return 100.0 * least / device_s if device_s > 0 else None
