"""One run of one cell: set-up, the measured window, the per-layer
readers, and the comparison with the plain reference.

Everything belonging to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<mix>.json`` (read by the one
generator in ``loop.py``), ``metrics/<metric>.py`` (a reader with
``read(run) -> float | None``) and ``checks/<workload>.json`` (which
reference solve judges the cell, how many of its requests, the limit of
each compared number, and the stages its control takes below float32). A
new cell needs new files only.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
import traceback

import numpy as np

from . import datagen, tracewin
from .loop import Workload

__all__ = ["HERE", "load_bench", "Cell", "run_cell", "BANNED", "banned_modules"]

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level modules that must not be loaded in a run's process
BANNED = ("jax", "jaxlib", "flax", "single_algebra_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is in
    :data:`BANNED`, compared whole."""

    return sorted(n for n in list(sys.modules) if n.split(".")[0] in BANNED)


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with the files it names."""

    def __init__(self, bench: dict, name: str, root: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        cfg = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = _json(os.path.join(root, cfg["file"]))
        self.mix = _json(os.path.join(HERE, "traffic", self.entry["traffic"] + ".json"))
        self.check = _json(os.path.join(HERE, "checks", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"] or ("workloads" not in m
                                                         and m["moves"] in reported)]

    def reader(self, metric: str):
        path = os.path.join(HERE, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What a per-layer reader reads: the window's requests (their spans
    and the program's counters), the trace, the operand width of every
    probed product, the matrix's sizes and the table of peaks."""

    def __init__(self, records, trace, products, matrix, window_s, peaks):
        self.records = records
        self.trace = trace
        self.products = products
        self.matrix = matrix
        self.window_s = window_s
        self.peaks = peaks


def _stat(spec: dict, latencies: list, window_s: float) -> float:
    if spec["stat"] == "window_per_request":
        return window_s / len(latencies)
    if spec["stat"] == "quantile":  # nearest rank
        ordered = sorted(latencies)
        return ordered[max(math.ceil(float(spec["q"]) * len(ordered)) - 1, 0)]
    raise ValueError(f"unknown statistic {spec['stat']!r}")


_SAMPLE = 2  # the stream under the run's seed that picks the judged requests


class _Keeper:
    """The outputs the comparison reads: every request's, or a sample of
    ``size`` drawn from the seed (reservoir sampling)."""

    def __init__(self, size, seed: int):
        self.size = None if size == "all" else int(size)
        self.rng = np.random.default_rng(datagen.seed_sequence(seed, _SAMPLE))
        self.kept, self.seen = [], 0

    def offer(self, out: dict) -> None:
        self.seen += 1
        if self.size is None or len(self.kept) < self.size:
            self.kept.append(out)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.kept[j] = out


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, log=None) -> tuple:
    """One run -> (result dict, compared numbers {name: (value, limit)})."""

    import torch

    log = log or (lambda *_: None)
    cuda = torch.device(device).type == "cuda"
    wl = Workload(cell.config, cell.mix, seed=seed, device=device)
    for step in (wl.draw, wl.build_kernels, wl.hold, wl.warm_up):
        t = time.perf_counter()
        step()
        log(f"set-up {step.__name__}: {time.perf_counter() - t:.2f} s")
    if trace:
        wl.probe_products()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    source = None if wl.held is not None else wl.X
    keeper = _Keeper(cell.check.get("sample", "all"), seed)
    latencies, records, failed, traces = [], [], 0, []
    window = tracewin.traced(wl.spans, traces) if trace else contextlib.nullcontext()
    with window:
        t0 = t_end = time.perf_counter()
        while True:
            ts = time.perf_counter()
            try:
                out, rec = wl.request(source)
            except Exception:  # a request that fails is counted and ends the window
                traceback.print_exc(file=sys.stderr)
                failed += 1
                t_end = time.perf_counter()
                break
            te = t_end = time.perf_counter()
            latencies.append(te - ts)
            records.append(rec)
            keeper.offer(out)
            del out
            if te - t0 >= seconds:
                break
    window_s = t_end - t0
    attempted = len(latencies) + failed
    if trace:
        log(f"trace read in {time.perf_counter() - t_end:.2f} s")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    log(f"window {window_s:.3f} s, {len(latencies)} requests, {failed} failed; latencies (s): "
        + " ".join(f"{x:.3f}" for x in latencies[:6]) + (" ..." if len(latencies) > 6 else ""))

    metrics = {}
    if failed == 0:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                spec = cell.mix["end_to_end"][m["name"]]
                metrics[m["name"]] = {"value": _stat(spec, latencies, window_s),
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(wl.device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        tr = traces[0]
        X = wl.X
        run = Run(records, tr, wl.products,
                  {"n": X.shape[0], "p": X.shape[1], "nnz": int(X.nnz),
                   "value_bytes": X.data.itemsize, "index_bytes": X.indices.itemsize},
                  window_s, _json(os.path.join(HERE, "peaks.json")))
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["metrics"] = metrics
    result["device"] = dev

    # the comparison, once the program's state is freed
    wl.held = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from .reference.judge import judge

    t = time.perf_counter()
    nums = judge(wl.X, keeper.kept, config=cell.config, check=cell.check,
                 device=device) if keeper.kept else {}
    log(f"reference check of {len(keeper.kept)} requests in {time.perf_counter() - t:.2f} s: "
        + json.dumps(nums))
    limits = cell.check["limits"]
    checks = {name: (nums.get(name), float(limit)) for name, limit in limits.items()}
    result["correct"] = bool(failed == 0 and latencies and
                             all(v is not None and v <= lim for v, lim in checks.values()))
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result, checks
