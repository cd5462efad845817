"""The port's spans and host-wait counts (``utils/tracing.py``).

The recorder on its own, then the span tree of a randomized
``fit_transform`` on the Gram and the tiled engines (both run on the CPU
through their kernels' plain versions), then, on a card, that a span's
host clock holds the profiler's device interval of its kernel and that
the host-wait counter catches each kind of host wait.

This file imports no JAX; its card test runs with

    python -m pytest --noconftest tests/test_torch_spans.py -m requires_cuda
"""

import collections
import glob
import json
import os
import threading
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu_torch import MaskedSparsePCA, SparseMatrix, SparsePCABuilder
from single_algebra_tpu_torch.types import PowerIterationNormalizer as PIN
from single_algebra_tpu_torch.types import SVDMethod
from single_algebra_tpu_torch.utils import tracing


def counts(n, p, seed):
    """Poisson counts around 8 cluster centres."""

    rng = np.random.default_rng(seed)
    lam = rng.gamma(2.0, 1.0, (8, p)) * (rng.random((8, p)) < 0.5)
    return sp.csr_matrix(rng.poisson(lam[rng.integers(0, 8, n)]).astype(np.float32))


def fit_transform(X, engine, k=4):
    pca = (SparsePCABuilder().n_components(k).engine(engine)
           .svd_method(SVDMethod.random(10, 7, PIN.QR)).build())
    T = pca.fit_transform(SparseMatrix.from_scipy(X, device="cpu"))
    return pca, T


def tree(spans):
    """(name, parent's name) -> how many spans."""

    by_id = {s["id"]: s for s in spans}
    return collections.Counter(
        (s["name"], by_id[s["parent"]]["name"] if s["parent"] else None) for s in spans)


# -- the recorder --------------------------------------------------------------


def test_off_a_fit_makes_no_span_event_or_sync_mode(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with recording off")

    monkeypatch.setattr(tracing, "_Span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    assert tracing.span("pca.fit", a=1) is tracing.span("other") is tracing._NO_SPAN
    with tracing.span("x") as s:
        s.set(b=2)
        tracing.count("host_waits", 3)
    pca, T = fit_transform(counts(600, 120, 1), "gram")
    assert tuple(T.shape) == (600, 4)
    assert getattr(tracing._local, "rec", None) is None


def test_nesting_ids_and_one_trace_per_outermost_span():
    with tracing.recording() as rec:
        with tracing.span("a", x=1):
            with tracing.span("b") as b:
                b.set(y=2)
                with tracing.span("c"):
                    pass
        with tracing.span("d"):
            with tracing.span("e"):
                pass
    s = {r["name"]: r for r in rec.spans()}
    assert [r["name"] for r in rec.spans()] == ["c", "b", "a", "e", "d"]
    assert s["a"]["parent"] is None and s["d"]["parent"] is None
    assert s["b"]["parent"] == s["a"]["id"] and s["c"]["parent"] == s["b"]["id"]
    assert s["e"]["parent"] == s["d"]["id"]
    assert s["a"]["trace"] == s["b"]["trace"] == s["c"]["trace"] == s["a"]["id"]
    assert s["d"]["trace"] == s["e"]["trace"] == s["d"]["id"] != s["a"]["trace"]
    assert len({r["id"] for r in rec.spans()}) == 5
    assert s["a"]["attrs"] == {"x": 1} and s["b"]["attrs"] == {"y": 2}
    for r in rec.spans():
        assert r["start_ns"] <= r["end_ns"] and r["host_s"] >= 0
        assert r["device_s"] is None  # no CUDA here
    assert s["a"]["start_ns"] <= s["b"]["start_ns"] <= s["b"]["end_ns"] <= s["a"]["end_ns"]


def test_counters_go_to_the_innermost_open_span():
    with tracing.recording() as rec:
        tracing.count("k", 5)  # no span open: the total only
        with tracing.span("outer"):
            tracing.count("k")
            with tracing.span("inner"):
                tracing.count("k", 2)
                tracing.count("j", 7)
    s = {r["name"]: r for r in rec.spans()}
    assert s["outer"]["counters"] == {"k": 1}
    assert s["inner"]["counters"] == {"k": 2, "j": 7}
    assert rec.counters() == {"k": 8, "j": 7}


def test_a_span_that_raises_still_closes():
    with tracing.recording() as rec:
        with pytest.raises(ValueError):
            with tracing.span("outer"):
                with tracing.span("boom"):
                    raise ValueError("x")
        with tracing.span("after"):
            pass
        assert rec.stack == []
    s = {r["name"]: r for r in rec.spans()}
    assert set(s) == {"boom", "outer", "after"}
    assert s["after"]["parent"] is None and s["boom"]["parent"] == s["outer"]["id"]


def test_recordings_are_per_thread_and_nest():
    seen = {}

    def other():
        seen["off"] = tracing.span("t") is tracing._NO_SPAN
        with tracing.recording() as r:
            with tracing.span("theirs"):
                pass
        seen["theirs"] = [s["name"] for s in r.spans()]

    with tracing.recording() as rec:
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with tracing.span("mine"):
            with tracing.recording() as inner:
                with tracing.span("nested"):
                    pass
            with tracing.span("back"):
                pass
    assert seen == {"off": True, "theirs": ["theirs"]}
    assert [s["name"] for s in rec.spans()] == ["back", "mine"]
    assert [s["name"] for s in inner.spans()] == ["nested"]
    assert inner.spans()[0]["parent"] is None
    assert getattr(tracing._local, "rec", None) is None


def test_stage_keeps_its_dict_and_is_a_span_in_a_recording():
    tracing.reset_stage_timings()
    with tracing.recording() as rec:
        with tracing.span("outer"):
            with tracing.stage("st"):
                pass
    with tracing.stage("st"):
        pass
    assert set(tracing.stage_timings()) == {"st"} and tracing.stage_timings()["st"] >= 0
    s = {r["name"]: r for r in rec.spans()}
    assert s["st"]["parent"] == s["outer"]["id"]
    tracing.reset_stage_timings()


def test_host_waits_are_counted_while_recording_and_restored(monkeypatch):
    """The mechanism the card uses, with the card's calls stubbed: sync
    warnings and explicit synchronises count against the innermost span
    (a synchronise once, whatever it warns), are not shown, and every
    process setting is restored when the recording closes."""

    modes, synced = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def fake_sync(device=None):
        synced.append(device)
        warnings.warn(tracing._SYNC_WARNING + " (inside)")

    monkeypatch.setattr(torch.cuda, "synchronize", fake_sync)
    shown = warnings.showwarning
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("default")
        with tracing.recording() as rec:
            assert modes == ["warn"]
            with tracing.span("outer"):
                warnings.warn(tracing._SYNC_WARNING)
                with tracing.span("inner"):
                    for _ in range(3):  # repeats from one line count each time
                        warnings.warn(tracing._SYNC_WARNING + " (Triggered internally)")
                    torch.cuda.synchronize("dev")
            warnings.warn("another warning")
        assert modes == ["warn", 0]
        assert torch.cuda.synchronize is fake_sync
    assert warnings.showwarning is shown
    s = {r["name"]: r for r in rec.spans()}
    assert s["outer"]["counters"] == {"host_waits": 1}
    assert s["inner"]["counters"] == {"host_waits": 4}
    assert rec.counters() == {"host_waits": 5}
    assert synced == ["dev"]
    assert [str(w.message) for w in caught] == ["another warning"]


def test_profile_trace_shows_the_spans_by_name(tmp_path):
    X = counts(800, 150, 2)
    with tracing.recording(), tracing.profile_trace(str(tmp_path)):
        fit_transform(X, "tiled")
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pca.fit", "pca.engine", "svd.randomized", "svd.orthonormalize",
            "tiled.mv", "tiled.rmv"} <= names


# -- the spans of a fit ----------------------------------------------------------


def test_gram_fit_transform_span_tree():
    X = counts(3000, 300, 3)
    with tracing.recording() as rec:
        pca, T = fit_transform(X, "gram")
    spans = rec.spans()
    assert tree(spans) == {
        ("sparse.from_scipy", None): 1,
        ("pca.fit", None): 1,
        ("pca.engine", "pca.fit"): 1,
        ("gram.build_host", "pca.engine"): 1,
        ("gram.upload", "pca.engine"): 1,
        ("pca.host_col_stats", "pca.fit"): 1,
        ("gram.pass", "pca.fit"): 1,
        ("gram.solve", "pca.fit"): 1,
        ("gram.project", "pca.fit"): 1,
    }
    s = {r["name"]: r for r in spans}
    fit = s["pca.fit"]["id"]  # two requests: the intake, then the fit
    assert {r["trace"] for r in spans} == {s["sparse.from_scipy"]["id"], fit}
    assert all(r["trace"] == fit for r in spans if r["name"] != "sparse.from_scipy")
    assert s["pca.engine"]["attrs"] == {"requested": "gram", "engine": "gram", "cached": False}
    assert s["pca.host_col_stats"]["attrs"] == {"cached": False, "route": "native"}
    assert s["pca.host_col_stats"]["counters"] == {"pca.col_stats_native": 1}
    assert s["gram.pass"]["attrs"] == {"tier": "int8"}
    assert s["gram.pass"]["counters"]["gram.slabs"] == 3  # 3,000 rows, 1,024-row slabs
    assert pca._fit_timings.keys() == {"stats"}
    assert tuple(T.shape) == (3000, 4)


def test_gram_upload_counts_the_payload_bytes():
    from single_algebra_tpu_torch.linalg.gram import GramPCAEngine

    m = SparseMatrix.from_scipy(counts(2500, 200, 4), device="cpu")
    with tracing.recording() as rec:
        eng = GramPCAEngine.from_matrix(m)
    payload = sum(t.numel() * t.element_size()
                  for t in (*eng.bdata, *eng.blocal, eng.pos, eng.gidx))
    s = {r["name"]: r for r in rec.spans()}
    assert s["gram.upload"]["counters"] == {"gram.upload_bytes": payload}
    assert set(eng.build_seconds) == {"host_payload", "upload"}


def test_large_gram_solve_runs_the_randomized_solver_inside():
    from single_algebra_tpu_torch.linalg import gram

    G = torch.randn(4200, 30)
    G = G @ G.T
    with tracing.recording() as rec:
        gram._solve_topk(G, torch.zeros(4200), 10, 0, k=3, center=False)
    t = tree(rec.spans())
    assert t[("gram.solve", None)] == 1 and t[("svd.randomized", "gram.solve")] == 1
    assert t[("svd.orthonormalize", "svd.randomized")] == 2 * 8 + 1


def test_tiled_fit_transform_span_tree():
    X = counts(3000, 300, 5)
    with tracing.recording() as rec:
        pca, T = fit_transform(X, "tiled")
    spans = rec.spans()
    assert tree(spans) == {
        ("sparse.from_scipy", None): 1,
        ("pca.fit", None): 1,
        ("pca.engine", "pca.fit"): 1,
        ("tiled.build_host", "pca.engine"): 1,
        ("tiled.upload_split", "pca.engine"): 1,
        ("pca.host_col_stats", "pca.fit"): 1,
        ("svd.randomized", "pca.fit"): 1,
        ("svd.sketch", "svd.randomized"): 1,
        ("svd.orthonormalize", "svd.randomized"): 2 * 7 + 1,
        ("tiled.mv", "svd.randomized"): 1 + 7,
        ("tiled.rmv", "svd.randomized"): 7 + 1,
        ("svd.small_svd", "svd.randomized"): 1,
        ("tiled.mv", "pca.fit"): 1,  # the projection
    }
    widths = collections.Counter((r["name"], r["attrs"]["width"])
                                 for r in spans if r["name"] in ("tiled.mv", "tiled.rmv"))
    assert widths == {("tiled.mv", 14): 8, ("tiled.rmv", 14): 8, ("tiled.mv", 4): 1}
    assert pca._fit_timings.keys() == {"stats"}


def test_a_refit_hits_the_caches():
    m = SparseMatrix.from_scipy(counts(1500, 200, 6), device="cpu")
    b = SparsePCABuilder().n_components(3).engine("tiled").svd_method(
        SVDMethod.random(10, 2, PIN.QR))
    b.build().fit(m)
    with tracing.recording() as rec:
        b.random_seed(9).build().fit(m)
    s = {r["name"]: r for r in rec.spans()}
    assert s["pca.engine"]["attrs"] == {"requested": "tiled", "cached": True}
    assert s["pca.host_col_stats"]["attrs"] == {"cached": True}
    assert "pca.col_stats_native" not in rec.counters()
    assert not any(r["name"].startswith("tiled.build") for r in rec.spans())


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_col_stats_span_names_its_route(route, monkeypatch):
    if route == "numpy":  # as with no g++: every native route falls back
        from single_algebra_tpu_torch.native import build as nbuild

        monkeypatch.setenv("SINGLE_ALGEBRA_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(nbuild, "_tried", False)
        monkeypatch.setattr(nbuild, "_lib", None)
    m = SparseMatrix.from_scipy(counts(1200, 90, 8), device="cpu")
    fit = SparsePCABuilder().n_components(3).engine("sparse").svd_method(
        SVDMethod.random(10, 2, PIN.QR))
    with tracing.recording() as rec:
        fit.build().fit(m)
    (first,) = [r for r in rec.spans() if r["name"] == "pca.host_col_stats"]
    assert first["attrs"] == {"cached": False, "route": route}
    assert rec.counters().get("pca.col_stats_native", 0) == (route == "native")
    with tracing.recording() as rec:  # a refit of the same matrix hits the cache
        fit.random_seed(3).build().fit(m)
    (again,) = [r for r in rec.spans() if r["name"] == "pca.host_col_stats"]
    assert again["attrs"] == {"cached": True}
    assert rec.counters().get("pca.col_stats_native", 0) == 0


def test_masked_fit_shares_the_spans():
    X = counts(2000, 160, 7)
    mask = np.arange(160) % 3 != 0
    with tracing.recording() as rec:
        pca = MaskedSparsePCA(mask, n_components=3, engine="tiled",
                              svd_method=SVDMethod.random(10, 2, PIN.QR))
        pca.fit(SparseMatrix.from_scipy(X, device="cpu"))
    t = tree(rec.spans())
    assert t[("pca.fit", None)] == 1 and t[("pca.engine", "pca.fit")] == 1
    assert t[("pca.host_col_stats", "pca.fit")] == 1 and t[("svd.randomized", "pca.fit")] == 1
    assert pca._fit_timings.keys() == {"stats"}


# -- on a card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device events and host waits")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_a_span_holds_its_kernel_on_the_profiler_clock(cuda):
    """Raw profiler ``start_ns`` (not rebased) of the one GEMM inside a span
    lies within the span's host interval, 50 us of slack at each edge."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(4096, 4096, device=cuda)
    a @ a
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.recording() as rec:
            with tracing.span("probe.gemm"):
                a @ a
                torch.cuda.synchronize()
    (s,) = rec.spans()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
               and "memcpy" not in e.name().lower() and "memset" not in e.name().lower()]
    assert kernels
    slack = 50_000
    for e in kernels:
        assert s["start_ns"] - slack <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s["end_ns"] + slack
    assert 0 < s["device_s"] <= s["host_s"] + 50e-6


@pytest.mark.requires_cuda
def test_host_waits_catch_item_linalg_checks_and_synchronize(cuda):
    g = torch.randn(256, 64, device=cuda)
    g = g.T @ g + 64 * torch.eye(64, device=cuda)
    mode = torch.cuda.get_sync_debug_mode()
    with tracing.recording() as rec:
        with tracing.span("item"):
            g.sum().item()
        with tracing.span("cpu"):
            g[:2].cpu()
        with tracing.span("cholesky"):
            torch.linalg.cholesky(g)
        with tracing.span("synchronize"):
            torch.cuda.synchronize()
        with tracing.span("none"):
            g @ g
    assert torch.cuda.get_sync_debug_mode() == mode
    torch.cuda.synchronize()
    waits = {s["name"]: s["counters"].get("host_waits", 0) for s in rec.spans()}
    assert waits == {"item": 1, "cpu": 1, "cholesky": 1, "synchronize": 1, "none": 0}
    assert all(s["device_s"] is not None for s in rec.spans())
