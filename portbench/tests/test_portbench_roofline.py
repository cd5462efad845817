"""The per-layer readers on hand-worked shapes and a hand-made trace."""

import importlib.util
import os

import pytest

from portbench import harness, readers
from portbench.tracewin import Trace

PEAKS = {"float32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def reader_module(name):
    path = os.path.join(harness.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spmm_and_rmv_work_by_hand():
    # 4 x 3 matrix, 5 stored float32 values with int32 ids, operand width 2
    spmm = reader_module("spmm_roofline")
    rmv = reader_module("rmv_roofline")
    assert spmm.work(4, 3, 5, 4, 4, 2) == (20, 5 * 8 + 4 * 2 * 3 + 4 * 2 * 4)
    assert rmv.work(4, 3, 5, 4, 4, 2) == (20, 5 * 8 + 4 * 2 * 4 + 4 * 2 * 3)


def test_densify_pass_bytes_by_hand():
    densify = reader_module("densify_roofline")
    # 1M x 30k, 294,197,072 values: 8 bytes each read, 30 GB of int8 written
    assert densify.pass_bytes(1_000_000, 30_000, 294_197_072, 4, 4, "int8") == \
        294_197_072 * 8 + 30_000_000_000
    assert densify.pass_bytes(2, 3, 4, 4, 4, "float32") == 32 + 24


def _run(device, products=None, records=(), window=1.0):
    trace = Trace(device, [("portbench.fit_transform", 0.0, window)], window)
    return harness.Run(list(records), trace, products,
                       {"n": 1000, "p": 100, "nnz": 10_000, "value_bytes": 4, "index_bytes": 4},
                       window, PEAKS)


def test_spmm_share_from_a_trace():
    spmm = reader_module("spmm_roofline")
    flops, nbytes = spmm.work(1000, 100, 10_000, 4, 4, 60)
    least = max(flops / PEAKS["float32_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
    run = _run([("void spmm_kernel<__nv_bfloat16, float>(int)", 0.1, 0.1 + 4 * least),
                ("void rmv_partial_kernel<float>(int)", 0.5, 0.6)],
               products=[("mv", 60), ("rmv", 60)])
    assert spmm.read(run) == pytest.approx(25.0)
    assert reader_module("rmv_roofline").read(run) < 100


def test_readers_find_nothing_and_say_so():
    run = _run([("gemm", 0.0, 0.5)], products=[])
    for name in ("spmm_roofline", "rmv_roofline",
                 "densify_roofline", "sparse.from_scipy_s", "gram.host_payload_s"):
        assert reader_module(name).read(run) is None


def test_densify_share_from_counters_and_trace():
    densify = reader_module("densify_roofline")
    rec = {"spans": {}, "counters": {"densify_passes": {"int8": 1.0, "float32": 1.0}}}
    least = (densify.pass_bytes(1000, 100, 10_000, 4, 4, "int8")
             + densify.pass_bytes(1000, 100, 10_000, 4, 4, "float32")) / PEAKS["hbm_bytes_per_s"]
    run = _run([("void densify_tile_kernel<signed char>(x)", 0.0, least),
                ("void densify_tile_kernel<float>(x)", 0.2, 0.2 + least)], records=[rec])
    assert densify.read(run) == pytest.approx(50.0)


def test_idle_share_counts_overlaps_once():
    run = _run([("a", 0.0, 0.4), ("b", 0.2, 0.5), ("c", 0.8, 0.9)])
    assert run.trace.busy_s == pytest.approx(0.6)
    assert readers.idle_pct(run) == pytest.approx(40.0)
    gaps = run.trace.idle_gaps()
    assert gaps[0] == ["portbench.fit_transform", pytest.approx(0.3)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)


def test_span_and_counter_means():
    recs = [{"spans": {"from_scipy": 1.0}, "counters": {"fit_timings": {"stats": 2.0},
                                                         "engine": "GramPCAEngine",
                                                         "build_seconds": {"host_payload": 4.0}}},
            {"spans": {"from_scipy": 3.0}, "counters": {"fit_timings": {"stats": 4.0},
                                                         "engine": "TiledSparseOperator",
                                                         "build_seconds": {"host_payload": 9.0}}}]
    run = _run([], records=recs)
    assert reader_module("sparse.from_scipy_s").read(run) == 2.0
    assert reader_module("pca.host_stats_s").read(run) == 3.0
    assert reader_module("gram.host_payload_s").read(run) == 4.0
