"""The benchmark's densified-engine cell (``grch38-600kx36601.refit``) at a
CPU size, held to the plain reference, and its ``dense_gemm_roofline``
reader on hand-worked shapes.

A tiny copy of the configuration (3,000 x 1,001: an odd number of
columns, as GRCh38's 36,601; engine ``dense`` named, since 'auto' off a
card is the gather engine) runs through ``portbench.harness.run_cell``
under the ``refit`` traffic and is judged by the cell's ``same_sketch``
comparison against ``portbench/reference/pca64.py`` (plain PyTorch in
float64). The cell's own limits are set at its size on the card; at this
size the bf16 power steps move the components further from the float64
solve (the spectrum's gaps are narrower), so the test holds it to limits
set here as ``PERF.md`` sets the cell's: above the program's largest
reading over five seeds (``ev_gap_mean`` 1.25e-5, ``vec_gap_mean``
0.011, ``score_gap`` 1.2e-7) and below the smallest of the control (the
reference at TF32, its power steps' operands through fp8: 1.44e-4,
0.096, 7.6e-5), which fails every one of them.

This file imports no JAX.
"""

import collections
import copy
import importlib.util
import os
import time

import pytest

from portbench import harness
from portbench.control import control_outputs
from portbench.loop import Workload
from portbench.reference.judge import judge_each
from portbench.tracewin import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "grch38-600kx36601.refit"
TINY_LIMITS = {"ev_gap_mean": 4e-5, "vec_gap_mean": 0.03, "score_gap": 1e-5}


def tiny_cell():
    cell = harness.Cell(harness.load_bench(ROOT), CELL, ROOT)
    cell.config = dict(copy.deepcopy(cell.config), rows=3000, cols=1001)
    cell.config["pca"]["engine"] = "dense"
    cell.check = dict(copy.deepcopy(cell.check), limits=dict(TINY_LIMITS))
    return cell


def reader():
    path = os.path.join(harness.HERE, "metrics", "dense_gemm_roofline.py")
    spec = importlib.util.spec_from_file_location("dense_gemm_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_cell_states_the_published_widths():
    cell = harness.Cell(harness.load_bench(ROOT), CELL, ROOT)
    c = cell.config
    assert (c["rows"], c["cols"], c["density"], c["reduced"]) == (600_000, 36_601, 0.01, [])
    assert c["pca"] == {"n_components": 50, "svd_method": "randomized", "n_oversamples": 10,
                        "n_power_iterations": 7, "normalizer": "QR", "engine": "auto"}
    assert cell.check["kind"] == "same_sketch" and cell.check["sample"] == 3
    assert {m["name"] for m in cell.per_layer} == {"dense_gemm_roofline",
                                                   "device.idle_pct.refit"}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "refit_s", "refit_p90_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct_against_the_reference(trace):
    cell = tiny_cell()
    result, checks = harness.run_cell(cell, seed=2**31 + 29, seconds=0.3, trace=bool(trace),
                                      device="cpu", t_start=time.perf_counter())
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["correct"], checks
    assert set(checks) == set(TINY_LIMITS)
    if not trace:
        assert set(result["metrics"]) == {"setup_s", "refit_s", "refit_p90_s"}
    else:
        # no device on the CPU: the roofline finds no kernel and says so
        assert "dense_gemm_roofline" not in result["metrics"]
        assert "device.idle_pct.refit" in result["metrics"]


def test_the_probe_sees_every_pass_with_its_width():
    cell = tiny_cell()
    wl = Workload(cell.config, cell.mix, seed=2**33 + 1, device="cpu")
    wl.draw()
    wl.hold()
    wl.probe_products()
    wl.request(None)
    assert collections.Counter(wl.products) == {("mv", 60): 8, ("rmv", 60): 7,
                                                ("rmv", 180): 1, ("mv", 150): 1}


def test_the_control_fails_the_tiny_limits_the_program_meets():
    cell = tiny_cell()
    wl = Workload(cell.config, cell.mix, seed=77, device="cpu")
    wl.draw()
    wl.hold()
    outs = [wl.request(None)[0] for _ in range(2)]
    kw = dict(config=cell.config, check=cell.check, device="cpu")
    program = judge_each(wl.X, outs, **kw)
    control = judge_each(wl.X, control_outputs(wl.X, cell, "cpu", [o["seed"] for o in outs]),
                         **kw)
    for got in program:
        assert all(got[k] <= lim for k, lim in TINY_LIMITS.items()), got
    for got in control:
        assert all(got[k] > lim for k, lim in TINY_LIMITS.items()), got


def test_dense_gemm_work_by_hand():
    r = reader()
    # 4 x 3 form, operand width 2: 12 bf16 values, the operand, the float32 result
    assert r.work(4, 3, "mv", 2) == (48, 24 + 2 * 3 * 2 + 4 * 4 * 2)
    assert r.work(4, 3, "rmv", 2) == (48, 24 + 2 * 4 * 2 + 4 * 3 * 2)
    # the cell: a power step's A @ B and the precise B = Q^T A
    n, p = 600_000, 36_601
    assert r.work(n, p, "mv", 60) == (2 * n * p * 60, 2 * n * p + 2 * p * 60 + 4 * n * 60)
    assert r.work(n, p, "rmv", 180) == (2 * n * p * 180, 2 * n * p + 2 * n * 180 + 4 * p * 180)
    flops, nbytes = r.work(n, p, "mv", 60)
    assert nbytes / 3.35e12 > flops / r.BF16_FLOPS  # memory-bound at every width it runs


#: kernel names from the card's trace of a refit window (NVIDIA H100 80GB HBM3,
#: torch 2.11.0+cu128): the dense products' bf16 GEMMs, then the solver's
#: float32 GEMMs, which the share must not count
BF16_GEMMS = [
    "void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm_bf16_64x256_32x4_nt_align8>"
    "(cutlass_80_tensorop_s16816gemm_bf16_64x256_32x4_nt_align8::Params)",
    "void cutlass::Kernel2<cutlass_75_tensorop_s1688gemm_bf16_128x128_nn_align1>"
    "(cutlass_75_tensorop_s1688gemm_bf16_128x128_nn_align1::Params)",
    "nvjet_tss_64x512_64x2_1x2_h_bz_coopB_NNT",
    "nvjet_tss_160x256_64x3_1x2_h_bz_coopA_NNN",
]
F32_GEMMS = [
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x32x8_stage3_warpsize1x2x1_ffma_aligna4_"
    "alignc4_execute_kernel__5x_cublas",
    "void batch_trsm_right_kernel<float, 64, 4, 3, false, false, true>"
    "(cublasTrsmBatchParams2<float>, float, float const*, int)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
]


@pytest.mark.parametrize("name", BF16_GEMMS)
def test_the_matcher_takes_the_bf16_gemms(name):
    assert reader().is_dense_gemm(name)


@pytest.mark.parametrize("name", F32_GEMMS)
def test_the_matcher_refuses_the_float32_kernels(name):
    assert not reader().is_dense_gemm(name)


def _run(device, products):
    trace = Trace(device, [("portbench.fit_transform", 0.0, 1.0)], 1.0)
    return harness.Run([], trace, products, {"n": 1000, "p": 101, "nnz": 1010, "value_bytes": 4,
                                             "index_bytes": 4}, 1.0,
                       {"float32_flops": 67e12, "hbm_bytes_per_s": 3.35e12})


def test_dense_gemm_share_from_a_trace():
    r = reader()
    least = sum(max(f / r.BF16_FLOPS, b / 3.35e12)
                for f, b in (r.work(1000, 101, "mv", 60), r.work(1000, 101, "rmv", 60)))
    gemm = BF16_GEMMS[2]
    run = _run([(gemm, 0.1, 0.1 + 2 * least),
                (F32_GEMMS[0], 0.5, 0.9)],
               [("mv", 60), ("rmv", 60)])
    assert r.read(run) == pytest.approx(50.0)
    assert r.read(_run([(gemm, 0.0, 0.5)], [])) is None  # no seam: nothing probed
    assert r.read(_run([], [("mv", 60)])) is None  # no bf16 GEMM in the trace
