#!/usr/bin/env python3
"""Chip smoke of the torch port: its main paths once each, on one CUDA card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py    # ~10 minutes: the north star, then the tiled path

Phases, one JSON line each:

1. ``env``: card name and power limit, torch / CUDA / nvcc versions,
   whether triton imports and CUTLASS's headers exist.
2. ``build``: every kernel library compiled from
   ``single_algebra_tpu_torch/csrc`` (one ``nvcc -Xptxas -v`` per source,
   all started together), with the time and the ptxas report per kernel.
3. ``kernel``: the densify kernel against its plain PyTorch version on the
   card at the Gram path's slab shapes (slab 8192, col_tile 256, 30,720
   dense rows, wt 8 and 16, plus a slab with duplicate ids) for int8, bf16
   and f32 outputs: they must be EXACTLY equal. Times from CUDA events.
4. ``gram_tiers``: the int8, bf16 and f32 Gram tiers (blocked path) on the
   card against a float64 host Gram.
5. ``main_path``: the north star. ``SparsePCABuilder().n_components(50)
   .svd_method(SVDMethod.random(10, 7, QR))`` ``fit_transform`` with
   engine 'auto' on a 1M x 30k planted-spectrum count matrix
   (``benchmarks/_datagen.py``), cold (the first fit on a matrix fresh
   from ``from_scipy``: every value gate, the column stats and the payload
   build are inside the window) and warm. The engine must be
   ``GramPCAEngine``, the densify kernel must have launched, the scores
   must be finite and of shape [n, 50], and the explained variance must
   agree with an independent float64 truth computed on the card (dense
   float64 Gram of CSR row chunks, float64 subspace iteration,
   ``eigvalsh`` of the projected Gram) to <= 1e-5 relative (max error
   over the 50 EVs / the largest EV).
6. ``breakdown``: the warm layers one by one (CUDA events), and ``idle``:
   the device idle share of the Gram pass and of a warm ``fit_transform``
   from one ``torch.profiler`` window each.
7. ``kernel_spmm`` / ``kernel_rmv``: the tiled engine's kernels against
   their plain versions on the card, on random payloads of the tiled
   path's tile geometry (R 16,384, 237 tiles of 256 columns, kp 64): wt 16
   bf16 payload x bf16 and x f32 operand, wt 24 f32 x f32, duplicate ids,
   an all-padding row block; and, inside ``tiled_path``, on the engine's
   own payload at all its 500,736 rows (bf16 x bf16 and bf16 x f32, kp
   64), whose times go into the kernels line. Each case fails above
   max |kernel - plain| / max |plain| = 1e-5.
8. ``tiled_path``: the same builder with engine 'auto' on a 500,000 x
   60,664 count matrix (all human genes; the dense bf16 form does not fit
   0.6 x 80 GB and the Gram does not fit p > 40,960), cold and warm. The
   engine must be ``TiledSparseOperator``, both tiled kernels must have
   launched, the scores must be finite and [500000, 50]. ``tiled_ev``:
   the explained variance against a float64 run of the same randomized
   algorithm with the same sketch (``randomized_svd`` over float64
   ``torch.sparse_csr_tensor`` products, centered by
   ``CenteredOperator``) fails above 1e-4 (max |dEV| / the largest EV);
   the error against the exact float64 truth (dense float64 Gram,
   subspace iteration) is reported with no bar, as is the process's peak
   host memory.
9. ``tiled_breakdown``: warm CUDA-event times of one ``mv_fast``,
   ``rmv_fast``, ``mv`` and ``rmv`` at kp 64 and of the overflow
   ``ell_spmm`` products, and ``tiled_idle``: the device idle share of a
   warm ``fit_transform``.
10. ``library``: one PyTorch call per kernel that computes the same
   function, timed with CUDA events and used nowhere in the port: the
   float32 CSR ``.to_dense()`` of one 8,192-row north-star slab
   (densify), float32 ``torch.sparse_csr_tensor`` products ``X @ B`` and
   ``X^T @ C`` at kp 64 on the tiled path's matrix (spmm, rmv; bf16 too
   where torch takes it). ``tiled_bounds``: the stored slots of the
   engine's payload and the kernels' bounds.

Each kernel's ``bound_ms`` is the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and its
float32 multiply-adds (2 x stored slots x kp) over 67 TFLOP/s.

Then, as the last three lines: ``{"kernels": [...]}``, the card's
``name, power.limit`` from nvidia-smi, and ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero; with no CUDA device it exits 2
before printing any result.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
EV_FAIL = 1e-5  # the phase fails above this EV relative error
EV_TARGET = 1e-6  # BASELINE.json's explained-variance parity target
TPU_KERNELS = "single_algebra_tpu/ops/pallas/spmm_kernel.py"
KERNEL_SRC = "single_algebra_tpu_torch/csrc/tiled_ell_densify.cu"
TILED_SRC = "single_algebra_tpu_torch/csrc/tiled_ell_spmm.cu"
N_CELLS, N_GENES, K = 1_000_000, 30_000, 50  # the north star
TILED_CELLS, TILED_GENES = 500_000, 60_664  # the tiled path: all human genes
TILED_EV_FAIL = 1e-4  # the tiled phase fails above this EV error vs its f64 twin
KERNEL_REL_FAIL = 1e-5  # spmm / rmv kernel vs plain, relative to max |plain|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA's data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores


def bound(nbytes: float, flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the float32 rate."""

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return (res.stdout or res.stderr).strip()


def card_line() -> str:
    return run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


def phase_env(torch) -> None:
    try:
        import triton  # noqa: F401

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    from single_algebra_tpu_torch.ops.cuda_lib import nvcc

    emit(
        "env",
        card=card_line(),
        torch=torch.__version__,
        torch_cuda=torch.version.cuda,
        nvcc=run([nvcc(), "--version"]).splitlines()[-1:],
        triton=triton_version,
        cutlass_include=os.path.isdir("/usr/local/cutlass/include"),
        python=sys.version.split()[0],
    )


def phase_build() -> None:
    """Every kernel library, one nvcc per source, all started together;
    the ptxas report per kernel (registers, shared memory, spills)."""

    from single_algebra_tpu_torch.ops import cuda_lib, densify, spmm_kernel

    t0 = time.perf_counter()
    cuda_lib.build_all(verbose=True)
    cuda_lib.load("tiled_ell_densify", densify._bind)
    cuda_lib.load("tiled_ell_spmm", spmm_kernel._bind)
    ptxas = {}
    for lib, log in cuda_lib.build_logs.items():
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and ("Used" in line or "spill" in line):
                ptxas.setdefault(f"{lib}:{kernel}", []).append(line.split(":", 1)[-1].strip())
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def _time_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(torch) -> dict:
    """Kernel vs plain version at the main path's slab shapes."""

    from single_algebra_tpu_torch.ops.densify import (
        tiled_ell_densify_t, tiled_ell_densify_t_plain,
    )

    dev = torch.device("cuda")
    ntiles, ct, slab = 120, 256, 8192
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst, headline = 0.0, None
    for case, wt in (("wt8", 8), ("wt16", 16), ("dup_ids", 8)):
        # a bucket payload two slabs wide; the kernel reads the second slab
        # through its offset, as the Gram engine does
        R = 2 * slab
        vals = torch.randint(1, 60, (ntiles * wt, R), generator=gen, device=dev).float()
        if case == "dup_ids":
            # few distinct ids per group: duplicates must sum in slot order
            ids = torch.randint(0, 4, (ntiles * wt, R), generator=gen, device=dev)
            vals = vals + 0.25 * torch.rand(vals.shape, generator=gen, device=dev)
        else:
            ids = torch.randint(0, ct, (ntiles * wt, R), generator=gen, device=dev)
        pad = torch.rand(vals.shape, generator=gen, device=dev) < 0.5
        vals[pad] = 0.0  # padding slots are (0, 0)
        ids[pad] = 0
        ids = ids.int()
        for out_dtype in (torch.int8, torch.bfloat16, torch.float32):
            kw = dict(wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=out_dtype,
                      row_offset=slab, rows=slab)
            got = tiled_ell_densify_t(vals, ids, **kw)
            want = tiled_ell_densify_t_plain(vals, ids, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            equal = bool(torch.equal(got, want))
            ms = _time_ms(torch, lambda: tiled_ell_densify_t(vals, ids, **kw), 20)
            plain_ms = _time_ms(torch, lambda: tiled_ell_densify_t_plain(vals, ids, **kw), 3)
            moved = got.numel() * got.element_size() + ntiles * wt * slab * 8
            emit(
                "kernel", case=case, wt=wt, out_dtype=str(out_dtype).split(".")[-1],
                shape=list(got.shape), equal=equal, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, hbm_gb_per_s=moved / ms / 1e6,
            )
            if not equal:
                raise AssertionError(f"densify kernel != plain ({case}, {out_dtype})")
            worst = max(worst, err)
            if case == "wt8" and out_dtype == torch.int8:
                headline = dict(ms=ms, plain_ms=plain_ms, **bound(moved))
            del got, want
    return dict(max_abs_err=worst, **headline)


def phase_gram_tiers(torch) -> None:
    """The three Gram tiers on the card (blocked path, pp > 4096) against a
    float64 host Gram of the same matrix."""

    import numpy as np
    import scipy.sparse as sp

    from single_algebra_tpu_torch import SparseMatrix
    from single_algebra_tpu_torch.linalg.gram import GramPCAEngine, gram_matrix

    rng = np.random.default_rng(11)
    base = sp.random(20000, 4500, density=0.01, format="csr", random_state=rng,
                     dtype=np.float64)
    for tier, data in (
        ("int8", np.round(base.data * 100)),
        ("bf16", np.round(base.data * 127) + 128),
        ("f32", base.data),
    ):
        X = sp.csr_matrix((data.astype(np.float32), base.indices, base.indptr),
                          shape=base.shape)
        m = SparseMatrix.from_scipy(X, device="cuda")
        eng = GramPCAEngine.from_matrix(m)
        G = gram_matrix(eng)[: X.shape[1], : X.shape[1]].cpu().numpy()
        X64 = X.astype(np.float64)
        ref = (X64.T @ X64).toarray()
        rel = float(np.abs(G - ref).max() / np.abs(ref).max())
        emit("gram_tiers", tier=tier, exact=eng.meta[3], i8=eng.meta[4],
             p_padded=eng.p_padded, rel_err=rel)
        limit = 0.0 if tier == "int8" else 1e-6
        if rel > limit:
            raise AssertionError(f"{tier} Gram rel err {rel} > {limit}")


def f64_truth_ev(torch, X, k: int, chunk: int = 4096, device="cuda"):
    """Top-k explained variances of the centered matrix in float64, on the
    card and independent of the port: the dense float64 Gram of CSR row
    chunks, centered, then float64 subspace iteration on it with a
    Rayleigh-Ritz step (``eigvalsh`` of the projected Gram) until the
    Ritz values stop moving (cuSOLVER's ``eigvalsh`` refuses the whole
    30,000-wide Gram)."""

    import numpy as np

    dev = torch.device(device)
    n, p = X.shape
    G = torch.zeros((p, p), dtype=torch.float64, device=dev)
    colsum = torch.zeros(p, dtype=torch.float64, device=dev)
    dense = torch.empty((chunk, p), dtype=torch.float64, device=dev)
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        lo, hi = int(X.indptr[r0]), int(X.indptr[r1])
        counts = torch.from_numpy(np.diff(X.indptr[r0:r1 + 1]).astype(np.int64)).to(dev)
        rows = torch.repeat_interleave(torch.arange(r1 - r0, device=dev), counts)
        cols = torch.from_numpy(X.indices[lo:hi].astype(np.int64)).to(dev)
        vals = torch.from_numpy(X.data[lo:hi].astype(np.float64)).to(dev)
        D = dense[: r1 - r0].zero_()
        D.index_put_((rows, cols), vals, accumulate=True)
        G.addmm_(D.T, D)
        colsum += D.sum(dim=0)
    del dense
    mu = colsum / n
    G.addr_(mu, mu, alpha=-n)  # in place: no [p, p] temporaries

    b = min(2 * k + 28, p)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    Q = torch.linalg.qr(torch.randn((p, b), generator=gen, dtype=torch.float64, device=dev))[0]
    Z, prev = G @ Q, None
    for it in range(500):
        Q = torch.linalg.qr(Z)[0]
        Z = G @ Q
        ritz = torch.linalg.eigvalsh(Q.T @ Z).flip(0)[:k]
        if prev is not None and float(((ritz - prev).abs() / ritz[0]).max()) < 1e-13:
            break
        prev = ritz
    return (ritz / (n - 1)).cpu().numpy(), it + 1


def phase_breakdown(torch, eng, pca, k: int) -> None:
    """Where a full pass goes on the card (warm, CUDA events): the densify
    kernel alone over every slab, the whole Gram pass (densify + int8/bf16/
    f32 contraction), the p-space solve and the projection pass."""

    from single_algebra_tpu_torch.linalg import gram as g

    slab = g._slab_for(eng.shape[0])
    exact, i8 = eng.meta[3], eng.meta[4]
    out_dtype = torch.int8 if i8 else (torch.bfloat16 if exact else torch.float32)
    slabs = [(b, i) for b, (_, rc) in enumerate(eng.bwidths) for i in range(rc // slab)]

    def timed(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3, out

    def densify_all(dtype):
        for b, i in slabs:
            eng._densify(b, i, dtype)  # each slab is dropped before the next

    densify_s, _ = timed(lambda: densify_all(out_dtype))
    gram_s, G = timed(lambda: g.gram_matrix(eng))
    mean = pca._mean_device()
    solve_s, (s, vt) = timed(lambda: g._solve_topk(
        G, torch.nn.functional.pad(mean.float(), (0, G.shape[0] - mean.shape[0])),
        eng.shape[0], 42, k=k, center=True, oversamples=10, iters=7))
    Vp = torch.zeros((eng.p_padded, k), dtype=torch.float32, device=G.device)
    Vp[: vt.shape[1]] = vt.T
    project_s, _ = timed(lambda: eng._project_bucketed(Vp))
    project_densify_s, _ = timed(lambda: densify_all(torch.float32))
    emit("breakdown", slabs=len(slabs), densify_gram_dtype_s=densify_s,
         gram_pass_s=gram_s, solve_s=solve_s, projection_pass_s=project_s,
         densify_f32_s=project_densify_s)


def device_idle(torch, fn, top: int = 0) -> dict:
    """One ``torch.profiler`` window around ``fn``: its wall time (host
    clock, synchronized, profiler on), the time in which the card ran at
    least one kernel, copy or memset (the union of the device events'
    intervals, so overlapping events count once and host-side op rows
    never count), and the idle share, 1 - busy / wall. ``top`` > 0 adds
    the device seconds of the ``top`` busiest device event names."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        raise AssertionError("the profiler window recorded no device event")
    busy_us, run_start, run_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > run_end:
            busy_us += run_end - run_start
            run_start = start
        run_end = max(run_end, end)
    busy_s = (busy_us + run_end - run_start) / 1e6
    out = dict(wall_s=wall_s, device_busy_s=busy_s, device_events=len(spans),
               idle_share=1.0 - busy_s / wall_s)
    if top:
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
        out["top_device_s"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return out


def phase_idle(torch, eng, builder, m) -> None:
    """Device idle share of the Gram pass and of a warm fit_transform."""

    from single_algebra_tpu_torch.linalg.gram import gram_matrix

    emit("idle", gram_pass=device_idle(torch, lambda: gram_matrix(eng)),
         warm_fit_transform=device_idle(torch, lambda: builder().build().fit_transform(m)))


def phase_main_path(torch) -> tuple:
    """The main path once, through the user-facing entry points."""

    import numpy as np

    sys.path.insert(0, ROOT)
    from benchmarks._datagen import cluster_counts_big
    from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
    from single_algebra_tpu_torch.linalg.gram import GramPCAEngine
    from single_algebra_tpu_torch.ops import densify
    from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

    n, p, k = N_CELLS, N_GENES, K
    t0 = time.perf_counter()
    X = cluster_counts_big(n, p, n_clusters=64, seed=7, density=0.01)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = SparseMatrix.from_scipy(X, device="cuda")
    from_scipy_s = time.perf_counter() - t0

    def builder():
        return (SparsePCABuilder().n_components(k)
                .svd_method(SVDMethod.random(10, 7, PowerIterationNormalizer.QR)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    densify.reset_launch_counts()
    t0 = time.perf_counter()
    pca = builder().build()
    T = pca.fit_transform(m)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = densify.launch_counts["tiled_ell_densify_t"]
    peak = torch.cuda.max_memory_allocated()
    eng = m._operator_cache.get("auto")
    ev = np.asarray(pca.explained_variance_, np.float64)
    # read after the cold window: the cold fit made and cached every gate
    emit("data", n=n, p=p, nnz=m.nnz, gen_s=gen_s, from_scipy_s=from_scipy_s,
         int8_exact=m.values_int8_exact())

    t0 = time.perf_counter()
    pca2 = builder().build()
    T2 = pca2.fit_transform(m)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    if not isinstance(eng, GramPCAEngine):
        raise AssertionError(f"engine 'auto' built {type(eng).__name__}, not GramPCAEngine")
    if launches <= 0:
        raise AssertionError("the main path launched no densify kernel")
    if tuple(T.shape) != (n, k) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"scores: shape {tuple(T.shape)}, finite={bool(torch.isfinite(T).all())}")
    if not np.all(np.isfinite(ev)) or tuple(T2.shape) != (n, k):
        raise AssertionError("explained variance not finite, or warm scores misshapen")
    warm_vs_cold = float((T2 - T).abs().max() / T.abs().max())

    emit(
        "main_path", engine_requested="auto", engine=type(eng).__name__,
        col_tile=eng.meta[2],
        gram_tier="int8" if eng.meta[4] else ("bf16" if eng.meta[3] else "f32"),
        buckets=[list(b) for b in eng.bwidths], cold_fit_transform_s=cold_s,
        warm_fit_transform_s=warm_s, warm_vs_cold_rel=warm_vs_cold,
        fit_timings_cold=pca._fit_timings, engine_build_s=eng.build_seconds,
        peak_alloc_gb=peak / 1e9,
        densify_launches=launches, T_shape=list(T.shape),
    )

    phase_breakdown(torch, eng, pca, k)
    phase_idle(torch, eng, builder, m)

    t0 = time.perf_counter()
    ev_true, iters = f64_truth_ev(torch, X, k)
    truth_s = time.perf_counter() - t0
    ev_rel_err = float(np.abs(ev - ev_true).max() / ev_true[0])
    emit(
        "ev", ev_rel_err=ev_rel_err, ev_target=EV_TARGET, ev_fail_above=EV_FAIL,
        meets_target=ev_rel_err <= EV_TARGET, truth_s=truth_s,
        truth_subspace_iters=iters, ev_top3=ev[:3].tolist(),
        ev_true_top3=ev_true[:3].tolist(),
    )
    if not ev_rel_err <= EV_FAIL:
        raise AssertionError(f"EV rel err {ev_rel_err} > {EV_FAIL}")
    return launches, library_densify_ms(torch, X)


def csr_on_card(torch, M, dtype):
    import numpy as np

    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)), torch.from_numpy(M.indices.astype(np.int64)),
        torch.from_numpy(M.data.astype(np.float32)), size=M.shape,
    ).to(device="cuda", dtype=dtype)


def library_densify_ms(torch, X, slab: int = 8192) -> float:
    """The densify kernel's yardstick: ``.to_dense()`` of the float32 CSR of
    one 8,192-row slab of the north-star matrix (CUDA events)."""

    A = csr_on_card(torch, X[:slab].tocsr(), torch.float32)
    ms = _time_ms(torch, lambda: A.to_dense(), 10)
    emit("library", kernel="tiled_ell_densify_t", call="float32 CSR [8192, p].to_dense()",
         shape=list(A.shape), ms=ms)
    return ms


def library_tiled_ms(torch, X, kp: int = 64) -> dict:
    """The tiled kernels' yardsticks, one PyTorch call each on the tiled
    path's matrix (CUDA events): ``X @ B`` with X a float32
    ``torch.sparse_csr_tensor`` and B [p, kp], and ``X^T @ C`` with the CSR
    of X^T built beforehand and C [n, kp]; bf16 too where torch's CUDA CSR
    product takes it. -> {kernel: float32 ms}."""

    n, p = X.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out = {}
    for name, M, width in (("tiled_ell_spmm_t", X.tocsr(), p),
                           ("tiled_ell_rmv_t", X.T.tocsr(), n)):
        for dtype in (torch.float32, torch.bfloat16):
            A = csr_on_card(torch, M, dtype)
            D = torch.randn((width, kp), generator=gen, device="cuda").to(dtype)
            try:
                ms, err = _time_ms(torch, lambda: A @ D, 3), None
            except (RuntimeError, NotImplementedError) as e:  # dtype support, reported
                ms, err = None, str(e).splitlines()[0][:200]
            emit("library", kernel=name, call=f"{str(dtype).split('.')[-1]} CSR {list(A.shape)} @ "
                 f"dense {list(D.shape)}", ms=ms, refused=err)
            if dtype == torch.float32:
                out[name] = ms
            del A, D
            torch.cuda.empty_cache()
    return out

def _tiled_payload(torch, gen, R, ntiles, wt, ct, *, dtype, frac, dup=False, pad_rows=0):
    """A random transposed tiled payload on the card: per (tile, row) group
    a Poisson(2.5) number of stored slots (padding trails, as the host
    converter lays it out), values 1..8 (plus a fraction for float32
    payloads), and optionally few distinct ids per group (duplicates) or
    a leading block of all-padding rows."""

    dev = torch.device("cuda")
    sizes = torch.poisson(torch.full((ntiles, 1, R), 2.5, device=dev), generator=gen)
    slot = torch.arange(wt, device=dev).view(1, wt, 1)
    real = (slot < sizes).reshape(ntiles * wt, R)
    if pad_rows:
        real[:, :pad_rows] = False
    vals = torch.randint(1, 9, (ntiles * wt, R), generator=gen, device=dev).float()
    if frac:
        vals += torch.rand(vals.shape, generator=gen, device=dev)
    ids = torch.randint(0, 4 if dup else ct, (ntiles * wt, R), generator=gen, device=dev)
    vals = (vals * real).to(dtype).contiguous()
    ids = (ids * real).int().contiguous()
    return vals, ids


def _compare_tiled(torch, result, gen, case, vals, ids, *, wt, ntiles, ct, kp, odt,
                   pad=0, plain_reps=2, rmv=True) -> None:
    """Both tiled kernels (spmm alone where ``rmv`` is false) against their
    plain versions on one payload with a random operand of dtype ``odt``:
    emits a ``kernel_spmm`` and a ``kernel_rmv`` line, fails above
    KERNEL_REL_FAIL or where a repeated launch differs, and folds the
    worst abs error into ``result``."""

    from single_algebra_tpu_torch.ops.spmm_kernel import (
        tiled_ell_rmv_t, tiled_ell_rmv_t_plain, tiled_ell_spmm_t, tiled_ell_spmm_t_plain,
    )

    R = vals.shape[1]
    kw = dict(wt=wt, ntiles=ntiles, col_tile=ct)
    for phase, fn, plain, width in (
        ("kernel_spmm", tiled_ell_spmm_t, tiled_ell_spmm_t_plain, ntiles * ct),
        ("kernel_rmv", tiled_ell_rmv_t, tiled_ell_rmv_t_plain, R),
    )[:2 if rmv else 1]:
        op = torch.randn((kp, width), generator=gen, device=vals.device).to(odt)
        got = fn(vals, ids, op, **kw)
        want = plain(vals, ids, op, **kw)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        del want
        repeat_equal = bool(torch.equal(fn(vals, ids, op, **kw), got))
        pad_zero = bool(not got[:, :pad].any()) if pad and phase == "kernel_spmm" else None
        del got
        ms = _time_ms(torch, lambda: fn(vals, ids, op, **kw), 10)
        plain_ms = _time_ms(torch, lambda: plain(vals, ids, op, **kw), plain_reps)
        emit(phase, case=case, wt=wt, payload=str(vals.dtype).split(".")[-1],
             operand=str(odt).split(".")[-1], R=R, ntiles=ntiles, col_tile=ct, kp=kp,
             rel_err=rel, max_abs_err=abs_err, repeat_equal=repeat_equal,
             pad_block_zero=pad_zero, ms=ms, plain_ms=plain_ms)
        if not rel <= KERNEL_REL_FAIL or pad_zero is False or not repeat_equal:
            raise AssertionError(f"{phase} {case}: kernel vs plain rel err {rel}, "
                                 f"repeat_equal={repeat_equal}, pad_block_zero={pad_zero}")
        name = "tiled_ell_spmm_t" if phase == "kernel_spmm" else "tiled_ell_rmv_t"
        entry = result.setdefault(name, dict(max_abs_err=0.0))
        entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
        entry.setdefault("cases", {})[case] = dict(ms=ms, plain_ms=plain_ms)
        del op
        torch.cuda.empty_cache()


def phase_kernel_tiled(torch, result: dict) -> None:
    """spmm and rmv kernels vs their plain versions on random payloads of
    the tiled path's tile geometry at R 16,384: the dtype cases, duplicate
    ids and an all-padding row block (the path's own payload is compared
    at its full 500,736 rows in ``tiled_path``)."""

    dev = torch.device("cuda")
    R, ntiles, ct, kp = 16384, 237, 256, 64
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (  # name, wt, payload, operand, dup ids, all-padding rows
        ("bf16_x_bf16", 16, bf16, bf16, False, 0),
        ("bf16_x_f32", 16, bf16, f32, False, 0),
        ("f32_x_f32_wt24", 24, f32, f32, False, 0),
        ("dup_ids", 16, bf16, bf16, True, 0),
        ("pad_block", 16, bf16, f32, False, 4096),
    )
    for case, wt, pdt, odt, dup, pad in cases:
        vals, ids = _tiled_payload(torch, gen, R, ntiles, wt, ct, dtype=pdt,
                                   frac=pdt == f32, dup=dup, pad_rows=pad)
        _compare_tiled(torch, result, gen, case, vals, ids, wt=wt, ntiles=ntiles, ct=ct,
                       kp=kp, odt=odt, pad=pad)
        del vals, ids
        torch.cuda.empty_cache()


def phase_kernel_tiled_path(torch, op, result: dict) -> None:
    """spmm and rmv kernels vs their plain versions on the tiled engine's
    own payload, at the shapes the path gives them (all its rows): at kp 64
    the bf16 operand of the power iterations and the float32 operand of
    the precise products, and spmm at the projection's kp 56 with a float32
    operand (the one shape whose kp is not a multiple of the kernel's
    output chunk). The kp 64 bf16 case gives the kernels line its times."""

    wt, ntiles, ct = op.meta[:3]
    gen = torch.Generator(device=op.device)
    gen.manual_seed(4)
    for case, odt, kp, rmv in (("path_bf16_x_bf16", torch.bfloat16, 64, True),
                               ("path_bf16_x_f32", torch.float32, 64, True),
                               ("path_bf16_x_f32_kp56", torch.float32, 56, False)):
        _compare_tiled(torch, result, gen, case, op.tdata, op.tlocal, wt=wt, ntiles=ntiles,
                       ct=ct, kp=kp, odt=odt, plain_reps=1, rmv=rmv)
    for entry in result.values():
        entry.update(entry["cases"]["path_bf16_x_bf16"])
    # bounds of the bf16 x bf16 case at kp 64: each input read once, each
    # output written once; one multiply-add per stored slot and output column
    R, kp = op.tdata.shape[1], 64
    payload = op.tdata.numel() * op.tdata.element_size() + op.tlocal.numel() * 4
    stored = int((op.tdata != 0).sum())
    flops = 2.0 * stored * kp
    result["tiled_ell_spmm_t"].update(bound(payload + kp * ntiles * ct * 2 + kp * R * 4, flops))
    result["tiled_ell_rmv_t"].update(bound(payload + kp * R * 2 + ntiles * ct * kp * 4, flops))
    emit("tiled_bounds", stored=stored, slots=op.tdata.numel(), payload_bytes=payload,
         spmm=result["tiled_ell_spmm_t"]["bound_ms"], rmv=result["tiled_ell_rmv_t"]["bound_ms"])


class Csr64Operator:
    """``A`` in float64 on the card as two ``torch.sparse_csr_tensor``s (the
    matrix and its transpose): an operator independent of the port's
    payloads and kernels, whose products are exact to float64."""

    def __init__(self, torch, X, device):
        import numpy as np

        def csr(M):
            return torch.sparse_csr_tensor(
                torch.from_numpy(M.indptr.astype(np.int64)),
                torch.from_numpy(M.indices.astype(np.int64)),
                torch.from_numpy(M.data.astype(np.float64)), size=M.shape,
            ).to(device)

        self.shape = X.shape
        self.dtype = torch.float64
        self.device = torch.device(device)
        self.a = csr(X.tocsr())
        self.at = csr(X.tocsc().T.tocsr())

    def mv(self, B):
        return self.a @ B

    def rmv(self, C):
        return self.at @ C


def phase_tiled_path(torch, kernel_result: dict) -> dict:
    """The tiled engine's path once, through the user-facing entry points;
    -> the kernels' launch counts in the cold fit. The full-size kernel
    comparison on the engine's payload adds to ``kernel_result``."""

    import numpy as np

    from benchmarks._datagen import cluster_counts_big
    from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
    from single_algebra_tpu_torch.linalg.operators import CenteredOperator, TiledSparseOperator
    from single_algebra_tpu_torch.linalg.svd import gaussian_sketch, randomized_svd
    from single_algebra_tpu_torch.models.pca import _host_col_stats
    from single_algebra_tpu_torch.ops import cuda_lib
    from single_algebra_tpu_torch.ops.spmm import ell_spmm
    from single_algebra_tpu_torch.sparse import convert as cv
    from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

    n, p, k = TILED_CELLS, TILED_GENES, K
    t0 = time.perf_counter()
    X = cluster_counts_big(n, p, n_clusters=64, seed=7, density=0.01)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = SparseMatrix.from_scipy(X, device="cuda")
    from_scipy_s = time.perf_counter() - t0

    def builder():
        return (SparsePCABuilder().n_components(k)
                .svd_method(SVDMethod.random(10, 7, PowerIterationNormalizer.QR)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    pca = builder().build()
    T = pca.fit_transform(m)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {name: cuda_lib.launch_counts[name]
                for name in ("tiled_ell_spmm_t", "tiled_ell_rmv_t")}
    peak = torch.cuda.max_memory_allocated()
    op = m._operator_cache.get("auto")
    ev = np.asarray(pca.explained_variance_, np.float64)

    t0 = time.perf_counter()
    T2 = builder().build().fit_transform(m)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    if not isinstance(op, TiledSparseOperator):
        raise AssertionError(f"engine 'auto' built {type(op).__name__}, not TiledSparseOperator")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the tiled path did not launch both kernels: {launches}")
    if tuple(T.shape) != (n, k) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"scores: shape {tuple(T.shape)}, finite={bool(torch.isfinite(T).all())}")
    if not np.all(np.isfinite(ev)) or tuple(T2.shape) != (n, k):
        raise AssertionError("explained variance not finite, or warm scores misshapen")
    warm_vs_cold = float((T2 - T).abs().max() / T.abs().max())
    del T2

    # the host passes of the engine choice and the payload build, alone
    src = m._layout_for("row")
    t0 = time.perf_counter()
    wt, ntiles, ovw, n_over = cv.tiled_split_widths(src._h_indptr, src._h_indices, n, p)
    widths_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ovtw_plan = cv.tiled_overflow_col_width(src._h_indptr, src._h_indices, n, p, 256, wt)
    overflow_col_width_s = time.perf_counter() - t0
    wt, nt, ct, br, ovw, ovtw = op.meta
    emit(
        "tiled_path", engine_requested="auto", engine=type(op).__name__, n=n, p=p,
        nnz=m.nnz, gen_s=gen_s, from_scipy_s=from_scipy_s, wt=wt, ntiles=nt, col_tile=ct,
        rows_padded=op.tdata.shape[1], ovw=ovw, ovtw=ovtw, ovtw_plan=ovtw_plan,
        n_overflow=n_over, payload="bf16" if op._bf16 else str(op.tdata.dtype).split(".")[-1],
        lo_present=op.tdata_lo is not None, payload_bytes_f32_accounting=(
            (nt * wt + ovw) * op.tdata.shape[1] * 8
            + (cv.pad_rows(p) * cv.round_up(max(ovtw_plan, 1), 8) * 8 if ovw else 0)),
        payload_bytes_on_card=sum(
            t.numel() * t.element_size() for t in (op.tdata, op.tdata_lo, op.tlocal, op.ov_data,
                                                   op.ov_ids, op.ovt_data, op.ovt_ids)
            if t is not None),
        cold_fit_transform_s=cold_s, warm_fit_transform_s=warm_s,
        warm_vs_cold_rel=warm_vs_cold, fit_timings_cold=pca._fit_timings,
        engine_build_s=op.build_seconds, split_widths_s=widths_s,
        overflow_col_width_s=overflow_col_width_s, peak_alloc_gb=peak / 1e9,
        launches=launches, T_shape=list(T.shape),
    )
    del T

    phase_tiled_breakdown(torch, op, ell_spmm)
    emit("tiled_idle", warm_fit_transform=device_idle(
        torch, lambda: builder().build().fit_transform(m), top=8))
    phase_kernel_tiled_path(torch, op, kernel_result)
    for name, ms in library_tiled_ms(torch, X).items():
        kernel_result[name]["library_ms"] = ms

    # EV bar: the same randomized algorithm, the same sketch, float64 products
    l = k + 10
    omega = gaussian_sketch(p, l, 42, dtype=torch.float32, device=m.device).double()
    col_sums, _ = _host_col_stats(m)
    mu = torch.from_numpy(col_sums / n).to(m.device)
    del op, m, src  # the engine goes with the matrix's operator cache
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_op = CenteredOperator(Csr64Operator(torch, X, "cuda"), mu)
    res = randomized_svd(ref_op, k, 10, 7, PowerIterationNormalizer.QR, omega=omega)
    ev_same = (res.s.double() ** 2 / (n - 1)).cpu().numpy()
    same_s = time.perf_counter() - t0
    del ref_op, res, omega
    torch.cuda.empty_cache()
    same_err = float(np.abs(ev - ev_same).max() / ev_same[0])

    t0 = time.perf_counter()
    ev_true, iters = f64_truth_ev(torch, X, k)
    truth_s = time.perf_counter() - t0
    truth_err = float(np.abs(ev - ev_true).max() / ev_true[0])
    emit(
        "tiled_ev", ev_rel_err_same_sketch_f64=same_err, fail_above=TILED_EV_FAIL,
        same_sketch_f64_s=same_s, ev_rel_err_f64_truth=truth_err,
        truth="dense float64 Gram + float64 subspace iteration", truth_s=truth_s,
        truth_subspace_iters=iters, ev_top3=ev[:3].tolist(),
        ev_same_sketch_top3=ev_same[:3].tolist(), ev_true_top3=ev_true[:3].tolist(),
        ev_tail=[ev[-1], ev_same[-1], ev_true[-1]],
        host_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    )
    if not same_err <= TILED_EV_FAIL:
        raise AssertionError(f"tiled EV rel err vs the same-sketch f64 run {same_err} > {TILED_EV_FAIL}")
    return launches


def phase_tiled_breakdown(torch, op, ell_spmm) -> None:
    """Warm CUDA-event times of one product of each class at kp 64 (l = 60
    sketch columns) and of the overflow side products alone."""

    n, p = op.shape
    gen = torch.Generator(device=op.device)
    gen.manual_seed(5)
    B = torch.randn((p, K + 10), generator=gen, device=op.device)
    C = torch.randn((n, K + 10), generator=gen, device=op.device)
    times = {name: _time_ms(torch, lambda f=getattr(op, name), a=arg: f(a), 3)
             for name, arg in (("mv_fast", B), ("rmv_fast", C), ("mv", B), ("rmv", C))}
    if op.meta[4]:
        times["overflow_mv_ell_spmm"] = _time_ms(
            torch, lambda: ell_spmm(op.ov_data, op.ov_ids, B), 3)
    if op.meta[5]:
        times["overflow_rmv_ell_spmm"] = _time_ms(
            torch, lambda: ell_spmm(op.ovt_data, op.ovt_ids, C), 3)
    emit("tiled_breakdown", kp=64, ms=times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import single_algebra_tpu_torch  # noqa: F401  (fails outside the repo)

    phase_env(torch)
    phase_build()
    kern = phase_kernel(torch)
    phase_gram_tiers(torch)
    launches, kern["library_ms"] = phase_main_path(torch)
    torch.cuda.empty_cache()
    tiled_kern = {}
    phase_kernel_tiled(torch, tiled_kern)
    tiled_launches = phase_tiled_path(torch, tiled_kern)
    kernels = [dict(name="tiled_ell_densify_t", source=KERNEL_SRC, line=221,
                    launches=launches, **kern)]
    for name, line in (("tiled_ell_spmm_t", 135), ("tiled_ell_rmv_t", 299)):
        kernels.append(dict(name=name, source=TILED_SRC, line=line,
                            launches=tiled_launches[name], **tiled_kern[name]))
    print(json.dumps({"kernels": [{
        "name": k["name"], "route": "cuda", "source": k["source"],
        "replaces": f"{TPU_KERNELS}:{k['line']}", "launches": k["launches"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    } for k in kernels]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
