"""The control of the comparison that decides ``correct``.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--program]

For each seed: draws the cell's matrix at its own size, puts the plain
reference in the program's place computed one precision step below the
float32 that the configuration states (TF32: ``pca64``'s ``"tf32"``
precision), and judges its outputs with the cell's own comparison; with
``--program`` it also judges the program's own request(s) on the same
matrix in the same process (the fresh mix: one request; the refit mix:
as many refits as the cell's check samples, after the engine is built).
Prints one JSON line per seed and side with each number beside its
limit. Benchmark runs do not run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_outputs(X, cell, device, seeds) -> list:
    """The plain reference at TF32 in the program's place: the outputs a
    request of the cell would give (one per seed in ``seeds`` for a
    refit). A stage that the program runs below float32 goes one step
    further down, as the cell's check file names it under ``control``:
    ``"power_steps": "fp8"`` (the bf16 operands of the randomized power
    steps)."""

    from portbench.reference import pca64

    cfg, check = cell.config, cell.check
    ladder = check.get("control", {})  # stages the program runs below float32
    k = int(cfg["pca"]["n_components"])
    A = pca64.Csr.from_scipy(X, device, "tf32")
    n = A.shape[0]
    mu = A.col_sums() / n
    if check["kind"] == "same_sketch":
        pca = cfg["pca"]
        outs = []
        for seed in seeds:
            s, vt = pca64.randomized_svd(A, mu, k, int(pca["n_oversamples"]),
                                         int(pca["n_power_iterations"]), seed,
                                         power_round=pca64.fp8_round
                                         if ladder.get("power_steps") == "fp8" else None)
            outs.append({"ev": (s.double() ** 2 / (n - 1)).cpu().numpy(), "vt": vt,
                         "t": pca64.project(A, mu, vt), "seed": seed})
        return outs
    G = pca64.gram(A)
    if check["center"]:  # the rank-1 centering is a product too: TF32 operands
        G.addr_(pca64.tf32_round(mu), pca64.tf32_round(mu), alpha=-n)
    lam, V, _ = pca64.top_eig(G, k, "tf32")
    vt = V.T.contiguous()
    return [{"ev": (lam.double() / (n - 1)).cpu().numpy(), "vt": vt,
             "t": pca64.project(A, mu, vt)}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    os.environ["SINGLE_ALGEBRA_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build")
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    from portbench import datagen, harness
    from portbench.loop import _RESEED, Workload
    from portbench.reference.judge import judge_each

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_bench(ROOT), args.workload, ROOT)
    limits = cell.check["limits"]
    n_fits = 1 if cell.check.get("sample", "all") == "all" else int(cell.check["sample"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        wl = Workload(cell.config, cell.mix, seed=seed, device="cuda")
        wl.draw()
        sides = []
        if args.program:
            wl.build_kernels()
            wl.hold()
            source = None if wl.held is not None else wl.X
            outs = [wl.request(source)[0] for _ in range(n_fits)]
            wl.held = None
            torch.cuda.empty_cache()
            sides.append(("program", outs))
        if sides:
            fit_seeds = [o["seed"] for o in sides[0][1]]
        else:
            rng = np.random.default_rng(datagen.seed_sequence(seed, _RESEED))
            fit_seeds = [int(rng.integers(0, 2**31 - 1)) for _ in range(n_fits)]
        sides.append(("control_tf32", control_outputs(wl.X, cell, "cuda", fit_seeds)))
        for side, outs in sides:
            got = judge_each(wl.X, outs, config=cell.config, check=cell.check, device="cuda")
            worst = {}
            for g in got:
                for name, v in g.items():
                    worst[name] = max(worst.get(name, v), v)
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "numbers": {k: {"value": v, "limit": limits.get(k)}
                                          for k, v in worst.items()},
                              "fails": sorted(k for k, v in worst.items()
                                              if k in limits and v > limits[k]),
                              "seconds": time.perf_counter() - t0}), flush=True)
        del wl, sides
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
