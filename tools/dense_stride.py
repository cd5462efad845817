"""Time the densified engine's bf16 products over an odd and a padded row stride.

    python3 tools/dense_stride.py [--rows 600000] [--cols 36601] [--widths 64,152] [--repeats 2]

Builds a ``[rows, cols]`` bf16 count form on the card twice per repeat, in
turns: as ``DensifiedOperator`` holds it today (row stride ``cols``) and
with the row stride padded to a multiple of 8 elements (``[rows,
ceil8(cols)]`` allocated, the ``[:, :cols]`` view used), the same values
in both. Times ``_bf16_dot`` in each direction at each operand width with
CUDA events, and prints one JSON line per layout, direction and width: the
milliseconds per call and the share of the card's HBM rate that reading
the form once takes. Needs a CUDA card; imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM = 3.35e12  # bytes/s, H100 SXM


def fill(torch, hi, seed: int, block: int = 16384) -> None:
    """Counts 1-4 at density 0.01, row block by row block, from ``seed``."""

    n, p = hi.shape
    gen = torch.Generator(device=hi.device)
    gen.manual_seed(seed)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        keep = torch.rand((r1 - r0, p), generator=gen, device=hi.device) < 0.01
        val = torch.randint(1, 5, (r1 - r0, p), generator=gen, device=hi.device,
                            dtype=torch.int16)
        hi[r0:r1] = (val * keep).to(torch.bfloat16)


def form(torch, n: int, p: int, padded: bool):
    if not padded:
        return torch.empty((n, p), dtype=torch.bfloat16, device="cuda")
    return torch.empty((n, -(-p // 8) * 8), dtype=torch.bfloat16, device="cuda")[:, :p]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=600_000)
    ap.add_argument("--cols", type=int, default=36_601)
    ap.add_argument("--widths", default="64,152")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from single_algebra_tpu_torch.linalg.operators import _bf16_dot

    if not torch.cuda.is_available():
        print("dense_stride: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    n, p = args.rows, args.cols
    widths = [int(w) for w in args.widths.split(",")]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ops = {w: (torch.randn((p, w), generator=gen, device="cuda").to(torch.bfloat16),
               torch.randn((n, w), generator=gen, device="cuda").to(torch.bfloat16))
           for w in widths}
    first = {}
    for rep in range(args.repeats):
        for padded in ((False, True) if rep % 2 == 0 else (True, False)):
            hi = form(torch, n, p, padded)
            fill(torch, hi, seed=11)
            torch.cuda.synchronize()
            for w in widths:
                for over_rows in (False, True):
                    b = ops[w][1] if over_rows else ops[w][0]
                    out = None
                    for _ in range(2):
                        out = _bf16_dot(hi, b, over_rows)
                    torch.cuda.synchronize()
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    for _ in range(args.calls):
                        _bf16_dot(hi, b, over_rows)
                    t1.record()
                    torch.cuda.synchronize()
                    ms = t0.elapsed_time(t1) / args.calls
                    key = (w, over_rows)
                    if key not in first:
                        first[key] = out.double().cpu()
                        rel = 0.0
                    else:
                        ref = first[key]
                        rel = float((out.double().cpu() - ref).abs().max() / ref.abs().max())
                    print(json.dumps({
                        "repeat": rep, "layout": "padded" if padded else "odd",
                        "row_stride": hi.stride(0), "direction": "rmv" if over_rows else "mv",
                        "width": w, "ms": round(ms, 4),
                        "hbm_pct": round(100 * (2 * n * p) / HBM / (ms / 1e3), 2),
                        "rel_diff_vs_first": rel}), flush=True)
            del hi, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
