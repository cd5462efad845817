"""Run one cell of the benchmark of ``single_algebra_tpu_torch`` on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard
output, one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``--trace 1`` also ``breakdown``) and last
``checks``: each compared number beside its limit, which also close
standard error. Exits with another code than 0, printing no result, when
no card (or fewer than the cell asks for) is present, when the port is not
in the checkout, and when a module of JAX or of the JAX package has been
loaded by the time the window closes. Build outputs go to ``build/`` in
the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "single_algebra_tpu_torch"


def _fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = os.path.join(ROOT, "build")
    for var, sub in (("SINGLE_ALGEBRA_TORCH_BUILD_DIR", ""), ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(build, sub) if sub else build
    sys.path.insert(0, ROOT)

    from portbench import harness

    try:
        bench = harness.load_bench(ROOT)
        cell = harness.Cell(bench, args.workload, ROOT)
    except (OSError, KeyError, ValueError) as e:
        return _fail(f"cannot load the cell: {e!r}")

    import importlib.util

    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device")
    if torch.cuda.device_count() < int(cell.entry["chips"]):
        return _fail(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
                     f"{cell.entry['chips']}")
    spec = importlib.util.find_spec(PACKAGE)
    if spec is None or not os.path.abspath(spec.origin).startswith(ROOT + os.sep):
        return _fail(f"{PACKAGE} is not in the checkout {ROOT}")

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    result, checks = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                                      trace=bool(args.trace), device="cuda", t_start=T_START,
                                      log=log)
    found = harness.banned_modules()
    if found:
        return _fail(f"modules of JAX or of the JAX package were loaded: {found}", 3)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
