"""A new configuration, traffic mix, per-layer metric and check become a
cell by adding files and entries, editing no file that is there."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

DRIVE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from portbench import harness
cell = harness.Cell(harness.load_bench(sys.argv[1]), "tiny.again", sys.argv[1])
res, _ = harness.run_cell(cell, seed=21, seconds=0.1, trace=True, device="cpu",
                          t_start=time.perf_counter())
print(json.dumps(res))
"""


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_make_a_cell(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "single_algebra_tpu_torch"), tmp_path / "single_algebra_tpu_torch")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = _digests(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    with open(pb / "configs" / "tiny.json", "w") as f:
        json.dump({"rows": 3000, "cols": 256, "density": 0.02, "clusters": 8,
                   "pca": {"n_components": 5, "svd_method": "randomized", "n_oversamples": 10,
                           "n_power_iterations": 7, "normalizer": "QR", "engine": "gram"}}, f)
    with open(pb / "traffic" / "again.json", "w") as f:
        json.dump({"intake": "per_request", "fit": {"reseed": True},
                   "warmup": {"requests": 0},
                   "end_to_end": {"fresh_fit_s": {"stat": "quantile", "q": 0.5}}}, f)
    with open(pb / "checks" / "tiny.again.json", "w") as f:
        json.dump({"kind": "exact_eig", "center": True, "sample": 2,
                   "limits": {"ev_gap": 1e-5, "vec_resid": 1e-4, "score_gap": 1e-5}}, f)
    with open(pb / "metrics" / "extra.requests.py", "w") as f:
        f.write("def read(run):\n    return float(len(run.records))\n")
    bench["configs"].append({"name": "tiny", "source": "a test", "why": "a test", "reduced": [],
                             "file": "portbench/configs/tiny.json"})
    bench["workloads"].append({"name": "tiny.again", "config": "tiny", "traffic": "again",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "extra.requests", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "fresh_fit_s",
                               "workloads": ["tiny.again"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    res = subprocess.run([sys.executable, "-c", DRIVE, str(tmp_path)], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["metrics"]["extra.requests"]["value"] == result["attempted"]
    after = _digests(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before
