"""The run's last line, and the refusals that print no result."""

import json
import os
import shutil
import subprocess
import sys
import time

from conftest import ROOT, tiny_cell

from portbench import harness

RUN = os.path.join("portbench", "run.py")
ARGS = ["--workload", "counts-1Mx30k.fresh", "--seed", "5", "--seconds", "1", "--trace", "0"]


def test_last_line_parses_with_its_keys():
    cell = tiny_cell("counts-1Mx30k.fresh")
    result, checks = harness.run_cell(cell, seed=9, seconds=0.1, trace=False, device="cpu",
                                      t_start=time.perf_counter())
    line = json.dumps(result)
    back = json.loads(line.splitlines()[-1])
    assert list(back)[:3] == ["correct", "attempted", "failed"]
    assert list(back)[-1] == "checks"
    assert {"metrics", "device"} <= set(back)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(back["device"])
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for name, c in back["checks"].items():
        assert c == {"value": checks[name][0], "limit": checks[name][1]}


def _run(cwd, env=None):
    return subprocess.run([sys.executable, RUN, *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(ROOT, env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_benchmark_alone_refuses(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
