"""No module of JAX or of the JAX package in a run's process, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest
from conftest import ROOT, TINY

from portbench import harness

DRIVE = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/portbench/tests")
from conftest import tiny_cell
from portbench import harness
cell = tiny_cell(sys.argv[2])
harness.run_cell(cell, seed=4, seconds=0.1, trace=True, device="cpu",
                 t_start=time.perf_counter())
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_run_loads_no_jax(name):
    res = subprocess.run([sys.executable, "-c", DRIVE, ROOT, name], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(res.stdout.splitlines()[-1].split(","))
    assert "single_algebra_tpu_torch" in tops
    assert not tops & set(harness.BANNED)


def test_banned_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "single_algebra_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like.sub", sys)
    assert not [m for m in harness.banned_modules() if m.endswith("_like") or "_like." in m]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.banned_modules()


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "portbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(ref, f)))
            assert not names & {"jax", "jaxlib", "flax", "single_algebra_tpu",
                                "single_algebra_tpu_torch", "benchmarks"}, f
