"""``utils/tracing.py`` of the torch port against the JAX package's.

The stage dict behaves as the JAX one does (``tests/test_tracing.py``,
mirrored on both packages), and ``profile_trace`` writes a Chrome trace
whose events name each stage.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from single_algebra_tpu.utils import tracing as jtracing
from single_algebra_tpu_torch.utils import tracing as ttracing


@pytest.mark.parametrize("mod", [jtracing, ttracing], ids=["jax", "torch"])
def test_stage_accumulates(mod):
    mod.reset_stage_timings()
    with mod.stage("a"):
        x = np.ones(10).sum()
    with mod.stage("a"):
        x += 1
    with mod.stage("b"):
        pass
    t = mod.stage_timings()
    assert set(t) == {"a", "b"}
    assert t["a"] >= 0 and t["b"] >= 0
    mod.reset_stage_timings()
    assert mod.stage_timings() == {}


def test_stage_records_on_an_exception_and_per_thread():
    import threading

    ttracing.reset_stage_timings()
    with pytest.raises(RuntimeError):
        with ttracing.stage("boom"):
            raise RuntimeError("x")
    seen = {}
    th = threading.Thread(target=lambda: seen.update(ttracing.stage_timings()))
    th.start()
    th.join()
    assert seen == {}  # another thread has its own dict
    # an aborted stage adds no time, in both packages
    assert "boom" not in ttracing.stage_timings()
    jtracing.reset_stage_timings()
    with pytest.raises(RuntimeError):
        with jtracing.stage("boom"):
            raise RuntimeError("x")
    assert "boom" not in jtracing.stage_timings()


def test_stage_timings_is_a_copy():
    ttracing.reset_stage_timings()
    with ttracing.stage("c"):
        pass
    t = ttracing.stage_timings()
    t["c"] = -1.0
    assert ttracing.stage_timings()["c"] >= 0
    ttracing.reset_stage_timings()


def test_profile_trace_writes_a_trace_naming_the_stages(tmp_path):
    ttracing.reset_stage_timings()
    a = torch.randn(64, 64)
    with ttracing.profile_trace(str(tmp_path)):
        with ttracing.stage("gram_pass"):
            g = a.T @ a
        with ttracing.stage("solve"):
            torch.linalg.eigh(g)
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"gram_pass", "solve"} <= names
    assert set(ttracing.stage_timings()) == {"gram_pass", "solve"}
    ttracing.reset_stage_timings()


def test_tracing_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; import single_algebra_tpu_torch.utils.tracing; "
            "assert 'jax' not in sys.modules")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
