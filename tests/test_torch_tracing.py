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


# -- the densified engine's spans ------------------------------------------------


def _dense_fit(n=3000, p=1001, k=50):
    """A randomized fit (10 oversamples, 7 power steps, QR) on the
    densified engine, recorded; an odd ``p``, as in GRCh38's 36,601."""

    import collections

    import scipy.sparse as sp

    from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
    from single_algebra_tpu_torch.types import PowerIterationNormalizer, SVDMethod

    rng = np.random.default_rng(17)
    X = sp.random(n, p, density=0.02, format="csr", random_state=rng,
                  data_rvs=lambda size: rng.integers(1, 9, size)).astype(np.float32)
    with ttracing.recording() as rec:
        pca = (SparsePCABuilder().n_components(k).engine("dense")
               .svd_method(SVDMethod.random(10, 7, PowerIterationNormalizer.QR)).build())
        pca.fit_transform(SparseMatrix.from_scipy(X, device="cpu"))
    spans = rec.spans()
    widths = collections.Counter((s["name"], s["attrs"]["width"], s["attrs"]["precise"])
                                 for s in spans if s["name"] in ("dense.mv", "dense.rmv"))
    return rec, spans, widths


def test_dense_fit_spans_each_pass_with_its_width():
    """17 passes over the dense form: the sketch and 7 power steps' A @ B
    (9 with the projection), 7 power steps' A^T @ C and B = Q^T A (8);
    the precise two take the stacked three-term operand."""

    _, spans, widths = _dense_fit()
    assert widths == {("dense.mv", 60, False): 8, ("dense.rmv", 60, False): 7,
                      ("dense.rmv", 180, True): 1, ("dense.mv", 150, True): 1}
    assert all(s["attrs"]["half"] == "hi" for s in spans if s["name"].startswith("dense.")
               and s["name"] != "dense.build")  # counts: bf16-exact, no lo half


def test_dense_build_counts_its_upload_and_each_pass_its_bytes():
    n, p = 3000, 1001
    rec, spans, _ = _dense_fit(n, p)
    build = [s for s in spans if s["name"] == "dense.build"]
    assert len(build) == 1 and build[0]["attrs"] == {"route": "host"}
    assert build[0]["counters"] == {"dense.upload_bytes": 2 * n * p}  # the hi half, no lo
    passes = [s for s in spans if s["name"] in ("dense.mv", "dense.rmv")]
    assert all(s["counters"]["dense.bytes_read"] == 2 * n * p for s in passes)
    assert rec.counters()["dense.bytes_read"] == 17 * n * p * 2
    # the CPU's blocked reduction: one widened block of rows a pass at this size
    assert all(s["counters"]["dense.cublas_calls"] == 1 for s in passes)
    assert rec.counters()["dense.cublas_calls"] == 17
