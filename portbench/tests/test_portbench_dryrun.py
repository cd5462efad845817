"""A dry run of each traffic mix at a CPU size, judged by the reference."""

import json
import math
import time

import pytest
from conftest import TINY, tiny_cell

from portbench import harness


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", sorted(TINY))
def test_dry_run(name, trace):
    cell = tiny_cell(name)
    result, checks = harness.run_cell(cell, seed=2**31 + 17, seconds=0.2, trace=bool(trace),
                                      device="cpu", t_start=time.perf_counter())
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(checks) == set(cell.check["limits"])
    assert all(v is not None and math.isfinite(v) for v, _ in checks.values())
    assert checks["score_gap"][0] <= checks["score_gap"][1]
    if cell.check["kind"] == "exact_eig":
        assert result["correct"], checks
    if trace:
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.loads(json.dumps(result))


def test_fresh_requests_span_the_window():
    cell = tiny_cell("counts-1Mx30k.fresh")
    result, _ = harness.run_cell(cell, seed=3, seconds=0.5, trace=False, device="cpu",
                                 t_start=time.perf_counter())
    fit = result["metrics"]["fresh_fit_s"]["value"]
    assert result["attempted"] * fit >= 0.5
