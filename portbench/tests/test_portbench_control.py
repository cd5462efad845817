"""The control (the plain reference at TF32, fp8 where the program's
stage is bf16, put in the program's place) fails each cell's comparison
at a size a test run holds, where the program passes it."""

import pytest
from conftest import TINY, tiny_cell

from portbench.control import control_outputs
from portbench.loop import Workload
from portbench.reference.judge import judge_each


def _over(nums, limits):
    return sorted(k for k, v in nums.items() if k in limits and v > limits[k])


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_where_the_program_passes(name):
    cell = tiny_cell(name)
    cell.config = dict(cell.config, rows=8192)
    wl = Workload(cell.config, cell.mix, seed=31, device="cpu")
    wl.draw()
    wl.hold()
    out, _ = wl.request(None if wl.held is not None else wl.X)
    kw = dict(config=cell.config, check=cell.check, device="cpu")
    limits = cell.check["limits"]
    control = judge_each(wl.X, control_outputs(wl.X, cell, "cpu", [out["seed"]]), **kw)[0]
    program = judge_each(wl.X, [out], **kw)[0]
    assert "score_gap" in _over(control, limits)
    assert program["score_gap"] * 10 < control["score_gap"]
    if cell.check["kind"] == "exact_eig":
        assert not _over(program, limits)
        assert set(_over(control, limits)) >= {"ev_gap_mean", "vec_resid", "score_gap"}
