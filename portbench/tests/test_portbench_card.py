"""On a card: one short run of each cell's timed path at a small size,
judged by the reference."""

import time

import pytest
from conftest import TINY, tiny_cell

from portbench import harness


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(TINY))
def test_small_run_on_the_card(name, cuda_or_skip):
    cell = tiny_cell(name)
    result, checks = harness.run_cell(cell, seed=77, seconds=0.5, trace=True, device="cuda",
                                      t_start=time.perf_counter())
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert checks["score_gap"][0] <= checks["score_gap"][1]
