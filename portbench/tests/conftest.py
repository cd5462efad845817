"""The benchmark's own tests: run with ``python -m pytest portbench/tests``
from the root of the repository. Tests that need a CUDA card carry the
``card`` marker and skip, inside the test, when none is present."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the engine 'auto' takes for each cell on the card (on the CPU 'auto'
#: is the gather engine), and a size the CPU holds
TINY = {
    "counts-1Mx30k.fresh": ("gram", 4096, 512),
    "allgenes-500kx60664.refit": ("tiled", 4096, 600),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny_cell(name: str, root: str = ROOT):
    """A cell at a CPU size: its configuration's rows and columns cut, its
    engine named as 'auto' takes it on the card, a 1,024-row warm-up."""

    from portbench import harness

    engine, rows, cols = TINY[name]
    cell = harness.Cell(harness.load_bench(root), name, root)
    cell.config = dict(copy.deepcopy(cell.config), rows=rows, cols=cols)
    cell.config["pca"]["engine"] = engine
    mix = copy.deepcopy(cell.mix)
    if "rows" in mix.get("warmup", {}):
        mix["warmup"] = {"rows": 1024}
    cell.mix = mix
    return cell


@pytest.fixture
def cuda_or_skip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
