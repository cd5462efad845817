"""The edge partition of ``models/draw_graph.py``, the one part ported yet.

Counterpart of ``single_algebra_tpu/models/draw_graph.py::
partition_edges_by_slab``, which the mesh mode of t-SNE imports. The
ForceAtlas2 layout itself waits for ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import numpy as np

__all__: list = []


def partition_edges_by_slab(src, dst, val, e_real: int, ndev: int, rs: int):
    """Split a src-SORTED flat edge list into per-device slabs of equal
    padded length (``[ndev, Es]`` arrays, ``Es`` a multiple of 1,024).
    Filler edges sit at each slab's LAST row (keeps the local src sorted)
    with val 0 (inert)."""

    bounds = np.searchsorted(src[:e_real], np.arange(ndev + 1) * rs)
    es_max = max(int(np.diff(bounds).max()), 1)
    es_pad = -(-es_max // 1024) * 1024
    e_src = np.empty((ndev, es_pad), np.int32)
    e_dst = np.zeros((ndev, es_pad), np.int32)
    e_val = np.zeros((ndev, es_pad), val.dtype)
    for dvc in range(ndev):
        lo, hi = int(bounds[dvc]), int(bounds[dvc + 1])
        e_src[dvc] = (dvc + 1) * rs - 1
        e_src[dvc, : hi - lo] = src[lo:hi]
        e_dst[dvc, : hi - lo] = dst[lo:hi]
        e_val[dvc, : hi - lo] = val[lo:hi]
    return e_src, e_dst, e_val
