"""Roofline share of the rmv kernels (``tiled_ell_rmv_t``: its partial
and reduce kernels, ``csrc/tiled_ell_spmm.cu``) over a window of refits,
in %.

Device time: the trace's ``rmv_partial_kernel`` and ``rmv_reduce_kernel``
events. Work: what each product ``A^T @ C`` needs, from the matrix and
the operand's width ``w`` (probed at the engine's product): each stored
value (float32) and its int32 column index read once, ``C`` (``n x w``
float32) read once, the ``p x w`` float32 result written once, ``2 nnz
w`` float32 operations.
"""

import re

from portbench import readers

NAME = re.compile(r"\brmv_(partial|reduce)_kernel\b")


def work(n: int, p: int, nnz: int, value_bytes: int, index_bytes: int, w: int):
    """(operations, bytes) of one ``A^T @ C`` with ``C`` of width ``w``."""

    return 2 * nnz * w, nnz * (value_bytes + index_bytes) + 4 * w * (n + p)


def read(run):
    if not run.products:
        return None
    m, pk = run.matrix, run.peaks
    least = sum(readers.least_s(*work(m["n"], m["p"], m["nnz"], m["value_bytes"],
                                      m["index_bytes"], w),
                                pk["float32_flops"], pk["hbm_bytes_per_s"])
                for kind, w in run.products if kind == "rmv")
    return readers.roofline_pct(run, lambda name: bool(NAME.search(name)), least)
