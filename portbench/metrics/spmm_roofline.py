"""Roofline share of the spmm kernel (``tiled_ell_spmm_t``,
``csrc/tiled_ell_spmm.cu``) over a window of refits, in %.

Device time: the trace's ``spmm_kernel`` events. Work: what each product
``A @ B`` needs, from the matrix and the operand's width ``w`` (probed at
the engine's product), not from the padded payload: each stored value
(float32) and its int32 column index read once, ``B`` (``p x w`` float32)
read once, the ``n x w`` float32 result written once, ``2 nnz w``
float32 operations (the products are formed in float32).
"""

import re

from portbench import readers

NAME = re.compile(r"\bspmm_kernel\b")


def work(n: int, p: int, nnz: int, value_bytes: int, index_bytes: int, w: int):
    """(operations, bytes) of one ``A @ B`` with ``B`` of width ``w``."""

    return 2 * nnz * w, nnz * (value_bytes + index_bytes) + 4 * w * (p + n)


def read(run):
    if not run.products:
        return None
    m, pk = run.matrix, run.peaks
    least = sum(readers.least_s(*work(m["n"], m["p"], m["nnz"], m["value_bytes"],
                                      m["index_bytes"], w),
                                pk["float32_flops"], pk["hbm_bytes_per_s"])
                for kind, w in run.products if kind == "mv")
    return readers.roofline_pct(run, lambda name: bool(NAME.search(name)), least)
