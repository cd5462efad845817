"""Roofline share of the densified engine's bf16 GEMMs (cuBLAS calls of
``_bf16_dot`` under ``DensifiedOperator._mv`` / ``_rmv``) over a window
of refits, in %.

Device time: the trace's bf16 GEMM kernels (:func:`is_dense_gemm`), not
the solver's float32 GEMMs. Work: what each pass needs, from the matrix
and the operand's width ``w`` (probed at the engine's product), never
from the padded form: the ``n x p`` bf16 values read once, the bf16
operand read once (``p x w`` for ``A @ B``, ``n x w`` for ``A^T @ C``),
the float32 result written once, ``2 n p w`` operations. The least time
of a pass is the larger of its operations at the bf16 dense tensor-core
peak and its bytes at the memory rate.
"""

import re

from portbench import readers

#: H100 SXM, dense bf16 tensor-core rate at 700 W (data sheet)
BF16_FLOPS = 989.4e12

_BF16_GEMM = re.compile(r"gemm\w*bf16|bf16\w*gemm|^nvjet_t", re.IGNORECASE)


def is_dense_gemm(name: str) -> bool:
    """A bf16-input GEMM kernel of cuBLAS, as the card's trace names it."""

    return bool(_BF16_GEMM.search(name))


def work(n: int, p: int, kind: str, w: int):
    """(operations, bytes) of one pass with an operand of width ``w``:
    ``A @ B`` (``kind`` "mv") or ``A^T @ C`` ("rmv")."""

    operand, result = (p, n) if kind == "mv" else (n, p)
    return 2 * n * p * w, 2 * n * p + 2 * operand * w + 4 * result * w


def read(run):
    if not run.products:
        return None
    m, pk = run.matrix, run.peaks
    least = sum(readers.least_s(*work(m["n"], m["p"], kind, w), BF16_FLOPS,
                                pk["hbm_bytes_per_s"])
                for kind, w in run.products)
    return readers.roofline_pct(run, is_dense_gemm, least)
