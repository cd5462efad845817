"""Roofline share of the densify kernel (``tiled_ell_densify_t``,
``csrc/tiled_ell_densify.cu``) over a window of fresh fits, in %.

Device time: the trace's ``densify_tile_kernel`` events. Work: what the
inputs need, from the matrix, not from the payload the engine built. A
pass densifies the whole matrix once into its output type: each stored
value (the matrix's float32) and its int32 column index read once, each
of the ``n x p`` outputs written once. It adds, and multiplies nothing,
so its least time is its bytes at the memory rate. Passes per output
type: the program's launch counter over the slabs of a pass.
"""

from portbench import readers

OUT_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}


def pass_bytes(n: int, p: int, nnz: int, value_bytes: int, index_bytes: int, out: str) -> int:
    return nnz * (value_bytes + index_bytes) + n * p * OUT_BYTES[out]


def read(run):
    m = run.matrix
    least = 0.0
    for rec in run.records:
        for out, passes in rec["counters"].get("densify_passes", {}).items():
            nbytes = pass_bytes(m["n"], m["p"], m["nnz"], m["value_bytes"], m["index_bytes"], out)
            least += passes * readers.least_s(0, nbytes, 1, run.peaks["hbm_bytes_per_s"])
    return readers.roofline_pct(run, lambda name: "densify_tile_kernel" in name, least)
