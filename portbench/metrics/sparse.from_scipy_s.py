"""Seconds of ``SparseMatrix.from_scipy`` per request (the benchmark's
span around the call; host work, nothing is uploaded there)."""

from portbench import readers


def read(run):
    return readers.span_mean(run, "from_scipy")
