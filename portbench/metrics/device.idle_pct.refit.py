"""Share of the traced window in which the card ran no kernel, copy or
memset, in %: the union of the profiler's device intervals against the
window's length."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
