"""Seconds of the fit's host column statistics per request: the
program's ``_fit_timings['stats']`` (host numpy, ``_host_col_stats``)."""

from portbench import readers


def read(run):
    return readers.counter_mean(run, "fit_timings", "stats")
