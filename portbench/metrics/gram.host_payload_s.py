"""Seconds of the Gram engine's host payload build per request that
built one: the program's ``GramPCAEngine.build_seconds['host_payload']``."""

from portbench import readers


def read(run):
    return readers.counter_mean(run, "build_seconds", "host_payload",
                                where=lambda r: r["counters"].get("engine") == "GramPCAEngine")
