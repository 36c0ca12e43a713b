"""The share of the traced window in which no operation ran on the
device, in percent: 100 x (1 - union of device activity / window)."""

from benchmark.model import trace


def read(run):
    return trace.idle_pct(run.trace)
