"""Seconds from the start of the run's process to the start of its window:
imports, the kernels' build or load, the distance model, the clip pool
and the warm-up (host clock)."""


def read(run):
    return run.setup_s
