"""Idle device milliseconds while device ingest is the stage open on the
main thread (the benchmark's `ingest` span, which holds the one call
`mesh.ingest_movies_batch`, and so the program's `iiv.ingest`), per movie
second completed in the traced window: each idle gap labelled by the span
open at its middle (`model.trace.idle_gaps`)."""

from benchmark.model import trace


def read(run):
    if run.trace is None or not run.movie_s or not run.trace.device:
        return None
    s = dict(trace.idle_gaps(run.trace, n=None)).get("ingest")
    return None if s is None else 1e3 * s / run.movie_s
