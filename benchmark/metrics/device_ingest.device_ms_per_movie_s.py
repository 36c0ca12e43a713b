"""Device milliseconds of the kernels launched inside the benchmark's
`ingest` span (`parallel.mesh.ingest_movies_batch`), per movie second
completed in the traced window."""

from benchmark.model import trace


def read(run):
    if run.trace is None or not run.movie_s:
        return None
    s = trace.device_s(run.trace, "ingest")
    return None if s is None else 1e3 * s / run.movie_s
