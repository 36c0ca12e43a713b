"""Host milliseconds of the benchmark's `fetch_emit` span (the worker's
wait for a round's records from `mesh.fetch_ops_parallel_future` and for
its levels, and `emit_stream_fast` of its streams), per movie second
completed in the window."""


def read(run):
    s = run.spans_s.get("fetch_emit")
    return 1e3 * s / run.movie_s if s and run.movie_s else None
