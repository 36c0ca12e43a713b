"""Device activities (kernels, copies, sets) launched inside the
benchmark's `ingest` span per movie ingested in the traced window.  The
span holds the one call `mesh.ingest_movies_batch`, and so exactly what
the program's own `iiv.ingest` span holds; the rounds queued in the window
times the batch are the movies ingested."""


def read(run):
    if run.trace is None or not run.encodes:
        return None
    n = sum(1 for *_, span in run.trace.device if span == "ingest")
    movies = run.encodes * int(run.traffic.get("batch", 1))
    return n / movies if n else None
