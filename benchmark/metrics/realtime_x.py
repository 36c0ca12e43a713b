"""Movie seconds of every stream completed in the window over the
window's wall seconds (host clock)."""


def read(run):
    return run.movie_s / run.window_s if run.window_s > 0 else None
