"""`realtime_x` where it is read per layer, in a traced run: movie seconds
of every stream completed in the window over the window's wall seconds
(host clock), under the profiler."""


def read(run):
    return run.movie_s / run.window_s if run.window_s > 0 else None
