"""Host ingest (resize, quantize, pack) in milliseconds per movie second:
the program's `Movie.timings["frames_s"]` summed over the window's clips
that took the whole-movie encoder, over their movie seconds."""


def read(run):
    t = [x for x in run.timings if x["encoder"] == "whole"]
    s = sum(x["movie_seconds"] for x in t)
    return 1e3 * sum(x["frames_s"] for x in t) / s if s else None
