"""The streaming encode (`encoder.encode_movie_streaming`: segments of
targets up, their launch loops, the records back) in milliseconds per
movie second, net of the pulls that host ingest counts: the program's
`Movie.timings["encode_s"]` summed over the window's clips that took the
streaming encoder, over their movie seconds.  None where no clip took
it."""


def read(run):
    t = [x for x in run.timings if x["encoder"] == "streaming"]
    s = sum(x["movie_seconds"] for x in t)
    return 1e3 * sum(x["encode_s"] for x in t) / s if s else None
