"""Host ingest of the streaming encode, in milliseconds per movie second:
the program's `Movie.timings["frames_s"]` (the set-up of
`frames.ingest_stream_array` and each pull of it, the host quantizing
segment i + 1 while the card encodes segment i) summed over the window's
clips that took the streaming encoder, over their movie seconds.  None
where no clip took it."""


def read(run):
    t = [x for x in run.timings if x["encoder"] == "streaming"]
    s = sum(x["movie_seconds"] for x in t)
    return 1e3 * sum(x["frames_s"] for x in t) / s if s else None
