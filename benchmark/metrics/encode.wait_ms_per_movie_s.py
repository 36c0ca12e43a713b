"""The whole-movie encode's wait for the card, in milliseconds per movie
second: the program's `Movie.timings["wait_s"]` (its span `encode.wait`,
the copies of the records and final screens to the host) summed over the
window's clips that took the whole-movie encoder, over their movie
seconds.  None where the program keeps no `wait_s`."""


def read(run):
    t = [x for x in run.timings if x["encoder"] == "whole" and "wait_s" in x]
    s = sum(x["movie_seconds"] for x in t)
    return 1e3 * sum(x["wait_s"] for x in t) / s if s else None
