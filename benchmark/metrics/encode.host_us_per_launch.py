"""Host microseconds per body launch of the whole-movie encode: the
program's `Movie.timings["launch_s"]` (its span `encode.launch`, around
`encoder.encode_segment`'s loop of body launches) summed over the window's
clips that took the whole-movie encoder, over their
`timings["body_launches"]`.  None where the program keeps neither."""


def read(run):
    t = [x for x in run.timings
         if x["encoder"] == "whole" and "launch_s" in x]
    n = sum(x["body_launches"] for x in t)
    return 1e6 * sum(x["launch_s"] for x in t) / n if n else None
