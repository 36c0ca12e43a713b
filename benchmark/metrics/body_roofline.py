"""The body kernel's share of its roofline: the least time the card could
take for the window's encodes (`model.roofline.encode_work`, the
algorithm's bytes and operations on the card's published peaks) over the
device time of the kernels launched inside the benchmark's `encode` span,
in percent."""

from benchmark.model import roofline, trace


def read(run):
    if run.trace is None or run.plan is None or not run.encodes:
        return None
    dev_s = trace.device_s(run.trace, "encode")
    if dev_s is None:
        return None
    p = run.plan
    work = roofline.encode_work(p["step_nvalid"], p["step_recompute"],
                                p["n_frames"], run.config["video_mode"],
                                int(run.traffic.get("batch", 1)))
    least = roofline.least_seconds(work, roofline.peaks_of(run.card))
    return 100.0 * least * run.encodes / dev_s
