"""The median wall time of the clips in the window, from handing a clip's
frames and audio to the program to its stream's last byte on disk (host
clock)."""

import numpy as np


def read(run):
    return float(np.median(run.clip_s)) if run.clip_s else None
