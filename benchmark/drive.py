"""The general traffic generator: drives the program with the mix that a
traffic file describes.  `client` in the file names the loop, the class
`Client` of `benchmark/clients/<client>.py`, which `client()` finds by that
name; every other key of the file is a parameter of it.  A new mix is a
new traffic file; a new loop is a new client file, with its limits in
`benchmark/reference/limits/<client>.json`.

A client is made as `Client(cfg, traffic, device, rng, spans)` in
set-up, and then driven as `warm()` (one round of the cell's own shapes,
counted in set-up), `window(seconds, run)` (the measured window: it counts
`attempted`, `failed`, `movie_s`, `window_s` and `encodes` into `run`, and
for solo loops each clip's wall time), `samples()` (the `ClipIn` and
`ClipOut` of the clips that the run's generator drew for the check),
`release()` (the program's state dropped, the inputs kept) and `close()`.
`plan_info` holds the plan's per-step arrays for the work count.  The
class also declares `TINY`, the traffic parameters of a run at the
tests' tiny sizes on the CPU, and `control_clips(cfg, traffic, rng,
device)`, the clips a run checks made from `rng` for the control
(`benchmark.control`), so that a new loop needs no edit to a test or to
the control.
"""

import importlib.util
import os
from typing import Optional

import numpy as np

from benchmark.gen import clips as gen

CLIENTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "clients")


def client(name: str, directory: Optional[str] = None):
    """The `Client` class of `<directory>/<name>.py` (by default
    `CLIENTS_DIR`)."""
    path = os.path.join(directory or CLIENTS_DIR, name + ".py")
    if not os.path.isfile(path):
        raise KeyError("no client %r: %s is missing" % (name, path))
    spec = importlib.util.spec_from_file_location(
        "benchmark_client_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Client


def program_mode(cfg: dict):
    """The program's (VideoMode, Palette) of a configuration."""
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    return VideoMode[cfg["video_mode"]], Palette[cfg["palette"]]


def plan_info(plan, n_frames: int) -> dict:
    return dict(step_nvalid=np.asarray(plan.step_nvalid),
                step_recompute=np.asarray(plan.step_recompute),
                n_frames=n_frames)


def waves(rng: np.random.Generator, cfg: dict, seconds: float,
          n: int) -> np.ndarray:
    """(n, samples) float32: each clip's own tone at the tick rate."""
    return gen.tones(rng, n, seconds, int(cfg["audio_bitrate"]),
                     cfg["tone_hz_range"])
