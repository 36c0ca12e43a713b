"""The encode's work as the algorithm needs it, on a card's published peaks
(the peaks and the nonce count copied from iivision_tpu_torch/roofline.py;
the terms that follow from how the code is launched are left out).

Counted from the plan's shapes, for `batch` movies:

- bytes read once: every encoded frame's target banks (one byte a screen
  byte), the (16, 16) int32 cost basis, and for each op the 256 int16
  store costs of its page's offsets under the chosen content;
- bytes written once: the op records (6 bytes an op) and the final
  screens;
- int32 operations: each chunk start's diagonal DP, an add, two compares
  and a min per masked dot at the 240 offsets of each page that are not
  holes; and the nonce draws: per step that runs, two fold-ins and 32
  page uniforms, per op a fold-in and 256 offset uniforms (a threefry
  block is 79 int32 instructions, a uniform's bits 3 more).

Not counted: the state a body carries (priorities, diffs, screens) in and
out of the chip, the recompute's reuse of the body's reads when fused,
padded steps and launches.  So the count is the same whatever splits the
plan into bodies and whether or not a chunk start shares the body's
launch.  Nothing here runs on the tensor cores, and the system runs no
model, so there is no MFU.
"""

from typing import NamedTuple

import numpy as np

PAGE = 32 * 256
OFFSETS = 240  # offsets of a page that map to screen bytes
THREEFRY_INT32_OPS = 79
UNIFORM_INT32_OPS = 3
MASKED_DOTS = {"DHGR": 10, "HGR": 18}  # pixels of a masked lane


class Peaks(NamedTuple):
    hbm_bytes_per_s: float
    fp32_ops_per_s: float  # outside the tensor cores
    int32_ops_per_s: float


# torch.cuda.get_device_name -> peaks.  NVIDIA H100 SXM5 80GB: HBM3 at
# 3.35 TB/s and 67 TFLOP/s float32 (NVIDIA H100 Tensor Core GPU data
# sheet); int32: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost clock
# (NVIDIA H100 Tensor Core GPU Architecture whitepaper).  The rates assume
# the card's full 700 W power limit.
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12, 64 * 132 * 1.98e9),
}


def peaks_of(card_name: str) -> Peaks:
    if card_name not in CARD_PEAKS:
        raise ValueError("no peaks for the card %r" % card_name)
    return CARD_PEAKS[card_name]


class Work(NamedTuple):
    bytes: float
    fp32_ops: float
    int32_ops: float


def encode_work(step_nvalid, step_recompute, n_frames: int, mode: str,
                batch: int, seeded: bool = True) -> Work:
    """The work of encoding one plan for `batch` movies: step_nvalid and
    step_recompute are the plan's per-step arrays (padded steps have
    nvalid 0), n_frames its encoded frames."""
    nv = np.asarray(step_nvalid)
    n_ops = int(nv.sum())
    steps_run = int((nv > 0).sum())
    chunks = int(np.asarray(step_recompute).sum())
    banks = 2 if mode == "DHGR" else 1
    per_movie = (n_frames * banks * PAGE + n_ops * 256 * 2 + n_ops * 6
                 + banks * PAGE)
    nbytes = batch * per_movie + 16 * 16 * 4
    dp = chunks * 32 * OFFSETS * 4 * MASKED_DOTS[mode]
    nonces = 0
    if seeded:
        blocks = steps_run * (2 + 32) + n_ops * 257
        nonces = (blocks * THREEFRY_INT32_OPS
                  + (steps_run * 32 + n_ops * 256) * UNIFORM_INT32_OPS)
    return Work(float(nbytes), 0.0, float(batch * (dp + nonces)))


def least_seconds(work: Work, peaks: Peaks) -> float:
    """The larger of the bytes over the HBM rate and the operations over
    the card's rate for their type."""
    t_bytes = work.bytes / peaks.hbm_bytes_per_s
    t_ops = (work.fp32_ops / peaks.fp32_ops_per_s
             + work.int32_ops / peaks.int32_ops_per_s)
    return max(t_bytes, t_ops)
