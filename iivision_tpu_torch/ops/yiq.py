"""The NTSC composite (YIQ) colour model's window codes in torch
(counterpart of iivision_tpu/ops/yiq.py `lane_windows`).

The decode, calibration and per-position cost matrices (`lane_subs`,
`pair_lut`) are numpy in the JAX package and shared from it.  Only the
array transform that the encoder runs per chunk is written here: the JAX
form picks its array module with `screen._xp`, which returns numpy for a
torch tensor.
"""

import torch

from iivision_tpu.ops.yiq import n_pixels
from iivision_tpu.screen import spec_for_mode
from iivision_tpu.video_mode import VideoMode


def lane_windows(vals: torch.Tensor, mode: VideoMode,
                 lane: int) -> torch.Tensor:
    """(...) masked lane values -> (..., L) int32 7-bit centred window
    codes; window j covers dots [j, j+6] of the lane's dot sequence."""
    dots = spec_for_mode(mode).to_dots(vals.to(torch.int32), lane)
    return torch.stack([(dots >> j) & 0x7F for j in range(n_pixels(mode))],
                       dim=-1)
