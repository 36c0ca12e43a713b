"""The encoder's chunk-start recompute (counterpart of the JAX encoder's
`do_recompute`, iivision_tpu/encoder.py:540-548, and `diff_bank`
:351-398): the diff of the active bank's modelled screen against the
frame's target, zero at the screen holes, then the priority update
`up = where(d == 0, 0, up) + d` and `dw = d`, in place, for B movies.

`chunk_start_plain` is its torch form - masked lanes of both banks,
`lane_pixels` for the bank's two lanes, the elementwise diagonal DP
(`distance.dist_pixel_pairs_plain`, torch ops on any device), or the yiq
model's window sums for a 4-D `sub`, then interleave, holes, update.  On
a card the recompute runs as the prologue of the body kernel's launch
(`body.encode_body(..., sub=...)`, csrc/body.cu); `body.encode_body_plain`
runs `chunk_start_plain` first, and the kernel is held to it.

State layout: banks, up, dw (B, n_banks, 32, 256) int32; lanes_tgt_b
(B, F, 32, 128, n_lanes) int32, read at `frame`.
"""

import numpy as np
import torch

from iivision_tpu_torch import screen
from iivision_tpu_torch.ops import distance, yiq
from iivision_tpu_torch.video_mode import VideoMode, require_mode


def n_banks(mode: VideoMode) -> int:
    """Screen banks the encoder keeps: main and aux for DHGR, main for
    HGR."""
    return 2 if require_mode(mode) == VideoMode.DHGR else 1


def bank_lanes(mode: VideoMode, bank: int):
    """(even, odd) page offsets' lane indices of a bank."""
    return screen.spec_for_mode(mode).bank_lanes(bank == 1)


def masked_lanes(banks: torch.Tensor, mode: VideoMode) -> torch.Tensor:
    """(..., n_banks, 32, 256) screen bytes -> (..., 32, 128, n_lanes)
    int32 lanes."""
    if require_mode(mode) == VideoMode.DHGR:
        return screen.dhgr_masked_lanes(banks[..., 0, :, :],
                                        banks[..., 1, :, :])
    return screen.hgr_masked_lanes(banks[..., 0, :, :])


def diff_bank(cur_lanes, tgt_lanes, bank: int, sub,
              mode: VideoMode) -> torch.Tensor:
    """Diff of the active bank's two lanes, (..., 32, 256) int32 in
    page-offset order: both lanes of every movie in one distance call -
    the plain elementwise diagonal DP for the window and mono models, the
    window gather-sum for yiq (a 4-D `sub`)."""
    lanes = bank_lanes(mode, bank)
    if sub.dim() == 4:
        wa = torch.stack([yiq.lane_windows(cur_lanes[..., l], mode, l)
                          for l in lanes])
        wb = torch.stack([yiq.lane_windows(tgt_lanes[..., l], mode, l)
                          for l in lanes])
        d2 = distance.dist_window_sums_sub2(wa, wb, sub[list(lanes)])
    else:
        pa = torch.stack([distance.lane_pixels(cur_lanes[..., l], mode, l)
                          for l in lanes])
        pb = torch.stack([distance.lane_pixels(tgt_lanes[..., l], mode, l)
                          for l in lanes])
        d2 = distance.dist_pixel_pairs_plain(pa, pb, sub)
    return screen.interleave_bank_lanes(d2[0], d2[1])


def not_holes(device) -> torch.Tensor:
    """(32, 256) int32: 1 where a page offset maps to a screen byte, 0 at
    the holes (the body kernel's test: offset & 127 >= 120)."""
    return torch.as_tensor((~screen.SCREEN_HOLES).astype(np.int32),
                           device=device)


def chunk_start_plain(banks, lanes_tgt_b, frame: int, bank: int, sub,
                      up, dw, mode: VideoMode) -> None:
    """The torch form of the chunk start, updating up and dw in place."""
    d = diff_bank(masked_lanes(banks, mode), lanes_tgt_b[:, frame], bank,
                  sub, mode) * not_holes(banks.device)
    up[:, bank] = torch.where(d == 0, 0, up[:, bank]) + d
    dw[:, bank] = d
