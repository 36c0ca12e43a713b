"""The encoder's chunk-start recompute (counterpart of the JAX encoder's
`do_recompute`, iivision_tpu/encoder.py:539-554, and `diff_bank`
:351-398): the diff of the active bank's modelled screen against the
frame's target, zero at the screen holes, then the priority update
`up = where(d == 0, 0, up) + d` and `dw = d`, in place, for B movies.

- `chunk_start_plain`: the torch form - masked lanes of both banks,
  `lane_pixels` for the bank's two lanes, the elementwise diagonal DP
  (`distance.dist_pixel_pairs_plain`, torch ops on any device), or the yiq
  model's window sums for a 4-D `sub`, then interleave, holes, update;
- `chunk_start`: one launch of csrc/chunk_start.cu on a CUDA tensor, for
  the window and mono bases ((16, 16) `sub`) and the yiq costs
  ((n_lanes, L, 128, 128) `sub`, the kernel's yiq instantiation);
  `chunk_start_plain` on a CPU tensor.  It counts its launches in
  `chunk_start.launches` and, for yiq, `chunk_start.yiq_launches`.

State layout: banks, up, dw (B, n_banks, 32, 256) int32; lanes_tgt_b
(B, F, 32, 128, n_lanes) int32, read at `frame`.
"""

import ctypes

import numpy as np
import torch

from iivision_tpu_torch import _build, screen
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
    the holes (the kernel's test: offset & 127 >= 120)."""
    return torch.as_tensor((~screen.SCREEN_HOLES).astype(np.int32),
                           device=device)


def chunk_start_plain(banks, lanes_tgt_b, frame: int, bank: int, sub,
                      up, dw, mode: VideoMode) -> None:
    """The torch form of the chunk start, updating up and dw in place."""
    d = diff_bank(masked_lanes(banks, mode), lanes_tgt_b[:, frame], bank,
                  sub, mode) * not_holes(banks.device)
    up[:, bank] = torch.where(d == 0, 0, up[:, bank]) + d
    dw[:, bank] = d


def chunk_start(banks, lanes_tgt_b, frame: int, bank: int, sub, up, dw,
                mode: VideoMode) -> None:
    """The chunk start: one launch of the chunk-start kernel on a CUDA
    tensor (its yiq instantiation for a 4-D `sub`), `chunk_start_plain` on
    a CPU tensor."""
    nb = n_banks(mode)
    if banks.device.type == "cpu":
        chunk_start_plain(banks, lanes_tgt_b, frame, bank, sub, up, dw,
                          mode)
        return
    if banks.device.type != "cuda":
        raise ValueError("no kernel for device %s" % banks.device)
    B, F = lanes_tgt_b.shape[:2]
    n_lanes = screen.spec_for_mode(mode).N_LANES
    yiq_model = sub.dim() == 4
    want = [(banks, (B, nb, 32, 256)), (up, (B, nb, 32, 256)),
            (dw, (B, nb, 32, 256)), (lanes_tgt_b, (B, F, 32, 128, n_lanes)),
            (sub, (n_lanes, yiq.n_pixels(mode), 128, 128) if yiq_model
             else (16, 16))]
    for t, shape in want:
        if t.device != banks.device or t.dtype != torch.int32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(
                "chunk-start kernel argument: want int32 %s contiguous on "
                "%s, got %s %s on %s" % (shape, banks.device, t.dtype,
                                         tuple(t.shape), t.device))
    _build.launch(
        "iiv_chunk_start", ctypes.c_void_p(banks.data_ptr()),
        ctypes.c_void_p(lanes_tgt_b.data_ptr()), B, F, int(frame),
        ctypes.c_void_p(sub.data_ptr()), int(yiq_model),
        int(mode == VideoMode.DHGR), int(bank), ctypes.c_void_p(up.data_ptr()),
        ctypes.c_void_p(dw.data_ptr()),
        ctypes.c_void_p(_build.stream_ptr(banks.device)))
    if yiq_model:
        _build.count(chunk_start, "yiq_launches")
    else:
        _build.count(chunk_start, "launches")


chunk_start.launches = 0
chunk_start.yiq_launches = 0
