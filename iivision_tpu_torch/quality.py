"""Output-quality metrics on a torch device (counterpart of
iivision_tpu/quality.py `score_screens` / `replay_frame_errors`).

`replay_frame_errors` replays an emitted opcode stream against the frame
schedule, as the player executes it (`replay_ops`, numpy, copied from the
JAX module), and scores the screen at each encoded-frame boundary with the
encoder's own perceptual lane distance: `distance.dist_lane_pairs`, which
is kernel A's lane-distance entry on a card (window and mono models) or
the yiq window sums.  It is the fidelity number that compares encoder
settings (k, j, joint content) on equal footing.  `stream_psnr` renders a
screen (`render`, numpy) and gives its PSNR against a source frame.
"""

from dataclasses import dataclass

import numpy as np
import torch

from iivision_tpu_torch.ops import distance
from iivision_tpu_torch.ops.chunk_start import masked_lanes
from iivision_tpu_torch.screen import spec_for_mode
from iivision_tpu_torch.video_mode import VideoMode

SCORE_CHUNK = 16  # frames per scoring call (bounds the transients)


@dataclass
class QualityReport:
    frame_errors: np.ndarray  # (F,) mean lane distance at frame end
    final_error: float
    mean_error: float


def replay_ops(flat_ops: np.ndarray, op_bank: np.ndarray,
               boundaries: np.ndarray) -> np.ndarray:
    """Replay opcode stores, snapshotting memory at each boundary.

    flat_ops: (n, 6) [page, content, o0..o3]; op_bank: (n,) 0/1;
    boundaries: sorted op indices (inclusive) at which to snapshot.
    Returns (len(boundaries), 2, 32, 256) uint8 screen states.  Within a
    segment the last write of a cell wins (numpy fancy assignment applies
    duplicate indices in order); padding ops are applied, as the player
    applies them."""
    mem = np.zeros(2 * 32 * 256, np.uint8)
    states = np.empty((len(boundaries), 2, 32, 256), np.uint8)
    pos = 0
    for i, b in enumerate(boundaries):
        seg = flat_ops[pos:b + 1]
        bk = op_bank[pos:b + 1].astype(np.int64)
        cell = (bk * 32 + (seg[:, 0].astype(np.int64) - 32)) * 256
        idx = (cell[:, None] + seg[:, 2:6].astype(np.int64)).ravel()
        mem[idx] = np.repeat(seg[:, 1].astype(np.uint8), 4)
        states[i] = mem.reshape(2, 32, 256)
        pos = b + 1
    return states


def score_screens(states, tgt_lanes, mode: VideoMode,
                  sub: torch.Tensor) -> np.ndarray:
    """Mean perceptual lane distance for a batch of screens, on `sub`'s
    device.

    states: (F, 2, 32, 256) screen bytes (bank 1 ignored for HGR);
    tgt_lanes: (F, 32, 128, L) target masked lanes (array or tensor).
    Returns (F,) float32.  Scores SCORE_CHUNK frames per call."""
    dev = sub.device
    n_lanes = int(spec_for_mode(mode).N_LANES)
    F = states.shape[0]
    out = np.empty(F, np.float32)
    for i in range(0, F, SCORE_CHUNK):
        st = torch.as_tensor(np.asarray(states[i:i + SCORE_CHUNK]),
                             device=dev)
        tl = torch.as_tensor(tgt_lanes[i:i + SCORE_CHUNK], device=dev)
        cur = masked_lanes(st, mode)
        total = torch.zeros(st.shape[0], dtype=torch.float32, device=dev)
        for lane in range(n_lanes):
            d = distance.dist_lane_pairs(cur[..., lane], tl[..., lane],
                                         mode, lane, sub)
            total = total + d.sum(dim=(-2, -1)).to(torch.float32)
        out[i:i + SCORE_CHUNK] = (
            total / (32.0 * 128.0 * n_lanes)).cpu().numpy()
    return out


def replay_frame_errors(flat_ops: np.ndarray, plan, lanes_tgt,
                        mode: VideoMode, dist) -> QualityReport:
    """Replay the opcode stream and score each encoded frame's endpoint.

    lanes_tgt: (F, 32, 128, L) target lanes, an array or a tensor; dist:
    a distance.ComputedDistance, whose device scores."""
    op_bank = np.repeat(plan.step_bank, plan.step_nvalid)
    op_frame = np.repeat(plan.step_frame, plan.step_nvalid)
    n = len(flat_ops)
    if len(op_bank) != n:
        raise ValueError("%d ops for a plan of %d" % (n, len(op_bank)))

    boundaries = np.append(np.flatnonzero(np.diff(op_frame)), n - 1)
    states = replay_ops(flat_ops, op_bank, boundaries)
    frames_idx = op_frame[boundaries]
    if isinstance(lanes_tgt, torch.Tensor):
        tl = lanes_tgt[torch.as_tensor(frames_idx, device=lanes_tgt.device)]
    else:
        tl = np.asarray(lanes_tgt)[frames_idx]
    errors = score_screens(states, tl, mode, dist.sub)
    return QualityReport(frame_errors=errors,
                         final_error=float(errors[-1]),
                         mean_error=float(errors.mean()))


def stream_psnr(main, aux, source_rgb, mode: VideoMode, palette) -> float:
    """PSNR of a rendered screen against the source frame (both 140x192)."""
    from iivision_tpu_torch import render

    return render.psnr(render.screen_to_rgb(main, aux, mode, palette),
                       source_rgb)
