"""The whole-movie encoder as an eager torch loop (counterpart of
iivision_tpu/encoder.py `_build_encode_scan` / `encode_movie`).

The JAX encoder is one XLA scan over chunk bodies and their steps; this is
the same computation written as Python loops over the same plan
(`plan_movie`, shared).  Per (frame, bank) chunk start it recomputes the
active bank's diff (through kernel A; the yiq model's window sums are a
torch gather) and refreshes the priorities; per step
it picks the k busiest pages (a stable sort: ties go to the lower page, as
`lax.top_k` orders them), extracts their rows with `index_select`, runs
the j sub-ops through kernel B and writes the rows back with
`index_copy_`.  Output is byte-identical to the JAX package for the same
seed: the nonces are `jax.random`'s bits (ops/random.py), the float32
expressions are the same, and the dtype boundaries are kept (state is
int32 between bodies, float32 within one).

What the JAX package needed only on the TPU is left out: the 2 MB cost
slab per body (kernel B reads the int16 store-cost table directly), the
carried-slab strategies, step bucketing and frame padding, AOT programs,
split fetches and the `diag` ablations.  One whole-movie encode serves
every length; the JAX package's chunked and streaming encoders exist for
TPU memory bounds and are bit-identical to its unchunked one.

DHGR and HGR, with the window, yiq and mono colour models (the model rides
in the distance provider's `sub` and store-cost table), are ported; joint
content selection is not (ROADMAP.md).
"""

from typing import Optional

import numpy as np
import torch

from iivision_tpu.encoder import (  # noqa: F401
    OP_FIELDS, MoviePlan, flatten_ops, plan_movie)
from iivision_tpu.screen import SCREEN_HOLES, spec_for_mode
from iivision_tpu.video_mode import VideoMode

from iivision_tpu_torch import screen
from iivision_tpu_torch.ops import distance, subop, yiq
from iivision_tpu_torch.ops import random as trandom

# encoder steps whose nonces are drawn in one vectorised call
NONCE_BLOCK_STEPS = 256


def n_banks(mode: VideoMode) -> int:
    """Screen banks the encoder keeps: main and aux for DHGR, main for HGR."""
    return 2 if mode == VideoMode.DHGR else 1


def bank_lanes(mode: VideoMode, bank: int):
    """(even, odd) page offsets' lane indices of a bank."""
    return spec_for_mode(mode).bank_lanes(bank == 1)


def masked_lanes(banks: torch.Tensor, mode: VideoMode) -> torch.Tensor:
    """(n_banks, 32, 256) screen bytes -> (32, 128, n_lanes) int32 lanes."""
    if mode == VideoMode.DHGR:
        return screen.dhgr_masked_lanes(banks[0], banks[1])
    return screen.hgr_masked_lanes(banks[0])


def prepare_targets(frames_main, frames_aux, mode: VideoMode, device):
    """Per-frame encoder targets from (F, 32, 256) uint8 screen banks
    (frames_aux is None for HGR).

    Returns (lanes_tgt (F, 32, 128, n_lanes) int32, bytes_tgt
    (F, 2, 32, 256) int32) on `device`; HGR stacks its one bank twice, as
    the JAX package does."""
    main = torch.as_tensor(np.asarray(frames_main), device=device)
    if mode == VideoMode.DHGR:
        aux = torch.as_tensor(np.asarray(frames_aux), device=device)
        lanes = screen.dhgr_masked_lanes(main, aux)
    else:
        aux = main
        lanes = screen.hgr_masked_lanes(main)
    bytes_tgt = torch.stack([main.to(torch.int32), aux.to(torch.int32)],
                            dim=1)
    return lanes, bytes_tgt


def diff_bank(cur_lanes, tgt_lanes, bank: int, sub,
              mode: VideoMode) -> torch.Tensor:
    """Diff of the active bank's two lanes, (32, 256) int32 in page-offset
    order (iivision_tpu/encoder.py diff_bank): both lanes in one distance
    call, 2 x 32 x 128 elementwise pairs - kernel A for the window and mono
    models, the window gather-sum for yiq (a 4-D `sub`)."""
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
        d2 = distance.dist_pixel_pairs(pa, pb, sub)
    return screen.interleave_bank_lanes(d2[0], d2[1])


def sc_row_index(tgt_lanes, bank: int, n_values: int,
                 mode: VideoMode) -> torch.Tensor:
    """(32, 256) int32: the store-cost table row each page offset reads -
    lane * R + target lane value, even offsets on the bank's first lane,
    odd offsets on its second (the rows of the JAX encoder's slab)."""
    le, lo = bank_lanes(mode, bank)
    return screen.interleave_bank_lanes(
        le * n_values + tgt_lanes[..., le],
        lo * n_values + tgt_lanes[..., lo]).to(torch.int32).contiguous()


def encode_movie(dist, lanes_tgt, bytes_tgt, plan: MoviePlan,
                 mode: VideoMode, seed: Optional[int] = 0):
    """Encode a planned movie on the targets' device.

    dist: a distance.ComputedDistance on the same device.
    seed=None disables random tie-breaks (deterministic, for testing).
    Returns (ops (S, K*J, 6) uint8, final main (32, 256) int32, final aux)
    as tensors on the device; for HGR the final aux is the main bank.
    """
    dev = lanes_tgt.device
    if dist.device != dev or bytes_tgt.device != dev:
        raise ValueError("targets on %s, distance model on %s"
                         % (dev, dist.device))
    k, j, Sc = plan.k, plan.j, plan.chunk_steps
    if not 1 <= k <= 32:
        raise ValueError("k=%d pages per step (a bank has 32)" % k)
    sf, sb = plan.step_frame, plan.step_bank
    sr, sn = plan.step_recompute, plan.step_nvalid
    S = len(sf)
    if S % Sc:
        raise ValueError("plan steps (%d) not a multiple of the chunk "
                         "length (%d)" % (S, Sc))
    C = dist.n_contents
    n_values = dist.store_cost16.shape[1]
    table = dist.store_cost16.reshape(-1, C)
    holes = torch.as_tensor((~SCREEN_HOLES).astype(np.int32), device=dev)

    zero = torch.zeros((n_banks(mode), 32, 256), dtype=torch.int32,
                       device=dev)
    banks, up, dw = zero.clone(), zero.clone(), zero.clone()
    # every record starts as the padding op (page 32, the active bank's
    # target byte at (0, 0), zero offsets); steps run overwrite theirs
    pad_dev = bytes_tgt[torch.tensor(sf, dtype=torch.int64, device=dev),
                        torch.tensor(sb, dtype=torch.int64, device=dev), 0, 0]
    pad_host = pad_dev.cpu().numpy()
    ops = torch.zeros((S, j, k, OP_FIELDS), dtype=torch.uint8, device=dev)
    ops[..., 0] = 32
    ops[..., 1] = pad_dev.to(torch.uint8)[:, None, None]

    key = None if seed is None else trandom.prng_key(seed, dev)
    nonce_p = nonce_o = None
    block0 = 0
    for b0 in range(0, S, Sc):
        frame, bank = int(sf[b0]), int(sb[b0])
        tl = lanes_tgt[frame]
        if sr[b0]:
            d = diff_bank(masked_lanes(banks, mode), tl, bank, dist.sub,
                          mode) * holes
            up[bank] = torch.where(d == 0, 0, up[bank]) + d
            dw[bank] = d
        # body state, float32: [up, dw, by, tb] rows of the active bank
        st = torch.stack([up[bank], dw[bank], banks[bank],
                          bytes_tgt[frame, bank]], dim=1).to(torch.float32)
        sc_rows = sc_row_index(tl, bank, n_values, mode)
        for s in range(b0, b0 + Sc):
            nvalid = int(sn[s])
            if nvalid == 0:
                continue  # a padded step: no state change, padding records
            if key is not None and (nonce_p is None
                                    or s >= block0 + NONCE_BLOCK_STEPS):
                block0 = s
                steps = torch.arange(s, min(s + NONCE_BLOCK_STEPS, S),
                                     dtype=torch.int64, device=dev)
                nonce_p, nonce_o = trandom.step_nonces(key, steps, k, j)
            score = st[:, 0].amax(dim=1) * 256.0
            if key is not None:
                score = score + nonce_p[s - block0] * 255.0
            pages = torch.sort(score, descending=True,
                               stable=True).indices[:k]
            rows = st.index_select(0, pages)
            subop.sub_op_chain(
                rows, sc_rows.index_select(0, pages), table,
                None if key is None else nonce_o[s - block0], pages,
                nvalid, int(pad_host[s]), ops[s])
            st.index_copy_(0, pages, rows)
        # truncate back to int32 at the body's end
        up[bank] = st[:, 0].to(torch.int32)
        dw[bank] = st[:, 1].to(torch.int32)
        banks[bank] = st[:, 2].to(torch.int32)
    # HGR's one bank is both main and aux, as the JAX encoder returns it
    return ops.reshape(S, k * j, OP_FIELDS), banks[0], banks[-1]
