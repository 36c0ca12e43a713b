"""The whole-movie encoder as an eager torch loop (counterpart of
iivision_tpu/encoder.py `_build_encode_scan` / `encode_movie`, and of its
`vmap` over a batch in iivision_tpu/parallel/mesh.py).

The JAX encoder is one XLA scan over chunk bodies and their steps; this is
the same computation written as Python loops over the same plan
(`plan_movie`, shared), for B movies in lockstep.  Per (frame, bank) chunk
start it recomputes the active bank's diff of all B movies in one call
(through kernel A; the yiq model's window sums are a torch gather) and
refreshes the priorities; per step it picks each movie's k busiest pages
(a stable sort: ties go to the lower page, as `lax.top_k` orders them),
extracts their rows with one `index_select`, runs the j sub-ops of all
B x k pages in one kernel B launch and writes the rows back with
`index_copy_`.  The solo encode is the B = 1 call.  Output is
byte-identical to the JAX package for the same seeds: the nonces are
`jax.random`'s bits (ops/random.py), the float32 expressions are the same,
and the dtype boundaries are kept (state is int32 between bodies, float32
within one).

What the JAX package needed only on the TPU is left out: the 2 MB cost
slab per body (kernel B reads the int16 store-cost table directly), the
carried-slab strategies, step bucketing and frame padding, AOT programs,
split fetches and the `diag` ablations.  One whole-movie encode serves
every length; the JAX package's chunked and streaming encoders exist for
TPU memory bounds and are bit-identical to its unchunked one.

DHGR and HGR, with the window, yiq and mono colour models (the model rides
in the distance provider's `sub` and store-cost table), and the default or
joint content rule are ported.
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

# bytes of float32 offset nonces drawn in one vectorised call: a block holds
# NONCE_BLOCK_BYTES // (B * j * k * 256 * 4) steps (the threefry
# intermediates are int64 and several times larger)
NONCE_BLOCK_BYTES = 64 << 20


def n_banks(mode: VideoMode) -> int:
    """Screen banks the encoder keeps: main and aux for DHGR, main for HGR."""
    return 2 if mode == VideoMode.DHGR else 1


def bank_lanes(mode: VideoMode, bank: int):
    """(even, odd) page offsets' lane indices of a bank."""
    return spec_for_mode(mode).bank_lanes(bank == 1)


def masked_lanes(banks: torch.Tensor, mode: VideoMode) -> torch.Tensor:
    """(..., n_banks, 32, 256) screen bytes -> (..., 32, 128, n_lanes)
    int32 lanes."""
    if mode == VideoMode.DHGR:
        return screen.dhgr_masked_lanes(banks[..., 0, :, :],
                                        banks[..., 1, :, :])
    return screen.hgr_masked_lanes(banks[..., 0, :, :])


def prepare_targets(frames_main, frames_aux, mode: VideoMode, device):
    """Per-frame encoder targets from (..., 32, 256) uint8 screen banks
    (numpy arrays or tensors; frames_aux is None for HGR).

    Returns (lanes_tgt (..., 32, 128, n_lanes) int32, bytes_tgt
    (..., 2, 32, 256) int32) on `device`; HGR stacks its one bank twice, as
    the JAX package does."""
    main = torch.as_tensor(frames_main, device=device)
    if mode == VideoMode.DHGR:
        aux = torch.as_tensor(frames_aux, device=device)
        lanes = screen.dhgr_masked_lanes(main, aux)
    else:
        aux = main
        lanes = screen.hgr_masked_lanes(main)
    bytes_tgt = torch.stack([main.to(torch.int32), aux.to(torch.int32)],
                            dim=-3)
    return lanes, bytes_tgt


def diff_bank(cur_lanes, tgt_lanes, bank: int, sub,
              mode: VideoMode) -> torch.Tensor:
    """Diff of the active bank's two lanes, (..., 32, 256) int32 in
    page-offset order (iivision_tpu/encoder.py diff_bank): both lanes of
    every movie in one distance call, (2, ..., 32, 128) elementwise pairs -
    kernel A for the window and mono models, the window gather-sum for yiq
    (a 4-D `sub`)."""
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
    """(..., 32, 256) int32: the store-cost table row each page offset
    reads - lane * R + target lane value, even offsets on the bank's first
    lane, odd offsets on its second (the rows of the JAX encoder's slab)."""
    le, lo = bank_lanes(mode, bank)
    return screen.interleave_bank_lanes(
        le * n_values + tgt_lanes[..., le],
        lo * n_values + tgt_lanes[..., lo]).to(torch.int32).contiguous()


def encode_movies(dist, lanes_tgt_b, bytes_tgt_b, plan: MoviePlan,
                  mode: VideoMode, seeds, joint: bool = False):
    """Encode B planned movies in lockstep on the targets' device.

    lanes_tgt_b: (B, F, 32, 128, n_lanes) int32; bytes_tgt_b:
    (B, F, 2, 32, 256) int32; every movie follows `plan`.
    dist: a distance.ComputedDistance on the same device.
    seeds: B ints, or None for deterministic tie-breaks (testing).
    joint: joint content selection (`--joint_content`).
    Returns (ops (B, S, K*J, 6) uint8, final main (B, 32, 256) int32, final
    aux (B, 32, 256)) as tensors on the device; for HGR the final aux is
    the main bank.
    """
    dev = lanes_tgt_b.device
    if dist.device != dev or bytes_tgt_b.device != dev:
        raise ValueError("targets on %s, distance model on %s"
                         % (dev, dist.device))
    B = lanes_tgt_b.shape[0]
    if seeds is not None and len(seeds) != B:
        raise ValueError("%d seeds for %d movies" % (len(seeds), B))
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
    chain = subop.sub_op_chain_joint if joint else subop.sub_op_chain
    holes = torch.as_tensor((~SCREEN_HOLES).astype(np.int32), device=dev)

    zero = torch.zeros((B, n_banks(mode), 32, 256), dtype=torch.int32,
                       device=dev)
    banks, up, dw = zero.clone(), zero.clone(), zero.clone()
    # every record starts as the padding op (page 32, the active bank's
    # target byte at (0, 0), zero offsets); steps run overwrite theirs
    pad = bytes_tgt_b[:, torch.tensor(sf, dtype=torch.int64, device=dev),
                      torch.tensor(sb, dtype=torch.int64, device=dev),
                      0, 0].T.contiguous()  # (S, B) int32
    ops = torch.zeros((S, B, j, k, OP_FIELDS), dtype=torch.uint8,
                      device=dev)
    ops[..., 0] = 32
    ops[..., 1] = pad.to(torch.uint8)[:, :, None, None]
    # page p of movie b is row b * 32 + p of the flattened state
    movie_base = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * 32

    keys = None if seeds is None else trandom.prng_keys(seeds, dev)
    block = max(1, NONCE_BLOCK_BYTES // (B * j * k * 256 * 4))
    nonce_p = nonce_o = None
    block0 = 0
    for b0 in range(0, S, Sc):
        frame, bank = int(sf[b0]), int(sb[b0])
        tl = lanes_tgt_b[:, frame]
        if sr[b0]:
            d = diff_bank(masked_lanes(banks, mode), tl, bank, dist.sub,
                          mode) * holes
            up[:, bank] = torch.where(d == 0, 0, up[:, bank]) + d
            dw[:, bank] = d
        # body state, float32: [up, dw, by, tb] rows of the active bank,
        # flattened to (B * 32, 4, 256)
        st = torch.stack([up[:, bank], dw[:, bank], banks[:, bank],
                          bytes_tgt_b[:, frame, bank]],
                         dim=2).to(torch.float32).reshape(B * 32, 4, 256)
        sc_rows = sc_row_index(tl, bank, n_values, mode).reshape(B * 32, 256)
        for s in range(b0, b0 + Sc):
            nvalid = int(sn[s])
            if nvalid == 0:
                continue  # a padded step: no state change, padding records
            if keys is not None and (nonce_p is None
                                     or s >= block0 + block):
                block0 = s
                steps = torch.arange(s, min(s + block, S),
                                     dtype=torch.int64, device=dev)
                nonce_p, nonce_o = trandom.step_nonces(keys, steps, k, j)
                # step-major, so each step's (B, j, k, 256) is contiguous
                nonce_o = nonce_o.transpose(0, 1).contiguous()
            score = st[:, 0].amax(dim=1).reshape(B, 32) * 256.0
            if keys is not None:
                score = score + nonce_p[:, s - block0] * 255.0
            pages = torch.sort(score, dim=1, descending=True,
                               stable=True).indices[:, :k].contiguous()
            flat = (pages + movie_base).reshape(-1)
            rows = st.index_select(0, flat).reshape(B, k, 4, 256)
            chain(rows, sc_rows.index_select(0, flat).reshape(B, k, 256),
                  table, None if keys is None else nonce_o[s - block0],
                  pages, nvalid, pad[s], ops[s])
            st.index_copy_(0, flat, rows.reshape(B * k, 4, 256))
        # truncate back to int32 at the body's end
        st = st.reshape(B, 32, 4, 256)
        up[:, bank] = st[:, :, 0].to(torch.int32)
        dw[:, bank] = st[:, :, 1].to(torch.int32)
        banks[:, bank] = st[:, :, 2].to(torch.int32)
    ops = ops.transpose(0, 1).reshape(B, S, k * j, OP_FIELDS)
    # HGR's one bank is both main and aux, as the JAX encoder returns it
    return ops, banks[:, 0], banks[:, -1]


def encode_movie(dist, lanes_tgt, bytes_tgt, plan: MoviePlan,
                 mode: VideoMode, seed: Optional[int] = 0,
                 joint: bool = False):
    """Encode one planned movie on the targets' device: the B = 1 call of
    `encode_movies`.

    seed=None disables random tie-breaks (deterministic, for testing).
    Returns (ops (S, K*J, 6) uint8, final main (32, 256) int32, final aux)
    as tensors on the device; for HGR the final aux is the main bank.
    """
    ops, main, aux = encode_movies(
        dist, lanes_tgt[None], bytes_tgt[None], plan, mode,
        None if seed is None else [seed], joint)
    return ops[0], main[0], aux[0]
