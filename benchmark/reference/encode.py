"""The encoder, plain: B movies in lockstep over one plan, one torch op at
a time (frozen from iivision_tpu_torch's `encoder.encode_segment`,
`ops/chunk_start.chunk_start_plain`, `ops/body.encode_body_plain` and
`ops/subop.sub_op_chain_plain`, default content rule).

Per chunk body: at a chunk start, the diff of the active bank against the
frame's target (diagonal DP per page offset, zero at the screen holes)
and the priority update; then per step the k busiest pages of each movie
(stable top-k after the page nonces) and j sequential sub-ops on each,
with the offset nonces.  State is int32 between bodies and float32 within
one.  control=True keeps the scores that pick pages and offsets in
bfloat16 (the control of `check.py`).
"""

import numpy as np
import torch

from benchmark.reference import screen, threefry
from benchmark.reference.plan import OP_FIELDS, MoviePlan
from benchmark.reference.distance import dist_pixel_pairs, lane_pixels
from benchmark.reference.video_mode import VideoMode


def n_banks(mode: VideoMode) -> int:
    return 2 if mode == VideoMode.DHGR else 1


def target_lanes(main: torch.Tensor, aux, mode: VideoMode):
    """(..., 32, 256) target banks -> (lanes (..., 32, 128, n_lanes) int32,
    bytes (..., 2, 32, 256) int32); HGR stacks its one bank twice."""
    if mode == VideoMode.DHGR:
        lanes = screen.dhgr_masked_lanes(main, aux)
    else:
        aux = main
        lanes = screen.hgr_masked_lanes(main)
    return lanes, torch.stack([main.to(torch.int32), aux.to(torch.int32)],
                              dim=-3)


def _masked_lanes(banks: torch.Tensor, mode: VideoMode) -> torch.Tensor:
    if mode == VideoMode.DHGR:
        return screen.dhgr_masked_lanes(banks[:, 0], banks[:, 1])
    return screen.hgr_masked_lanes(banks[:, 0])


def _bank_lanes(mode: VideoMode, bank: int):
    return screen.spec_for_mode(mode).bank_lanes(bank == 1)


def chunk_start(banks, tgt_lanes, bank: int, sub, up, dw,
                mode: VideoMode) -> None:
    """The chunk start's diff and priority update, in place."""
    cur = _masked_lanes(banks, mode)
    lanes = _bank_lanes(mode, bank)
    pa = torch.stack([lane_pixels(cur[..., ln], mode, ln) for ln in lanes])
    pb = torch.stack([lane_pixels(tgt_lanes[..., ln], mode, ln)
                      for ln in lanes])
    d2 = dist_pixel_pairs(pa, pb, sub)
    holes = torch.as_tensor((~screen.SCREEN_HOLES).astype(np.int32),
                            device=banks.device)
    d = screen.interleave_bank_lanes(d2[0], d2[1]) * holes
    up[:, bank] = torch.where(d == 0, 0, up[:, bank]) + d
    dw[:, bank] = d


def _low(x: torch.Tensor, control: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if control else x


def sub_op_chain(rows, sc_rows, table, nonce, pages, nvalid: int,
                 pad_content, out, control: bool) -> None:
    """j sequential sub-ops on each of the B x k selected pages' rows
    [up, dw, by, tb] (B, k, 4, 256) float32, in place; writes the (B, j, k,
    6) uint8 records."""
    k = rows.shape[1]
    j = out.shape[1]
    C = table.shape[1]
    dev = rows.device
    iota = torch.arange(256, device=dev)
    slot = torch.arange(k, device=dev)
    flat = table.view(-1)
    base = sc_rows.to(torch.int64) * C
    up, dw, by, tb = (rows[:, :, i].clone() for i in range(4))
    for jj in range(j):
        has_work = up.amax(dim=-1) > 0.0
        real = has_work & (jj * k + slot < nvalid)
        off_score = up * 256.0
        if nonce is not None:
            off_score = off_score + nonce[:, jj] * 255.0
        off0 = torch.argmax(_low(off_score, control), dim=-1)
        not_prim = iota != off0[..., None]
        content = tb.gather(-1, off0[..., None])[..., 0].to(torch.int64)
        sc = flat[base + (content & (C - 1))[..., None]].to(torch.float32)
        score = dw - sc
        sl = torch.where((up > 0.0) & (score > 0.0) & not_prim, score, -1.0)
        offs = []
        comp = torch.zeros_like(up, dtype=torch.bool)
        for _ in range(3):  # best three, ties to the lowest offset
            o = torch.argmax(sl, dim=-1)
            hit = sl.gather(-1, o[..., None])[..., 0] > 0.0
            offs.append(torch.where(hit, o, off0))
            oh = iota == o[..., None]
            comp |= oh & hit[..., None]
            sl = torch.where(oh, -1.0, sl)
        prim = ~not_prim & real[..., None]
        comp &= real[..., None]
        cf = content.to(torch.float32)[..., None]
        up = torch.where(prim, 0.0, torch.where(comp, sc, up))
        dw = torch.where(prim, 0.0, dw)
        by = torch.where(prim | comp, cf, by)
        rec = torch.stack(
            [torch.where(real, pages, 0) + 32,
             torch.where(real, content, pad_content.to(torch.int64)[:, None]),
             *(torch.where(real, x, 0) for x in [off0] + offs)], dim=-1)
        out[:, jj] = rec.to(torch.uint8)
    rows[:, :, 0] = up
    rows[:, :, 1] = dw
    rows[:, :, 2] = by


def _sc_row_index(tgt_lanes, bank: int, n_values: int, mode: VideoMode):
    le, lo = _bank_lanes(mode, bank)
    return screen.interleave_bank_lanes(
        le * n_values + tgt_lanes[..., le],
        lo * n_values + tgt_lanes[..., lo]).to(torch.int32).contiguous()


def body(up, dw, banks, lanes_b, bytes_b, frame: int, bank: int, table,
         keys, nvalid, s0: int, Sc: int, ops, mode: VideoMode,
         control: bool) -> None:
    """Steps s0 .. s0 + Sc - 1 of one chunk body, in place."""
    dev = up.device
    B = up.shape[0]
    j, k = ops.shape[2], ops.shape[3]
    n_values = table.shape[0] // screen.spec_for_mode(mode).N_LANES
    tl = lanes_b[:, frame]
    pad = bytes_b[:, frame, bank, 0, 0].contiguous()
    nv = [int(x) for x in nvalid[s0:s0 + Sc]]
    nonce_p = nonce_o = None
    if keys is not None:
        steps = torch.arange(s0, s0 + Sc, dtype=torch.int64, device=dev)
        nonce_p, nonce_o = threefry.step_nonces(keys, steps, k, j)
        nonce_o = nonce_o.transpose(0, 1).contiguous()
    st = torch.stack([up[:, bank], dw[:, bank], banks[:, bank],
                      bytes_b[:, frame, bank]],
                     dim=2).to(torch.float32).reshape(B * 32, 4, 256)
    sc_rows = _sc_row_index(tl, bank, n_values, mode).reshape(B * 32, 256)
    movie_base = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * 32
    for i, s in enumerate(range(s0, s0 + Sc)):
        if nv[i] == 0:
            continue
        score = st[:, 0].amax(dim=1).reshape(B, 32) * 256.0
        if keys is not None:
            score = score + nonce_p[:, i] * 255.0
        pages = torch.sort(_low(score, control), dim=1, descending=True,
                           stable=True).indices[:, :k].contiguous()
        flat = (pages + movie_base).reshape(-1)
        rows = st.index_select(0, flat).reshape(B, k, 4, 256)
        sub_op_chain(rows, sc_rows.index_select(0, flat).reshape(B, k, 256),
                     table, None if keys is None else nonce_o[i], pages,
                     nv[i], pad, ops[s], control)
        st.index_copy_(0, flat, rows.reshape(B * k, 4, 256))
    st = st.reshape(B, 32, 4, 256)
    up[:, bank] = st[:, :, 0].to(torch.int32)
    dw[:, bank] = st[:, :, 1].to(torch.int32)
    banks[:, bank] = st[:, :, 2].to(torch.int32)


def encode_movies(dist, lanes_b, bytes_b, plan: MoviePlan, mode: VideoMode,
                  seeds, control: bool = False):
    """Encode B movies in lockstep: lanes_b (B, F, 32, 128, n_lanes) and
    bytes_b (B, F, 2, 32, 256) int32 on `dist`'s device; seeds: B ints.
    Returns (ops (B, S, k*j, 6) uint8, final main (B, 32, 256) int32,
    final aux)."""
    dev = lanes_b.device
    B = lanes_b.shape[0]
    k, j, Sc = plan.k, plan.j, plan.chunk_steps
    S = len(plan.step_frame)
    zero = torch.zeros((B, n_banks(mode), 32, 256), dtype=torch.int32,
                       device=dev)
    banks, up, dw = zero.clone(), zero.clone(), zero
    keys = threefry.prng_keys(seeds, dev)
    ops = torch.zeros((S, B, j, k, OP_FIELDS), dtype=torch.uint8, device=dev)
    sf, sb = plan.step_frame, plan.step_bank
    # every record starts as the padding op: page 32, the active bank's
    # target byte at (0, 0), zero offsets
    ops[..., 0] = 32
    pad = bytes_b[:, torch.as_tensor(np.array(sf), device=dev).long(),
                  torch.as_tensor(np.array(sb), device=dev).long(), 0, 0].T
    ops[..., 1] = pad.to(torch.uint8)[:, :, None, None]
    table = dist.store_cost16.reshape(-1, dist.n_contents)
    for b0 in range(0, S, Sc):
        frame, bank = int(sf[b0]), int(sb[b0])
        if plan.step_recompute[b0]:
            chunk_start(banks, lanes_b[:, frame], bank, dist.sub, up, dw,
                        mode)
        body(up, dw, banks, lanes_b, bytes_b, frame, bank, table, keys,
             plan.step_nvalid, b0, Sc, ops, mode, control)
    ops = ops.transpose(0, 1).reshape(B, S, k * j, OP_FIELDS)
    return ops, banks[:, 0], banks[:, -1]
