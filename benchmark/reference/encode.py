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

On a card, `BodyGraphs` replays each chunk body as a CUDA graph of the
same ops (one Python-dispatched launch a body, not some thousands); the
eager loop is the definition, and the one the CPU runs.
"""

import functools
from types import SimpleNamespace

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


@functools.lru_cache(None)
def _holes(device) -> torch.Tensor:
    """(32, 256) int32: 0 at the screen holes, 1 elsewhere."""
    return torch.as_tensor((~screen.SCREEN_HOLES).astype(np.int32),
                           device=device)


def chunk_start(banks, tgt_lanes, bank: int, sub, up, dw,
                mode: VideoMode) -> None:
    """The chunk start's diff and priority update, in place."""
    cur = _masked_lanes(banks, mode)
    lanes = _bank_lanes(mode, bank)
    pa = torch.stack([lane_pixels(cur[..., ln], mode, ln) for ln in lanes])
    pb = torch.stack([lane_pixels(tgt_lanes[..., ln], mode, ln)
                      for ln in lanes])
    d2 = dist_pixel_pairs(pa, pb, sub)
    d = screen.interleave_bank_lanes(d2[0], d2[1]) * _holes(banks.device)
    up[:, bank] = torch.where(d == 0, 0, up[:, bank]) + d
    dw[:, bank] = d


def _low(x: torch.Tensor, control: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if control else x


def sub_op_chain(rows, sc_rows, table, nonce, pages, nvalid: int,
                 pad_content, out, control: bool) -> None:
    """j sequential sub-ops on each of the B x k selected pages' rows
    [up, dw, by, tb] (B, k, 4, 256) float32, in place; writes the (B, j, k,
    6) uint8 records.  `nvalid`, the step's real ops, is an int or a 0-d
    int64 tensor on the rows' device."""
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


def body(up, dw, banks, tl, fb, bank: int, table, keys, steps, nvalid,
         live, out, mode: VideoMode, control: bool) -> None:
    """The steps of one chunk body, in place.  tl (B, 32, 128, n_lanes)
    and fb (B, 2, 32, 256): the target lanes and bytes of the body's
    frame; steps (Sc,) int64: its absolute step indices; nvalid[i]: step
    i's real ops (an int, or a 0-d tensor); live[i]: whether step i has
    any (an empty step is skipped); out (Sc, B, j, k, 6): its records."""
    dev = up.device
    B = up.shape[0]
    j, k = out.shape[2], out.shape[3]
    n_values = table.shape[0] // screen.spec_for_mode(mode).N_LANES
    pad = fb[:, bank, 0, 0].contiguous()
    nonce_p = nonce_o = None
    if keys is not None:
        nonce_p, nonce_o = threefry.step_nonces(keys, steps, k, j)
        nonce_o = nonce_o.transpose(0, 1).contiguous()
    st = torch.stack([up[:, bank], dw[:, bank], banks[:, bank], fb[:, bank]],
                     dim=2).to(torch.float32).reshape(B * 32, 4, 256)
    sc_rows = _sc_row_index(tl, bank, n_values, mode).reshape(B * 32, 256)
    movie_base = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * 32
    for i in range(len(live)):
        if not live[i]:
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
                     nvalid[i], pad, out[i], control)
        st.index_copy_(0, flat, rows.reshape(B * k, 4, 256))
    st = st.reshape(B, 32, 4, 256)
    up[:, bank] = st[:, :, 0].to(torch.int32)
    dw[:, bank] = st[:, :, 1].to(torch.int32)
    banks[:, bank] = st[:, :, 2].to(torch.int32)


def chunk_body(up, dw, banks, tl, fb, bank: int, recompute: bool, sub,
               table, keys, steps, nvalid, live, out, mode: VideoMode,
               control: bool) -> None:
    """One chunk body, in place: the chunk start where the plan
    recomputes, then the body's steps (`body`)."""
    if recompute:
        chunk_start(banks, tl, bank, sub, up, dw, mode)
    body(up, dw, banks, tl, fb, bank, table, keys, steps, nvalid, live, out,
         mode, control)


def _bodies(plan: MoviePlan):
    """Each chunk body's (first step, frame, bank, recompute, real ops of
    each step, whether each step has any): plan data, on the host."""
    Sc = plan.chunk_steps
    for b0 in range(0, len(plan.step_frame), Sc):
        nv = [int(x) for x in plan.step_nvalid[b0:b0 + Sc]]
        yield (b0, int(plan.step_frame[b0]), int(plan.step_bank[b0]),
               bool(plan.step_recompute[b0]), nv, tuple(n != 0 for n in nv))


class BodyGraphs:
    """`encode_movies`' chunk bodies as CUDA graphs, on a card.  Each
    (shapes, bank, recompute, live steps, control) is captured the first
    time it comes up, from the same `chunk_body` on static buffers (that body
    itself runs eagerly on them), and replayed after; `nvalid` reaches the
    graph as device tensors, and the plan's empty steps stay out of it, as
    in the eager loop.  A body's live steps are a prefix of it (the plan
    pads chunk tails with empty steps), so one copy takes out its
    records.  One object serves one distance model and any plan: a graph
    reads the plan's steps, `nvalid` and frame from its buffers; its
    graphs and buffers go with it."""

    def __init__(self):
        self._graphs = {}
        self._bufs = {}
        self._pool = None

    def _buffers(self, key, lanes_b, bytes_b, nb: int, Sc: int, j: int,
                 k: int):
        if key not in self._bufs:
            B, dev = lanes_b.shape[0], lanes_b.device

            def zeros(*shape, dtype=torch.int32):
                return torch.zeros(shape, dtype=dtype, device=dev)

            self._bufs[key] = SimpleNamespace(
                up=zeros(B, nb, 32, 256), dw=zeros(B, nb, 32, 256),
                banks=zeros(B, nb, 32, 256),
                tl=torch.zeros_like(lanes_b[:, 0]),
                fb=torch.zeros_like(bytes_b[:, 0]),
                k1=zeros(B, dtype=torch.int64), k2=zeros(B, dtype=torch.int64),
                steps=zeros(Sc, dtype=torch.int64),
                nvalid=zeros(Sc, dtype=torch.int64),
                out=zeros(Sc, B, j, k, OP_FIELDS, dtype=torch.uint8))
        return self._bufs[key]

    def _run(self, key, fn) -> None:
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            fn()
        self._pool = self._pool or graph.pool()
        self._graphs[key] = graph

    def encode(self, sub, table, lanes_b, bytes_b, plan: MoviePlan, keys,
               ops, mode: VideoMode, control: bool) -> torch.Tensor:
        """The eager loop of `encode_movies` on this object's buffers, the
        records written into `ops` (S, B, j, k, 6); returns the final
        banks (B, n_banks, 32, 256)."""
        dev = lanes_b.device
        Sc = plan.chunk_steps
        # (B, lanes, banks, steps a body, j, k): what the buffers and so
        # the graphs are shaped by
        shapes = (lanes_b.shape[0], lanes_b.shape[-1], n_banks(mode), Sc,
                  plan.j, plan.k)
        b = self._buffers(shapes, lanes_b, bytes_b, *shapes[2:])
        for x in (b.up, b.dw, b.banks):
            x.zero_()
        b.k1.copy_(keys[0])
        b.k2.copy_(keys[1])
        steps = torch.arange(len(plan.step_frame), dtype=torch.int64,
                             device=dev)
        nvalid = torch.as_tensor(np.array(plan.step_nvalid),
                                 dtype=torch.int64, device=dev)
        for b0, frame, bank, recompute, _, live in _bodies(plan):
            n = sum(live)
            if live[:n] != (True,) * n:
                raise ValueError("an empty step before a live one at step "
                                 "%d" % b0)
            b.tl.copy_(lanes_b[:, frame])
            b.fb.copy_(bytes_b[:, frame])
            b.steps.copy_(steps[b0:b0 + Sc])
            b.nvalid.copy_(nvalid[b0:b0 + Sc])
            self._run(shapes + (bank, recompute, live, control),
                      lambda: chunk_body(
                          b.up, b.dw, b.banks, b.tl, b.fb, bank, recompute,
                          sub, table, (b.k1, b.k2), b.steps, b.nvalid, live,
                          b.out, mode, control))
            ops[b0:b0 + n].copy_(b.out[:n])
        return b.banks.clone()


def encode_movies(dist, lanes_b, bytes_b, plan: MoviePlan, mode: VideoMode,
                  seeds, control: bool = False, graphs=None):
    """Encode B movies in lockstep: lanes_b (B, F, 32, 128, n_lanes) and
    bytes_b (B, F, 2, 32, 256) int32 on `dist`'s device; seeds: B ints;
    graphs: a `BodyGraphs` to replay the bodies on a card, or None for the
    eager loop.  Returns (ops (B, S, k*j, 6) uint8, final main (B, 32, 256)
    int32, final aux)."""
    dev = lanes_b.device
    B = lanes_b.shape[0]
    k, j, Sc = plan.k, plan.j, plan.chunk_steps
    S = len(plan.step_frame)
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
    if graphs is not None:
        banks = graphs.encode(dist.sub, table, lanes_b, bytes_b, plan, keys,
                              ops, mode, control)
    else:
        zero = torch.zeros((B, n_banks(mode), 32, 256), dtype=torch.int32,
                           device=dev)
        banks, up, dw = zero.clone(), zero.clone(), zero
        for b0, frame, bank, recompute, nv, live in _bodies(plan):
            chunk_body(up, dw, banks, lanes_b[:, frame], bytes_b[:, frame],
                       bank, recompute, dist.sub, table, keys,
                       torch.arange(b0, b0 + Sc, dtype=torch.int64,
                                    device=dev),
                       nv, live, ops[b0:b0 + Sc], mode, control)
    ops = ops.transpose(0, 1).reshape(B, S, k * j, OP_FIELDS)
    return ops, banks[:, 0], banks[:, -1]
