"""The body kernel's joint-content decomposition (csrc/body.cu
`joint_content`) on the CPU, written per element in numpy float32:

- each lane of the slot's warp owns four consecutive contents per pass of
  128 (c = q + 4 * lane + m: one pass for DHGR's C = 128, two for HGR's
  256);
- the page's eligible offsets (up > 0, not the primary) are scanned in
  ascending order, each content keeping a top three of dw[t] - cost(t, c)
  (zeros to start, so only positive gains enter);
- score[c] = (dw[off0] - cost(off0, c)) + ((a + b) + c3), every operation
  rounded to float32;
- each lane keeps its first best content, then the warp's argmax takes the
  largest score and the lowest content on ties.

It is held against ops/subop.joint_content_plain on pages crafted to tie
(one cost for every content; dw all zero), an all-zero page, pages with
one eligible offset and HGR's C = 256, and against the JAX scan's joint
branch: the port's CPU encode with this form in place of
joint_content_plain equals the JAX package's joint encode.  Exact
equality throughout."""

import functools

import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import encoder
from iivision_tpu_torch.ops import distance, subop
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_encoder import get_dist, random_frames

DHGR, HGR = VideoMode.DHGR, VideoMode.HGR
F32 = np.float32


@functools.lru_cache(None)
def table_of(mode):
    """(n_lanes * R, C) int16 store costs of the NTSC window model."""
    d = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
    return d.store_cost16.reshape(-1, d.n_contents)


def top3_insert(v, t):
    """The kernel's top-three insert for every content at once: t holds
    (a, b, c) rows with a >= b >= c; v is one offset's gains."""
    a, b, c = t
    gt_c, gt_b, gt_a = v > c, v > b, v > a
    c2 = np.where(gt_b, b, np.where(gt_c, v, c))
    b2 = np.where(gt_a, a, np.where(gt_b, v, b))
    a2 = np.where(gt_a, v, a)
    return a2, b2, c2


def joint_content_lanes(up, dw, rows, table, off0: int) -> int:
    """One page's joint content as the kernel decomposes it.  up, dw:
    (256,) float32 state; rows: (256,) table rows; table: (R, C) int16."""
    C = table.shape[1]
    cost = table[rows].astype(F32)  # (256, C)
    d0 = F32(dw[off0])
    best_v = np.full(32, -np.inf, F32)
    best_c = np.full(32, np.iinfo(np.int32).max)
    for q in range(0, C, 128):
        t = [np.zeros(128, F32) for _ in range(3)]
        for u in range(256):  # ascending offsets
            if up[u] > 0 and u != off0:
                t = top3_insert(F32(dw[u]) - cost[u, q:q + 128], t)
        score = (d0 - cost[off0, q:q + 128]) + ((t[0] + t[1]) + t[2])
        assert score.dtype == F32
        for lane in range(32):
            for m in range(4):
                v = score[4 * lane + m]
                if v > best_v[lane]:  # the lane's contents ascend
                    best_v[lane], best_c[lane] = v, q + 4 * lane + m
    # warp argmax: the largest score, the lowest content on ties
    top = best_v.max()
    return int(best_c[best_v == top].min())


def joint_content_batched(up, dw, base, flat, C: int, off0, not_prim):
    """joint_content_plain's signature, computed page by page with
    joint_content_lanes."""
    table = flat.reshape(-1, C).numpy()
    out = torch.empty(off0.shape, dtype=torch.int64)
    for b in range(up.shape[0]):
        for r in range(up.shape[1]):
            out[b, r] = joint_content_lanes(
                up[b, r].numpy(), dw[b, r].numpy(),
                (base[b, r] // C).numpy(), table, int(off0[b, r]))
    return out


def plain_content(up, dw, rows, table, off0):
    """ops/subop.joint_content_plain on one page."""
    C = table.shape[1]
    up_t = torch.as_tensor(up)[None, None]
    dw_t = torch.as_tensor(dw)[None, None]
    base = torch.as_tensor(rows, dtype=torch.int64)[None, None] * C
    off = torch.tensor([[off0]])
    not_prim = torch.arange(256) != off[..., None]
    return int(subop.joint_content_plain(up_t, dw_t, base,
                                         table.reshape(-1), C, off,
                                         not_prim)[0, 0])


def page(kind, mode, seed):
    """(up, dw, rows, table, off0) of one crafted page."""
    rng = np.random.RandomState(seed)
    table = table_of(mode)
    R = table.shape[0]
    up = (rng.randint(0, 3000, 256) * (rng.rand(256) < 0.6)).astype(F32)
    dw = rng.randint(0, 900, 256).astype(F32)
    rows = rng.randint(0, R, 256)
    off0 = int(np.argmax(up))
    if kind == "one_cost":  # every content costs the same: all tie
        table = torch.full_like(table, 100)
    elif kind == "zero_dw":  # no companion gain: cheapest contents tie
        dw[:] = 0
    elif kind == "all_zero":  # nothing pending: only the primary scores
        up[:] = 0
        dw[:] = 0
        off0 = 0
    elif kind == "one_eligible":
        up[:] = 0
        up[off0], up[(off0 + 77) % 256] = 500, 20
    elif kind == "few_rows":  # four table rows: many equal costs
        rows = rows % 4
    return up, dw, rows, table, off0


@pytest.mark.parametrize("mode,kind", [
    (DHGR, "random"), (HGR, "random"), (DHGR, "one_cost"),
    (HGR, "one_cost"), (DHGR, "zero_dw"), (HGR, "zero_dw"),
    (DHGR, "all_zero"), (DHGR, "one_eligible"), (DHGR, "few_rows")])
def test_joint_decomposition_matches_plain(mode, kind):
    """The per-element decomposition picks joint_content_plain's content
    on crafted pages, four seeds each."""
    for seed in range(4):
        up, dw, rows, table, off0 = page(kind, mode, seed)
        got = joint_content_lanes(up, dw, rows, table.numpy(), off0)
        assert got == plain_content(up, dw, rows, table, off0), seed
        assert 0 <= got < table.shape[1]
        if kind == "one_cost":
            assert got == 0  # every content ties: the first wins


@pytest.mark.parametrize("mode,k,j", [(DHGR, 8, 2), (HGR, 4, 2)])
def test_joint_decomposition_in_the_jax_encode(monkeypatch, mode, k, j):
    """The port's CPU joint encode with the decomposition in place of
    joint_content_plain equals the JAX scan's joint encode (seeded), op
    for op, with the same final screens."""
    jmode = JVideoMode[mode.name]
    fmain, faux = random_frames(jmode, n_frames=2, seed=4)
    plan, _ = jenc.plan_movie(
        n_frames=2, n_audio_ticks=500, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=jmode, k=k,
        j=j)
    lanes, bytes_tgt = jenc.prepare_targets(fmain, faux, jmode)
    j_ops, j_main, _ = jenc.encode_movie(get_dist(jmode), lanes, bytes_tgt,
                                         plan, jmode, seed=3, joint=True)
    monkeypatch.setattr(subop, "joint_content_plain", joint_content_batched)
    t_lanes, t_bytes = encoder.prepare_targets(fmain, faux, mode, "cpu")
    dist = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
    ops, fin_main, _ = encoder.encode_movie(dist, t_lanes, t_bytes, plan,
                                            mode, seed=3, joint=True)
    S = len(plan.step_frame)
    assert np.array_equal(ops.numpy(), np.asarray(j_ops)[:S])
    assert np.array_equal(fin_main.numpy(), np.asarray(j_main))
