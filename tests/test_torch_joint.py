"""Joint content selection (`--joint_content`) in iivision_tpu_torch on the
CPU: the deterministic encoder against the host oracle and the JAX scan
(the cases of tests/test_encoder.py's joint differential), a seeded stream
against the JAX scan, and the plain batched chain on a crafted page where
the joint content is not the target byte."""

import functools

import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu import encoder_host
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import encoder
from iivision_tpu_torch.ops import distance, subop
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_encoder import get_dist, random_frames

DHGR = VideoMode.DHGR
HGR = VideoMode.HGR


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


@functools.lru_cache(None)
def torch_dist(mode):
    return distance.ComputedDistance(mode, Palette.NTSC, device="cpu")


def joint_plan(mode, k, j):
    """tests/test_encoder.py's joint differential plan: 2 frames, 700
    ticks."""
    plan, n_enc = jenc.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=2100.0 / 700 * 2,
        ticks_per_second=2100.0 * 2 / 700 * 350,
        every_n_video_frames=1, mode=jm(mode), k=k, j=j)
    assert n_enc == 2
    return plan


@pytest.mark.parametrize("mode,k,j", [(DHGR, 8, 1), (DHGR, 4, 2),
                                      (HGR, 4, 1)])
def test_joint_matches_host_oracle_and_jax(mode, k, j):
    """Deterministic joint streams equal encode_movie_host(joint=True) and
    the JAX scan's, op for op, with the same final screens; joint differs
    from the default rule somewhere."""
    fmain, faux = random_frames(jm(mode), n_frames=2, seed=5)
    plan = joint_plan(mode, k, j)
    lanes, bytes_tgt = jenc.prepare_targets(fmain, faux, jm(mode))
    j_ops, j_main, j_aux = jenc.encode_movie(
        get_dist(jm(mode)), lanes, bytes_tgt, plan, jm(mode), seed=None,
        joint=True)
    host = encoder_host.encode_movie_host(
        get_dist(jm(mode)), lanes, bytes_tgt, plan, jm(mode), seed=None,
        joint=True)

    t_lanes, t_bytes = encoder.prepare_targets(fmain, faux, mode, "cpu")
    ops, fin_main, fin_aux = encoder.encode_movie(
        torch_dist(mode), t_lanes, t_bytes, plan, mode, seed=None,
        joint=True)
    flat = encoder.flatten_ops(ops.numpy(), plan)
    assert np.array_equal(flat, host)
    S = len(plan.step_frame)
    assert np.array_equal(ops.numpy(), np.asarray(j_ops)[:S])
    assert np.array_equal(fin_main.numpy(), np.asarray(j_main))
    assert np.array_equal(fin_aux.numpy(), np.asarray(j_aux))

    dflt, _, _ = encoder.encode_movie(torch_dist(mode), t_lanes, t_bytes,
                                      plan, mode, seed=None)
    assert (encoder.flatten_ops(dflt.numpy(), plan) != flat).any()


@pytest.mark.parametrize("mode,k,j", [(DHGR, 8, 2), (HGR, 4, 3)])
def test_seeded_joint_matches_jax(mode, k, j):
    """Seeded joint streams (threefry nonces) equal the JAX scan's."""
    fmain, faux = random_frames(jm(mode), n_frames=2, seed=9)
    plan, _ = jenc.plan_movie(
        n_frames=2, n_audio_ticks=900, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=jm(mode),
        k=k, j=j)
    lanes, bytes_tgt = jenc.prepare_targets(fmain, faux, jm(mode))
    j_ops, j_main, _ = jenc.encode_movie(
        get_dist(jm(mode)), lanes, bytes_tgt, plan, jm(mode), seed=7,
        joint=True)
    t_lanes, t_bytes = encoder.prepare_targets(fmain, faux, mode, "cpu")
    ops, fin_main, _ = encoder.encode_movie(
        torch_dist(mode), t_lanes, t_bytes, plan, mode, seed=7, joint=True)
    S = len(plan.step_frame)
    assert np.array_equal(ops.numpy(), np.asarray(j_ops)[:S])
    assert np.array_equal(fin_main.numpy(), np.asarray(j_main))


def crafted_joint_page(C: int = 128):
    """One page where storing content 7 beats the target byte 5: the
    primary offset 10 (target 5, cost 0 for content 5, 100 for content 7)
    and offsets 20, 30, 40 (diff 800; content 5 costs 800 there, content 7
    costs 0).  Offset t reads table row t.  Returns (up, dw, tgt, table)
    as numpy arrays, table (256, C)."""
    up = np.zeros(256, np.int32)
    dw = np.zeros(256, np.int32)
    tgt = np.zeros(256, np.int32)
    up[10], dw[10], tgt[10] = 1000, 900, 5
    table = np.full((256, C), 1000, np.int32)
    table[10, 5], table[10, 7] = 0, 100
    for t in (20, 30, 40):
        up[t], dw[t] = 100, 800
        table[t, 5], table[t, 7] = 800, 0
    return up, dw, tgt, table


@pytest.mark.parametrize("joint", [False, True])
def test_crafted_joint_page_matches_host_oracle(joint):
    """The plain batched chain (B = 2: the crafted page, and an idle movie
    whose sub-op is a padding op) against the host oracle's step.  With
    joint content the op stores 7 over offsets 10, 20, 30, 40 and the
    primary keeps its residual (up = dw = 100); the default rule stores
    the target byte 5 at offset 10 alone and clears it."""
    C, page = 128, 3
    up, dw, tgt, table = crafted_joint_page(C)

    class HostDist:
        store_cost = np.zeros((4, 8192, C), np.float32)
        sub = distance.sub16(Palette.NTSC)

    henc = encoder_host.HostEncoder(jm(DHGR), HostDist, k=1, seed=None, j=1,
                                    joint=joint)
    henc.up[0, page], henc.dw[0, page] = up, dw
    henc.sc[page] = table  # row t of the table at offset t
    tgt_bank = np.zeros((32, 256), np.int32)
    tgt_bank[page] = tgt
    want = henc.step(tgt_bank, 0, 0, 1)

    rows = torch.zeros((2, 1, 4, 256), dtype=torch.float32)
    for i, x in enumerate((up, dw, np.zeros(256), tgt)):
        rows[0, 0, i] = torch.as_tensor(x, dtype=torch.float32)
    rows[1, 0, 3] = 9.0  # the idle movie's target bytes
    sc_rows = torch.arange(256, dtype=torch.int32).expand(2, 1, 256)
    out = torch.zeros((2, 1, 1, 6), dtype=torch.uint8)
    subop.sub_op_chain_plain(
        rows, sc_rows.contiguous(), torch.as_tensor(table, dtype=torch.int16),
        None, torch.tensor([[page], [0]]), 1,
        torch.tensor([0, 9], dtype=torch.int32), out, joint)
    assert out[0, 0].tolist() == [list(want[0])]
    assert out[1, 0].tolist() == [[32, 9, 0, 0, 0, 0]]
    if joint:
        assert want[0] == (35, 7, 10, 20, 30, 40)
        assert rows[0, 0, 0, 10] == rows[0, 0, 1, 10] == 100
    else:
        assert want[0] == (35, 5, 10, 10, 10, 10)
        assert rows[0, 0, 0, 10] == rows[0, 0, 1, 10] == 0
    assert np.array_equal(rows[0, 0, 0].numpy(), henc.up[0, page])
    assert np.array_equal(rows[0, 0, 1].numpy(), henc.dw[0, page])
    assert np.array_equal(rows[0, 0, 2].numpy(), henc.banks[0, page])
    assert torch.equal(rows[1, 0, :3], torch.zeros(3, 256))
