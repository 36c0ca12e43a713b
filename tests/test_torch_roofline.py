"""The encode's cost model in iivision_tpu_torch (roofline): its counts of
chunk starts against the JAX model's and of bodies against the bodies the
port's encoder runs, its per-kernel bytes and operations against the
formulas chip_smoke.py used for the kernels' bounds, its scaling in the
batch, the card peaks and the report.  All exact: the counts are integers
and the report's numbers follow from them."""

import numpy as np
import pytest
import torch

from iivision_tpu import roofline as jroofline
from iivision_tpu_torch import encoder, roofline
from iivision_tpu_torch.ops import body, yiq
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_torch_batch import jm
from tests.test_torch_joint import torch_dist

DHGR = VideoMode.DHGR
HGR = VideoMode.HGR
H100 = "NVIDIA H100 80GB HBM3"


def plan_for(mode, k, j, seconds=1.0):
    """A clip of `seconds` at 30 fps, every 2nd frame encoded, 14,700 Hz."""
    plan, _ = encoder.plan_movie(
        n_frames=int(30 * seconds), n_audio_ticks=int(14700 * seconds),
        input_frame_rate=30.0, ticks_per_second=14700.0,
        every_n_video_frames=2, mode=mode, k=k, j=j)
    return plan


@pytest.mark.parametrize("mode,k,j", [(DHGR, 8, 1), (DHGR, 16, 4),
                                      (HGR, 8, 1), (HGR, 4, 3)])
def test_counts_match_jax_and_the_encoder(mode, k, j, monkeypatch):
    """Chunk starts equal the JAX model's n_chunks for the same plan;
    chunk starts and bodies equal the calls the port's encode_segment makes
    (the body wrapper replaced by a counter: a call with a cost basis is a
    recomputing body), here and split over 2 shards."""
    plan = plan_for(mode, k, j)
    cost = roofline.encode_cost(plan, mode, batch=3)
    assert cost.chunk_starts == jroofline.encode_cost(plan, jm(mode)).n_chunks
    assert cost.steps == len(plan.step_frame)
    assert cost.seq_subops == int((plan.step_nvalid > 0).sum()) * j
    calls = {"chunk_start": 0, "encode_body": 0}

    def counter(*args, sub=None, **kw):
        calls["encode_body"] += 1
        calls["chunk_start"] += sub is not None

    monkeypatch.setattr(body, "encode_body", counter)
    F = int(plan.step_frame.max()) + 1
    main = np.zeros((3, F, 32, 256), np.uint8)
    lanes, bytes_ = encoder.prepare_targets(
        main, main if mode == DHGR else None, mode, "cpu")
    encoder.encode_movies(torch_dist(mode), lanes, bytes_, plan, mode,
                          seeds=None)
    assert calls == {"chunk_start": cost.chunk_starts,
                     "encode_body": cost.bodies}
    two = roofline.encode_cost(plan, mode, batch=3, shards=2)
    assert (two.chunk_starts, two.bodies) == (2 * cost.chunk_starts,
                                              2 * cost.bodies)
    assert two.bytes == cost.bytes


@pytest.mark.parametrize("mode", [DHGR, HGR])
@pytest.mark.parametrize("B", [1, 32])
def test_kernel_counts_equal_the_smoke_formulas(mode, B):
    """chunk_start_cost and body_cost against chip_smoke.py's formulas for
    the body kernel's recompute prologue (window, mono and yiq bases: the
    other bank's row and the basis) and the body kernel (default and joint,
    a body with padding and one without, with and without the recompute,
    which drops the read of dw)."""
    nb = 2 if mode == DHGR else 1
    L = 10 if mode == DHGR else 18
    for model in ("window", "mono", "yiq"):
        sub_shape = ((nb * 2 if mode == DHGR else 2, yiq.n_pixels(mode),
                      128, 128) if model == "yiq" else (16, 16))
        nbytes = B * (nb - 1) * 8192 * 4
        nbytes += (min(int(np.prod(sub_shape)), B * 8192 * sub_shape[1]) * 4
                   if model == "yiq" else 1024)
        int_ops = B * 32 * 240 * (sub_shape[1] if model == "yiq"
                                  else 4 * L)
        assert roofline.chunk_start_cost(mode, B, model) == (
            nbytes, 0.0, int_ops)
    C = 128 if mode == DHGR else 256
    for k, j, Sc, run in ((8, 1, 8, 8), (16, 4, 2, 1), (8, 1, 8, 5)):
        for joint in (False, True):
            for recompute in (False, True):
                nbytes = B * ((5 if recompute else 6) * 8192 * 4
                              + 2 * 8192 * 4 + run * k * j * 256 * 2
                              + Sc * k * j * 6)
                ops_f = 0.0
                if joint:
                    nbytes += B * 8192 * C * 2
                    ops_f = 2.0 * B * run * k * j * 256 * C
                assert roofline.body_cost(
                    mode, k, j, B, Sc, run, joint,
                    recompute=recompute) == (nbytes, ops_f, 0.0)


@pytest.mark.parametrize("mode,k,j", [(DHGR, 32, 10), (DHGR, 1, 1),
                                      (HGR, 16, 4)])
def test_seeded_bodies_count_their_nonce_draws(mode, k, j):
    """seeded=True adds the threefry draws of every step run as int32
    operations, and nothing else: per step run the step key and the page
    key (a block each), 32 page uniforms, and per slot and sub-op its key
    and 256 offset uniforms; a block is 79 int32 operations (2 key-parity
    xors, 2 adds, 20 rounds of add, funnel-shift rotation and xor, 5 key
    injections of 3 adds), a uniform one block and 3 bit operations."""
    block = 2 + 2 + 20 * 3 + 5 * 3
    uniform = block + 3
    per_step = 2 * block + 32 * uniform + k * j * (block + 256 * uniform)
    for B, Sc, run in ((1, 8, 8), (32, 8, 5), (3, 1, 1), (2, 4, 0)):
        plain = roofline.body_cost(mode, k, j, B, Sc, run)
        seeded = roofline.body_cost(mode, k, j, B, Sc, run, seeded=True)
        assert seeded[:2] == plain[:2] and plain[2] == 0.0
        assert seeded[2] == B * run * per_step
    plan = plan_for(mode, k, j)
    runs = int((plan.step_nvalid > 0).sum())
    for B in (1, 32):
        plain = roofline.encode_cost(plan, mode, B)
        seeded = roofline.encode_cost(plan, mode, B, seeded=True)
        assert (seeded.bytes, seeded.fp32_ops) == (plain.bytes,
                                                   plain.fp32_ops)
        assert seeded.int32_ops - plain.int32_ops == B * runs * per_step
    # at k=32 j=10 a body's step draws 82,274 blocks
    assert roofline.nonce_int32_ops(32, 10) == 82274 * block + (
        32 + 81920) * 3


@pytest.mark.parametrize("model,joint", [("window", False), ("yiq", False),
                                         ("window", True)])
def test_totals_scale_with_the_batch(model, joint):
    """Operations are proportional to the batch; bytes grow by the same
    amount per movie (the cost basis is read once per chunk start, and
    the yiq basis is capped by the offsets that index it)."""
    plan = plan_for(DHGR, 16, 4)
    c = {b: roofline.encode_cost(plan, DHGR, b, model, joint)
         for b in (1, 2, 32)}
    assert c[32].int32_ops == 32 * c[1].int32_ops
    assert c[32].fp32_ops == 32 * c[1].fp32_ops
    assert (c[32].fp32_ops > 0) == joint
    per_movie = c[2].bytes - c[1].bytes
    if model == "window":
        assert c[32].bytes == c[1].bytes + 31 * per_movie
    else:
        assert c[32].bytes <= c[1].bytes + 31 * per_movie
    assert per_movie > 0
    assert all(v.chunk_starts == c[1].chunk_starts for v in c.values())


def test_device_peaks():
    """The H100's entry by its name and by a device's; an unknown card,
    and the CPU, raise: there is no fallback peak."""
    p = roofline.device_peaks(H100)
    assert p.hbm_bytes_per_s == 3.35e12 and p.fp32_ops_per_s == 67e12
    assert p.int32_ops_per_s == 64 * 132 * 1.98e9
    assert p.fp64_ops_per_s == 2 * 64 * 132 * 1.98e9
    assert roofline.least_time(0, 0, 0, p, p.fp64_ops_per_s) == (
        1.0, "operations")
    with pytest.raises(ValueError, match="no peaks for the card"):
        roofline.device_peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no peaks for device cpu"):
        roofline.device_peaks("cpu")
    names = {}

    def name(dev=None):
        names["asked"] = dev
        return H100

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "get_device_name", name)
        assert roofline.device_peaks(torch.device("cuda", 0)) == p
        assert roofline.device_peaks(0) == p
        assert names["asked"] == torch.device("cuda", 0)


def test_report_fields_and_line():
    """The report's numbers follow from encode_cost and the peaks, its
    bound names the latency floor when the encode reaches little of the
    least time, and bytes or operations when it reaches most of it."""
    plan = plan_for(DHGR, 16, 4)
    cost = roofline.encode_cost(plan, DHGR, 32, "window", True, 2)
    peaks = roofline.device_peaks(H100)
    rec = roofline.report(plan, DHGR, 32, 0.5, H100, joint=True, shards=2)
    least = max(cost.bytes / peaks.hbm_bytes_per_s,
                cost.fp32_ops / peaks.fp32_ops_per_s
                + cost.int32_ops / peaks.int32_ops_per_s)
    assert rec["least_ms"] == pytest.approx(least * 1e3, rel=1e-12)
    assert rec["bound_share_pct"] == pytest.approx(100 * least / 0.5,
                                                   rel=1e-12)
    assert rec["hbm_pct_of_peak"] == pytest.approx(
        100 * cost.bytes / 0.5 / peaks.hbm_bytes_per_s, rel=1e-12)
    assert (rec["chunk_starts"], rec["bodies"], rec["steps"],
            rec["seq_subops"]) == (cost.chunk_starts, cost.bodies,
                                   cost.steps, cost.seq_subops)
    assert rec["bound"] == "latency(%d seq sub-ops @ %.2fus)" % (
        cost.seq_subops, 0.5 / cost.seq_subops * 1e6)
    assert "mfu_pct" not in rec
    assert rec["line"].startswith("roofline[B=32 DHGR window k=16 j=4 joint "
                                  "shards=2]: 0.5000s;")
    assert rec["line"].endswith(rec["bound"] + "-bound")
    fast = roofline.report(plan, DHGR, 32, least * 1.5, H100, joint=True)
    assert fast["bound"] in ("bytes", "operations")
