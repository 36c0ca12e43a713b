"""iivision_tpu_torch encoder on the CPU against the JAX package: the golden
stream, seeded streams byte-equal to `iivision_tpu.encoder.encode_movie`,
and the plain sub-op chain against the host oracle."""

import functools
import hashlib

import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu import encoder_host
from iivision_tpu.ops import distance as jdist
from iivision_tpu.palettes import Palette
from iivision_tpu.stream.emit_fast import emit_stream_fast
from iivision_tpu.video_mode import VideoMode
from iivision_tpu_torch import encoder
from iivision_tpu_torch.ops import distance

DHGR = VideoMode.DHGR
GOLDEN_SHA = "57fdd52adf53d75101ed121d28d8a5389465c09f99d960ba6c47c20dbdb30fbc"


@functools.lru_cache(None)
def torch_dist():
    return distance.ComputedDistance(DHGR, Palette.NTSC, device="cpu")


def random_frames(n_frames, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 0x80, (n_frames, 32, 256)).astype(np.uint8),
            rng.randint(0, 0x80, (n_frames, 32, 256)).astype(np.uint8))


def test_golden_stream_hash():
    """The JAX package's pinned deterministic stream
    (tests/test_stream.py), encoded by the port."""
    rng = np.random.RandomState(123)
    fmain = rng.randint(0, 0x80, size=(2, 32, 256)).astype(np.uint8)
    faux = rng.randint(0, 0x80, size=(2, 32, 256)).astype(np.uint8)
    plan, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=1200, input_frame_rate=12.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=DHGR, k=8)
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, DHGR, "cpu")
    ops, _, _ = encoder.encode_movie(torch_dist(), lanes, bytes_tgt, plan,
                                     DHGR, seed=None)
    flat = encoder.flatten_ops(ops.numpy(), plan)
    levels = ((np.arange(plan.n_ops) % 32) - 15).astype(np.int32)
    data = emit_stream_fast(flat, levels, DHGR)
    assert len(data) == 10240
    assert hashlib.sha256(data).hexdigest() == GOLDEN_SHA


@pytest.mark.parametrize("seed,k,j", [(0, 8, 1), (3, 16, 4)])
def test_seeded_stream_matches_jax(seed, k, j):
    """Random tie-breaks: the port's threefry nonces and float32 score
    arithmetic give the JAX scan's ops and final screens byte for byte
    (3 frames, ~1200 ticks, bank flips inside frames)."""
    fmain, faux = random_frames(3, seed + 40)
    plan, _ = jenc.plan_movie(
        n_frames=3, n_audio_ticks=1200, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=DHGR, k=k,
        j=j)
    assert plan.step_bank.max() == 1
    lanes, bytes_tgt = jenc.prepare_targets(fmain, faux, DHGR)
    jd = jdist.ComputedDistance(DHGR, Palette.NTSC)
    j_ops, j_main, j_aux = jenc.encode_movie(jd, lanes, bytes_tgt, plan,
                                             DHGR, seed=seed)
    t_lanes, t_bytes = encoder.prepare_targets(fmain, faux, DHGR, "cpu")
    assert np.array_equal(t_lanes.numpy(), np.asarray(lanes))
    assert np.array_equal(t_bytes.numpy(), np.asarray(bytes_tgt))
    t_ops, t_main, t_aux = encoder.encode_movie(torch_dist(), t_lanes,
                                                t_bytes, plan, DHGR,
                                                seed=seed)
    S = len(plan.step_frame)
    assert np.array_equal(t_ops.numpy(), np.asarray(j_ops)[:S])
    assert np.array_equal(encoder.flatten_ops(t_ops.numpy(), plan),
                          jenc.flatten_ops(np.asarray(j_ops), plan))
    assert np.array_equal(t_main.numpy(), np.asarray(j_main))
    assert np.array_equal(t_aux.numpy(), np.asarray(j_aux))


@pytest.mark.parametrize("k,j", [(1, 1), (8, 1), (4, 2), (32, 8)])
def test_deterministic_matches_host_oracle(k, j):
    """With zero nonces the encoder (plain sub-op chain on the CPU) emits
    the host oracle's ops and final screens (encoder_host.HostEncoder)."""
    fmain, faux = random_frames(2, 3)
    plan, _ = jenc.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=6.0,
        ticks_per_second=2100.0, every_n_video_frames=1, mode=DHGR, k=k,
        j=j)
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, DHGR, "cpu")
    ops, fin_main, fin_aux = encoder.encode_movie(
        torch_dist(), lanes, bytes_tgt, plan, DHGR, seed=None)
    flat = encoder.flatten_ops(ops.numpy(), plan)

    class HostDist:  # the host oracle reads store_cost and sub
        store_cost = torch_dist().store_cost16.numpy().astype(np.float32)
        sub = distance.sub16(Palette.NTSC)

    henc = encoder_host.HostEncoder(DHGR, HostDist, k=k, seed=None, j=j)
    host = []
    for s in range(len(plan.step_frame)):
        f, b = int(plan.step_frame[s]), int(plan.step_bank[s])
        if plan.step_recompute[s]:
            henc.recompute(lanes[f].numpy(), b)
        host.extend(henc.step(bytes_tgt[f, b].numpy(), f, b,
                              int(plan.step_nvalid[s])))
    host = np.asarray(host, dtype=np.int32)
    assert flat.shape == host.shape == (plan.n_ops, 6)
    mismatch = np.nonzero((flat != host).any(axis=1))[0]
    assert mismatch.size == 0, (mismatch[:3], flat[mismatch[:3]],
                                host[mismatch[:3]])
    assert np.array_equal(fin_main.numpy(), henc.banks[0])
    assert np.array_equal(fin_aux.numpy(), henc.banks[1])


def test_unported_mode_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        encoder.prepare_targets(np.zeros((1, 32, 256), np.uint8), None,
                                VideoMode.HGR, "cpu")


def test_distance_model_on_another_device_is_refused():
    fmain, faux = random_frames(1, 0)
    plan, _ = jenc.plan_movie(
        n_frames=1, n_audio_ticks=100, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=DHGR, k=8)
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, DHGR, "cpu")

    class MetaDist:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="distance model on meta"):
        encoder.encode_movie(MetaDist, lanes, bytes_tgt, plan, DHGR)
