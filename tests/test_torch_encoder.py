"""iivision_tpu_torch encoder on the CPU against the JAX package: the golden
stream, seeded DHGR, HGR and mono streams byte-equal to
`iivision_tpu.encoder.encode_movie`, and the plain sub-op chain against
the host oracle under the window and yiq models."""

import functools
import hashlib

import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu import encoder_host
from iivision_tpu.ops import distance as jdist
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import cli, encoder
from iivision_tpu_torch.ops import distance, subop
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_pipeline import gradient_movie

DHGR = VideoMode.DHGR
HGR = VideoMode.HGR


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]
GOLDEN_SHA = "57fdd52adf53d75101ed121d28d8a5389465c09f99d960ba6c47c20dbdb30fbc"


@functools.lru_cache(None)
def torch_dist(mode=DHGR, model="window"):
    return distance.ComputedDistance(mode, Palette.NTSC, model, device="cpu")


def random_frames(n_frames, seed, mode=DHGR):
    """DHGR: 7-bit main and aux bytes; HGR: 8-bit main bytes, no aux."""
    rng = np.random.RandomState(seed)
    hi = 0x80 if mode == DHGR else 0x100
    main = rng.randint(0, hi, (n_frames, 32, 256)).astype(np.uint8)
    aux = rng.randint(0, hi, (n_frames, 32, 256)).astype(np.uint8)
    return main, (aux if mode == DHGR else None)


def host_oracle_ops(dist, lanes, bytes_tgt, plan, mode):
    """The host oracle (encoder_host.HostEncoder) on the port's tables:
    its flat ops and final banks."""

    class HostDist:  # the host oracle reads store_cost and sub
        store_cost = dist.store_cost16.numpy().astype(np.float32)
        sub = dist.sub.numpy()

    henc = encoder_host.HostEncoder(jm(mode), HostDist, k=plan.k, seed=None,
                                    j=plan.j)
    host = []
    for s in range(len(plan.step_frame)):
        f, b = int(plan.step_frame[s]), int(plan.step_bank[s])
        if plan.step_recompute[s]:
            henc.recompute(lanes[f].numpy(), b)
        host.extend(henc.step(bytes_tgt[f, b].numpy(), f, b,
                              int(plan.step_nvalid[s])))
    return np.asarray(host, dtype=np.int32), henc.banks


def assert_ops_equal(flat, host):
    assert flat.shape == host.shape
    mismatch = np.nonzero((flat != host).any(axis=1))[0]
    assert mismatch.size == 0, (mismatch[:3], flat[mismatch[:3]],
                                host[mismatch[:3]])


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
        ticks_per_second=14700.0, every_n_video_frames=1, mode=jm(DHGR),
        k=k, j=j)
    assert plan.step_bank.max() == 1
    lanes, bytes_tgt = jenc.prepare_targets(fmain, faux, jm(DHGR))
    jd = jdist.ComputedDistance(jm(DHGR), JPalette.NTSC)
    j_ops, j_main, j_aux = jenc.encode_movie(jd, lanes, bytes_tgt, plan,
                                             jm(DHGR), seed=seed)
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
    check_host_oracle(DHGR, k, j)


@pytest.mark.parametrize("k,j", [(4, 1), (4, 3)])
def test_hgr_deterministic_matches_host_oracle(k, j):
    """The HGR cases of tests/test_encoder.py's differential."""
    check_host_oracle(HGR, k, j)


def check_host_oracle(mode, k, j):
    fmain, faux = random_frames(2, 3, mode)
    plan, _ = jenc.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=6.0,
        ticks_per_second=2100.0, every_n_video_frames=1, mode=jm(mode),
        k=k, j=j)
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, mode, "cpu")
    ops, fin_main, fin_aux = encoder.encode_movie(
        torch_dist(mode), lanes, bytes_tgt, plan, mode, seed=None)
    flat = encoder.flatten_ops(ops.numpy(), plan)
    host, banks = host_oracle_ops(torch_dist(mode), lanes, bytes_tgt, plan,
                                  mode)
    assert flat.shape == (plan.n_ops, 6)
    assert_ops_equal(flat, host)
    assert np.array_equal(fin_main.numpy(), banks[0])
    assert np.array_equal(fin_aux.numpy(), banks[-1])


@pytest.mark.parametrize("mode", [DHGR, HGR])
def test_yiq_matches_host_oracle(mode):
    """The yiq basis (a 4-D `sub`, window gather-sums in the diff, the
    shipped float32 table truncated to int16): the host-oracle differential
    of tests/test_yiq.py."""
    dist = torch_dist(mode, "yiq")
    assert dist.sub.dim() == 4
    rng = np.random.RandomState(21)
    hi = 0x80 if mode == DHGR else 0x100
    fmain = rng.randint(0, hi, size=(2, 32, 256)).astype(np.uint8)
    faux = (rng.randint(0, hi, size=(2, 32, 256)).astype(np.uint8)
            if mode == DHGR else None)
    plan, _ = jenc.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=2100.0 / 700 * 2,
        ticks_per_second=2100.0 * 2 / 700 * 350,
        every_n_video_frames=1, mode=jm(mode), k=8)
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, mode, "cpu")
    ops, _, _ = encoder.encode_movie(dist, lanes, bytes_tgt, plan, mode,
                                     seed=None)
    host, _ = host_oracle_ops(dist, lanes, bytes_tgt, plan, mode)
    assert_ops_equal(encoder.flatten_ops(ops.numpy(), plan), host)


@pytest.mark.parametrize("mode,model,k,j", [
    (HGR, "window", 4, 1), (HGR, "window", 4, 3), (DHGR, "mono", 8, 2)])
def test_seeded_mode_and_model_match_jax(mode, model, k, j, tmp_path,
                                         monkeypatch):
    """Seeded HGR streams (one bank, 256 contents, whole-frame chunks of
    several bodies) and a seeded mono stream equal the JAX scan's byte for
    byte.  The mono table is built once, by the JAX package into a temp
    user cache, and the port loads that file: tables either package writes
    serve both (the port's own build is held in test_torch_distance)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    fmain, faux = random_frames(2, 17, mode)
    plan, _ = jenc.plan_movie(
        n_frames=2, n_audio_ticks=900, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=jm(mode),
        k=k, j=j)
    if mode == HGR:
        assert plan.chunk_steps == jenc.BODY_CAP  # continuation bodies
    lanes, bytes_tgt = jenc.prepare_targets(fmain, faux, jm(mode))
    jd = jdist.ComputedDistance(jm(mode), JPalette.NTSC, model)
    j_ops, j_main, j_aux = jenc.encode_movie(jd, lanes, bytes_tgt, plan,
                                             jm(mode), seed=5)
    t_lanes, t_bytes = encoder.prepare_targets(fmain, faux, mode, "cpu")
    assert np.array_equal(t_lanes.numpy(), np.asarray(lanes))
    assert np.array_equal(t_bytes.numpy(), np.asarray(bytes_tgt))
    td = distance.ComputedDistance(mode, Palette.NTSC, model, device="cpu")
    assert np.array_equal(td.store_cost16.numpy().astype(np.float32),
                          np.asarray(jd.store_cost))
    t_ops, t_main, t_aux = encoder.encode_movie(td, t_lanes, t_bytes, plan,
                                                mode, seed=5)
    S = len(plan.step_frame)
    assert np.array_equal(t_ops.numpy(), np.asarray(j_ops)[:S])
    assert np.array_equal(t_main.numpy(), np.asarray(j_main))
    assert np.array_equal(t_aux.numpy(), np.asarray(j_aux))


def test_offset_zero_companion_matches_host_oracle():
    """A sub-op whose only companion is offset 0: the later companion
    rounds find nothing and come back to offset 0, which must stay stored
    (kernel B once dropped it; the plain chain is held to the oracle)."""
    C = 128

    class HostDist:
        store_cost = np.zeros((4, 8192, C), np.float32)
        sub = distance.sub16(Palette.NTSC)

    henc = encoder_host.HostEncoder(jm(DHGR), HostDist, k=1, seed=None, j=1)
    page = 3
    henc.up[0, page, 10], henc.up[0, page, 0] = 1000, 500
    henc.dw[0, page, 10], henc.dw[0, page, 0] = 900, 800
    tgt = np.zeros((32, 256), np.int32)
    tgt[page, 10] = 5
    rows = torch.stack([torch.as_tensor(x[page], dtype=torch.float32)
                        for x in (henc.up[0], henc.dw[0], henc.banks[0],
                                  tgt)])[None, None]
    out = torch.zeros((1, 1, 1, 6), dtype=torch.uint8)
    subop.sub_op_chain_plain(
        rows, torch.zeros((1, 1, 256), dtype=torch.int32),
        torch.zeros((1, C), dtype=torch.int16), None, torch.tensor([[page]]),
        1, torch.zeros(1, dtype=torch.int32), out)
    want = henc.step(tgt, 0, 0, 1)
    assert out[0, 0].tolist() == [list(want[0])] == [[35, 5, 10, 0, 10, 10]]
    assert np.array_equal(rows[0, 0, 0].numpy(), henc.up[0, page])
    assert np.array_equal(rows[0, 0, 2].numpy(), henc.banks[0, page])
    assert rows[0, 0, 2, 0] == 5 and rows[0, 0, 0, 0] == 0


def test_unported_mode_raises(capsys, tmp_path):
    """A solo input ignores --mesh, as the JAX CLI does: the same bytes as
    without it; --chunk_frames (once refused here) is ported for one input
    and refused for a batch, which encodes whole movies in lockstep."""
    clip = str(tmp_path / "a.npy")
    np.save(clip, gradient_movie(F=4))
    outs = [str(tmp_path / "plain.a2m"), str(tmp_path / "mesh.a2m")]
    cli.main([clip, "--device", "cpu", "--output", outs[0]])
    cli.main([clip, "--mesh", "2", "--device", "cpu", "--output", outs[1]])
    assert capsys.readouterr().out.count("Wrote ") == 2
    data = [open(p, "rb").read() for p in outs]
    assert len(data[0]) > 0 and data[0] == data[1]
    with pytest.raises(SystemExit):
        cli.main(["a.npy", "b.npy", "--joint_content", "--chunk_frames",
                  "64", "--device", "cpu"])
    assert "--chunk_frames applies to one input" in capsys.readouterr().err


def test_distance_model_on_another_device_is_refused():
    fmain, faux = random_frames(1, 0)
    plan, _ = jenc.plan_movie(
        n_frames=1, n_audio_ticks=100, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=jm(DHGR), k=8)
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, DHGR, "cpu")

    class MetaDist:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="distance model on meta"):
        encoder.encode_movie(MetaDist, lanes, bytes_tgt, plan, DHGR)
