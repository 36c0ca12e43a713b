"""The plain reference agrees with the port's CPU path on a few frames of
each configuration: ingest on both paths, the levels, the encoder's ops
and final screens, the stream.  The reference's graph path (its chunk
bodies replayed as CUDA graphs) gives the eager loop's ops and final
screens byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.gen import clips as gen
from benchmark.reference import audio, check, encode, ingest
from benchmark.reference.distance import Distance
from benchmark.reference.palettes import Palette as RP
from benchmark.reference.plan import flatten_ops, plan_movie
from benchmark.reference.stream import frame_stream
from benchmark.reference.video_mode import VideoMode as RV

from iivision_tpu_torch import audio as p_audio
from iivision_tpu_torch import encoder as p_encoder
from iivision_tpu_torch import frames as p_frames
from iivision_tpu_torch.bench import audio_levels_device
from iivision_tpu_torch.movie import get_distance
from iivision_tpu_torch.ops import dither as p_dither
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.parallel import mesh
from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
from iivision_tpu_torch.video_mode import VideoMode

MODES = ("DHGR", "HGR")


def _clip(F, phase=0.7):
    return gen.synth_movies_device(np.array([phase, phase + 1.1]), F, "cpu")


@pytest.mark.parametrize("mode", MODES)
def test_device_ingest(mode):
    rgb = _clip(3)
    lanes, by = mesh.ingest_movies_batch(rgb, VideoMode[mode], Palette.NTSC)
    for b in range(2):
        main, aux = ingest.ingest_device(rgb[b], RV[mode], RP.NTSC)
        assert torch.equal(by[b, :, 0].to(torch.uint8), main)
        assert torch.equal(by[b, :, 1].to(torch.uint8), aux)
        ref_lanes, ref_bytes = encode.target_lanes(main, aux, RV[mode])
        assert torch.equal(ref_lanes, lanes[b])
        assert torch.equal(ref_bytes, by[b])


def test_host_ingest():
    rgb = _clip(6)[0].numpy()
    parts = list(p_frames.ingest_stream_array(
        rgb, VideoMode.DHGR, Palette.NTSC, every_n_video_frames=2))
    main, aux = ingest.ingest_host(rgb[::2], RV.DHGR, RP.NTSC)
    assert np.array_equal(np.concatenate([p[0] for p in parts]), main)
    assert np.array_equal(np.concatenate([p[1] for p in parts]), aux)


def test_lut_at_keys():
    lut = p_dither._host_fused_lut(Palette.NTSC)
    keys = np.random.default_rng(3).integers(0, 1 << 24, 200_000)
    assert np.array_equal(ingest.lut_codes(keys, RP.NTSC), lut[keys])


def test_levels():
    wave = gen.tone(0.5, 14700, 440.0)
    aud = p_audio.Audio(data=wave, rate=14700, bitrate=14700, device="cpu")
    norm = audio.normalization(wave, 14700, 14700)
    assert norm == aud.normalization
    assert np.array_equal(audio.levels_host(wave, norm), aud.levels())
    dev = audio_levels_device(torch.as_tensor(wave), aud.normalization)
    assert torch.equal(audio.levels_device(torch.as_tensor(wave), norm), dev)


@pytest.mark.parametrize("mode", MODES)
def test_encode_and_stream(mode):
    F_src = 8
    rgb = _clip(F_src // 2, phase=2.3)
    wave = gen.tone(F_src / 30, 14700, 440.0)
    pm = VideoMode[mode]
    plan, _ = p_encoder.plan_movie(
        n_frames=F_src, n_audio_ticks=len(wave), input_frame_rate=30,
        ticks_per_second=14700, every_n_video_frames=2, mode=pm, k=16, j=4)
    lanes, by = mesh.ingest_movies_batch(rgb, pm, Palette.NTSC)
    dist = get_distance(pm, Palette.NTSC, device="cpu")
    ops, main, aux = mesh.encode_movies_batch(dist, lanes, by, plan, pm,
                                              seeds=[11, 2 ** 31 - 1])
    flat = mesh.fetch_ops_compact(ops, plan)
    rplan, _ = plan_movie(F_src, len(wave), 30.0, 14700.0, 2, RV[mode], 16, 4)
    assert np.array_equal(rplan.step_nvalid, plan.step_nvalid)
    st = check.Setting(harness.load_json(
        "%s/configs/%s_ntsc_k16_j4.json" % (harness.BENCH_DIR, mode.lower())),
        "device", "cpu")
    r_ops, r_main, r_aux = encode.encode_movies(
        st.dist, *encode.target_lanes(by[:, :, 0].to(torch.uint8),
                                      by[:, :, 1].to(torch.uint8), RV[mode]),
        rplan, RV[mode], [11, 2 ** 31 - 1])
    assert torch.equal(r_main, main) and torch.equal(r_aux, aux)
    lv = np.clip(np.arange(plan.n_ops) % 32 - 15, -15, 16).astype(np.int32)
    for b in range(2):
        r_flat = flatten_ops(r_ops[b].numpy(), rplan)
        assert np.array_equal(r_flat, flat[b])
        assert frame_stream(r_flat, lv, RV[mode]) == emit_stream_fast(
            flat[b], lv, pm)


@pytest.mark.parametrize("mode", MODES)
def test_stream_framing_edges(mode):
    rng = np.random.default_rng(1)
    for n in (1, 290, 291, 292, 583, 584, 2000):
        flat = np.stack([rng.integers(32, 64, n)] + [
            rng.integers(0, 256, n) for _ in range(5)], 1).astype(np.uint8)
        lv = rng.integers(-15, 17, n).astype(np.int32)
        assert frame_stream(flat, lv, RV[mode]) == emit_stream_fast(
            flat, lv, VideoMode[mode])


def test_control_is_lower_precision_only():
    """The control's stages differ from the reference's only in precision:
    on integer-valued inputs that no rounding touches they agree."""
    x = torch.zeros(64)
    assert torch.equal(audio.levels_device(x, 2.0, True),
                       audio.levels_device(x, 2.0))
    flat = np.zeros((2, 10, 10, 3), np.uint8)
    assert np.array_equal(ingest.resize_host(flat, 10, 5, True),
                          ingest.resize_host(flat, 10, 5))


def _graph_case(mode, B, device):
    """A few encoded frames of B movies with random targets, and a plan
    of several chunk bodies with full, partial and empty steps (HGR's plan
    has no empty step at k=16 j=4: the last step of its second body is
    emptied)."""
    F_src = 8
    plan, _ = plan_movie(F_src, F_src * 14700 // 30, 30.0, 14700.0, 2,
                         RV[mode], 16, 4)
    nv = np.array(plan.step_nvalid)
    if mode == "HGR":
        nv[2 * plan.chunk_steps - 1] = 0
        plan = dataclasses.replace(plan, step_nvalid=nv)
    assert len(nv) >= 2 * plan.chunk_steps
    assert (nv == 64).any() and ((nv > 0) & (nv < 64)).any()
    assert (nv == 0).any()
    g = torch.Generator(device=device).manual_seed(17 + B)
    F = int(np.max(plan.step_frame)) + 1
    main, aux = (torch.randint(0, 256, (B, F, 32, 256), generator=g,
                               device=device, dtype=torch.uint8)
                 for _ in range(2))
    lanes, by = encode.target_lanes(main, aux, RV[mode])
    seeds = [2 ** 31 - 1 - b for b in range(B)]
    return Distance(RV[mode], RP.NTSC, device), lanes, by, plan, seeds


def _graph_path_equals_eager(mode, B, device, graphs):
    dist, lanes, by, plan, seeds = _graph_case(mode, B, device)
    for control in (False, True):
        want = encode.encode_movies(dist, lanes, by, plan, RV[mode], seeds,
                                    control)
        for _ in range(2):  # captures, then replays only
            got = encode.encode_movies(dist, lanes, by, plan, RV[mode],
                                       seeds, control, graphs)
            for w, x in zip(want, got):
                assert torch.equal(w, x)


@pytest.mark.parametrize("mode", MODES)
def test_graph_loop_equals_eager(mode, monkeypatch):
    """The graph path's static buffers, copies and record copy-out on the
    CPU, with each body run where a card would capture or replay it."""
    monkeypatch.setattr(encode.BodyGraphs, "_run",
                        lambda self, key, fn: fn())
    _graph_path_equals_eager(mode, 2, torch.device("cpu"),
                             encode.BodyGraphs())


@pytest.mark.card
@pytest.mark.parametrize("B", (2, 32))
@pytest.mark.parametrize("mode", MODES)
def test_graph_path_equals_eager(card, mode, B):
    graphs = encode.BodyGraphs()
    _graph_path_equals_eager(mode, B, card, graphs)
    assert graphs._graphs  # the bodies did run as graphs


def test_mixed_batch_streams_are_own_plan_encodes():
    """The port's batch of clips of different lengths
    (`mesh.encode_movies_mixed`, every movie padded to the longest and cut
    to its own ops) gives each clip the ops and the stream of its own-plan
    encode by the reference (`check.Setting.encode_each`, each clip alone
    under its own plan, with no padding), op for op and byte for byte."""
    cfg = harness.load_json(f"{harness.BENCH_DIR}/configs/"
                            "dhgr_ntsc_k16_j4.json")
    rng = np.random.default_rng(2 ** 31 + 29)
    ph = gen.phases(rng, 3)
    ins, movies, levels = [], [], []
    for i, seconds in enumerate((0.5, 1.3, 2.2)):  # 15, 39, 66 frames
        n_src = int(round(seconds * 30))
        pattern = gen.synth_movies_device(ph[i:i + 1], 12, "cpu")[0]
        enc = gen.rolled_encoded(pattern.numpy(), n_src, 2)
        src = np.zeros((n_src,) + enc.shape[1:], np.uint8)
        src[::2] = enc
        fr = p_frames.ingest(src, VideoMode.DHGR, Palette.NTSC,
                             every_n_video_frames=2, frame_rate=30.0)
        wave = gen.tones(rng, 1, seconds, 14700, (220, 880))[0]
        lv = np.asarray(p_audio.Audio(data=wave, rate=14700, bitrate=14700,
                                      device="cpu").levels())
        movies.append((fr.targets_main, fr.targets_aux, fr.n_frames_total,
                       len(lv)))
        levels.append(lv)
        ins.append(check.ClipIn(enc, wave, 2 ** 31 - 7 + i, n_src))
    dist = get_distance(VideoMode.DHGR, Palette.NTSC, device="cpu")
    flats, plan_max, n_ops = mesh.encode_movies_mixed(
        dist, movies, VideoMode.DHGR, 30.0, 14700.0, every_n_video_frames=2,
        k=16, j=4, seeds=[c.seed for c in ins])
    assert len(set(n_ops)) == 3 and plan_max.n_ops > max(n_ops[:2])
    st = check.Setting(cfg, "host", "cpu")
    targets = st.targets(ins)
    for c, t, m, flat, lv, (want, _, _) in zip(
            ins, targets, movies, flats, levels,
            st.encode_each(ins, targets)):
        assert np.array_equal(t[0], m[0]) and np.array_equal(t[1], m[1])
        assert st.plan(c).n_ops == len(flat) == len(want)
        assert np.array_equal(want, flat)
        assert st.stream(want, st.levels(c)) == emit_stream_fast(
            flat, lv[:len(flat)], VideoMode.DHGR)


def test_encode_each_groups_clips_by_plan(monkeypatch):
    """Clips of one plan are encoded together, in their order, and a clip
    of another length alone, each under its own plan."""
    cfg = harness.load_json(f"{harness.BENCH_DIR}/configs/"
                            "dhgr_ntsc_k16_j4.json")
    st = check.Setting(cfg, "host", "cpu")
    calls = []

    def fake(targets, seeds, plan, control=False):
        calls.append((list(seeds), plan.n_ops))
        return ([s for s in seeds], np.array(seeds), np.array(seeds))

    monkeypatch.setattr(st, "encode", fake)
    wave = np.zeros(4000, np.float32)
    clips = [check.ClipIn(None, wave, 1, 8), check.ClipIn(None, wave, 2, 5),
             check.ClipIn(None, wave, 3, 8), check.ClipIn(None, wave[:900],
                                                          4, 8)]
    out = st.encode_each(clips, [None] * 4)
    assert [o[0] for o in out] == [1, 2, 3, 4]
    assert calls == [([1, 3], st.plan(clips[0]).n_ops),
                     ([2], st.plan(clips[1]).n_ops),
                     ([4], st.plan(clips[3]).n_ops)]
    assert len({n for _, n in calls}) == 3
