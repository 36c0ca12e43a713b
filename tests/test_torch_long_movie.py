"""The long-movie path of iivision_tpu_torch on the CPU: the resumable
encode (`encode_segment`), `encode_movie_chunked` and
`encode_movie_streaming` against the port's whole-movie encode and the JAX
package's chunked and streaming encoders, `frames.ingest_stream_array`
against the JAX generator, and `Movie`'s choice between the encoders
(in-memory and file sources, `STREAM_MIN_FRAMES`, `chunk_frames=`,
`dist=`) and the CLI's `--chunk_frames`.  Everything here is exact
(`np.array_equal`, equal bytes)."""

import functools

import numpy as np
import pytest

from iivision_tpu import audio as jaudio
from iivision_tpu import encoder as jenc
from iivision_tpu import frames as jframes
from iivision_tpu.movie import Movie as JaxMovie
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import audio as taudio
from iivision_tpu_torch import cli, encoder, frames
from iivision_tpu_torch import movie as tmovie
from iivision_tpu_torch.movie import Movie
from iivision_tpu_torch.ops import distance
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_encoder import get_dist, random_frames
from tests.test_pipeline import gradient_movie

DHGR, HGR = VideoMode.DHGR, VideoMode.HGR


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


@functools.lru_cache(None)
def torch_dist(mode, model="window"):
    return distance.ComputedDistance(mode, Palette.NTSC, model, device="cpu")


def whole_movie(fmain, faux, plan, mode, seed, joint=False):
    """The port's unsegmented encode as numpy (ops, main, aux)."""
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, mode, "cpu")
    return tuple(t.numpy() for t in encoder.encode_movie(
        torch_dist(mode), lanes, bytes_tgt, plan, mode, seed=seed,
        joint=joint))


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g, w)


# --- streaming --------------------------------------------------------------

@functools.lru_cache(None)
def streaming_inputs():
    main, aux = random_frames(JVideoMode.DHGR, 11, seed=3)
    plan, n_enc = jenc.plan_movie(
        n_frames=11, n_audio_ticks=4500, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1,
        mode=JVideoMode.DHGR, k=4, j=2)
    assert n_enc == 11
    return main, aux, plan, whole_movie(main, aux, plan, DHGR, 5)


def batches(main, aux, sizes):
    pos = 0
    for b in sizes:
        yield main[pos:pos + b], None if aux is None else aux[pos:pos + b]
        pos += b


@pytest.mark.parametrize("sizes", [(3, 3, 3, 2), (1,) * 11, (11,), (5, 6)])
def test_streaming_matches_unchunked_and_jax(sizes):
    """However the target stream is batched, the streaming encode equals
    the whole-movie encode and the JAX package's streaming encode, and
    hands back the targets it pulled."""
    main, aux, plan, ref = streaming_inputs()
    got = encoder.encode_movie_streaming(
        torch_dist(DHGR), batches(main, aux, sizes), plan, DHGR, seed=5,
        chunk_frames=4)
    assert_same(got[:3], ref)
    assert np.array_equal(got[3], main) and np.array_equal(got[4], aux)
    want = jenc.encode_movie_streaming(
        get_dist(JVideoMode.DHGR), batches(main, aux, sizes), plan,
        JVideoMode.DHGR, seed=5, chunk_frames=4)
    assert_same(got, want)


def test_streaming_short_stream_raises():
    """A stream that ends short raises, as the JAX function does."""
    main, aux, plan, _ = streaming_inputs()
    with pytest.raises(ValueError, match="4 frames short"):
        encoder.encode_movie_streaming(
            torch_dist(DHGR), batches(main, aux, (4,)), plan, DHGR, seed=5,
            chunk_frames=4)


def test_streaming_hgr_has_no_aux_targets():
    main, _ = random_frames(JVideoMode.HGR, 5, seed=4)
    plan, _ = jenc.plan_movie(
        n_frames=5, n_audio_ticks=2000, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1,
        mode=JVideoMode.HGR, k=4, j=1)
    got = encoder.encode_movie_streaming(
        torch_dist(HGR), batches(main, None, (2, 3)), plan, HGR, seed=1,
        chunk_frames=2)
    assert_same(got[:3], whole_movie(main, None, plan, HGR, 1))
    assert np.array_equal(got[3], main) and got[4] is None
    assert_same(got[:4], jenc.encode_movie_streaming(
        get_dist(JVideoMode.HGR), batches(main, None, (2, 3)), plan,
        JVideoMode.HGR, seed=1, chunk_frames=2)[:4])


# --- the resumable encode ---------------------------------------------------

@pytest.mark.parametrize("fn", ["chunked", "streaming"])
def test_chunk_frames_must_be_positive(fn):
    main, aux, plan, _ = streaming_inputs()
    with pytest.raises(ValueError, match="chunk_frames must be positive"):
        if fn == "chunked":
            encoder.encode_movie_chunked(torch_dist(DHGR), main, aux, plan,
                                         DHGR, chunk_frames=0)
        else:
            encoder.encode_movie_streaming(
                torch_dist(DHGR), batches(main, aux, (11,)), plan, DHGR,
                chunk_frames=-1)


def test_segment_bounds_are_checked():
    """A segment that starts inside a body, or whose targets do not hold
    its frames, raises; segment ranges are the JAX package's."""
    main, aux, plan, _ = streaming_inputs()
    ranges = encoder.segment_ranges(plan, 4)
    assert [r[:2] for r in ranges] == [(0, 4), (4, 8), (8, 11)]
    assert ranges[0][2] == 0 and ranges[-1][3] == len(plan.step_frame)
    assert all(a[3] == b[2] for a, b in zip(ranges, ranges[1:]))
    state = encoder.new_state(torch_dist(DHGR), plan, DHGR, [5], 1)
    lanes, bytes_tgt = encoder.prepare_targets(main[:4], aux[:4], DHGR, "cpu")
    s1 = ranges[0][3]
    with pytest.raises(ValueError, match="body boundary"):
        encoder.encode_segment(state, lanes[None], bytes_tgt[None], 0, 1, s1)
    with pytest.raises(ValueError, match="targets hold 0 .. 3"):
        encoder.encode_segment(state, lanes[None], bytes_tgt[None], 0, 0,
                               ranges[1][3])
    with pytest.raises(ValueError, match="2 seeds for 1 movies"):
        encoder.new_state(torch_dist(DHGR), plan, DHGR, [1, 2], 1)


def test_encode_segment_resumes_with_segment_targets():
    """Two `encode_segment` calls, each with its own frames only, leave
    the state of the one-segment call."""
    main, aux, plan, ref = streaming_inputs()
    (f0, f1, s0, s1), (g0, g1, t0, t1) = encoder.segment_ranges(plan, 6)
    state = encoder.new_state(torch_dist(DHGR), plan, DHGR, [5], 1)
    for lo, hi, a, b in ((f0, f1, s0, s1), (g0, g1, t0, t1)):
        lanes, bytes_tgt = encoder.prepare_targets(main[lo:hi], aux[lo:hi],
                                                   DHGR, "cpu")
        encoder.encode_segment(state, lanes[None], bytes_tgt[None], lo, a, b)
    assert_same([t[0].numpy() for t in state.result()], ref)


# --- ingest_stream_array ----------------------------------------------------

@pytest.mark.parametrize("mode", [DHGR, HGR])
@pytest.mark.parametrize("batch", [None, 1, 4, 64])
def test_ingest_stream_array_matches_jax_and_ingest(mode, batch):
    """An in-memory 280x192 clip, every 2nd frame: the generator's batches
    are the JAX generator's, and their concatenation is `frames.ingest`'s
    targets."""
    rgb = gradient_movie(F=21, h=192, w=280)
    got = list(frames.ingest_stream_array(rgb, mode, Palette.NTSC, 2,
                                          batch=batch))
    want = list(jframes.ingest_stream_array(rgb, jm(mode), JPalette.NTSC, 2,
                                            batch=batch))
    assert [len(m) for m, _ in got] == [len(m) for m, _ in want]
    assert len(got[0][0]) == (8 if batch is None else min(batch, 11))
    for (gm, ga), (wm, wa) in zip(got, want):
        assert gm.dtype == np.uint8 and np.array_equal(gm, wm)
        if mode == DHGR:
            assert np.array_equal(ga, wa)
        else:
            assert ga is None and wa is None
    whole = frames.ingest(rgb, mode, Palette.NTSC, every_n_video_frames=2)
    assert np.array_equal(np.concatenate([m for m, _ in got]),
                          whole.targets_main)
    if mode == DHGR:
        assert np.array_equal(np.concatenate([a for _, a in got]),
                              whole.targets_aux)


def test_ingest_stream_array_refuses_a_bad_batch():
    with pytest.raises(ValueError, match="batch must be positive"):
        next(frames.ingest_stream_array(gradient_movie(F=2), DHGR,
                                        Palette.NTSC, batch=0))


# --- Movie and the CLI ------------------------------------------------------

def tone_audio(device=None):
    tone = (np.sin(2 * np.pi * 330 * np.arange(6000) / 6000)
            * 12000).astype(np.float32)
    kw = dict(data=tone, rate=14700, bitrate=14700)
    return jaudio.Audio(**kw) if device is None else taudio.Audio(
        device=device, **kw)


def transcode(tmp_path, name, **kw):
    m = Movie(audio_source=tone_audio("cpu"), device="cpu",
              every_n_video_frames=2, k=8, **kw)
    path = str(tmp_path / name)
    m.transcode(path)
    return m, open(path, "rb").read()


@pytest.mark.parametrize("mode", [DHGR, HGR])
def test_movie_stream_source_matches_file_source_and_jax(tmp_path, mode):
    """An in-memory source is ingested inside encode_ops
    (`ingest_stream_array`); a .npz source through `frames.ingest`.  Both
    give the JAX Movie's bytes (the counterpart of
    tests/test_pipeline.py's stream-path test)."""
    rgb = gradient_movie(F=6)
    m_stream, data = transcode(tmp_path, "stream.a2m", frames_source=rgb,
                               video_mode=mode, dist=torch_dist(mode))
    assert m_stream._stream_source is not None
    assert m_stream.encoder_used == "whole"
    assert m_stream.frames.targets_main.shape == (3, 32, 256)

    np.savez(str(tmp_path / "clip.npz"), frames=rgb, frame_rate=30.0)
    m_file, data_file = transcode(tmp_path, "file.a2m",
                                  filename=str(tmp_path / "clip.npz"),
                                  video_mode=mode, dist=torch_dist(mode))
    assert m_file._stream_source is None and data_file == data

    jmov = JaxMovie(frames_source=rgb, audio_source=tone_audio(),
                    every_n_video_frames=2, k=8, video_mode=jm(mode),
                    dist=get_dist(jm(mode)))
    jmov.transcode(str(tmp_path / "jax.a2m"))
    assert open(str(tmp_path / "jax.a2m"), "rb").read() == data


def test_movie_chunk_frames_gives_the_same_bytes(tmp_path):
    rgb = gradient_movie(F=10)
    kw = dict(frames_source=rgb, video_mode=DHGR, dist=torch_dist(DHGR))
    m_whole, want = transcode(tmp_path, "whole.a2m", **kw)
    m, got = transcode(tmp_path, "chunked.a2m", chunk_frames=2, **kw)
    assert m._stream_source is None and m.encoder_used == "chunked"
    assert got == want
    assert np.array_equal(m.final_main, m_whole.final_main)
    assert np.array_equal(m.final_aux, m_whole.final_aux)


def test_movie_chunk_frames_zero_raises(tmp_path):
    with pytest.raises(ValueError, match="chunk_frames must be positive"):
        transcode(tmp_path, "bad.a2m", frames_source=gradient_movie(F=4),
                  dist=torch_dist(DHGR), chunk_frames=0)


def test_movie_keeps_the_distance_model_it_is_given():
    d = torch_dist(DHGR)
    m = Movie(frames_source=gradient_movie(F=2), device="cpu", dist=d,
              audio_source=tone_audio("cpu"))
    assert m.dist is d

    class MetaDist:
        device = "meta"

    with pytest.raises(ValueError, match="distance model on meta"):
        Movie(frames_source=gradient_movie(F=2), device="cpu", dist=MetaDist,
              audio_source=tone_audio("cpu"))
    got = tmovie.get_distance(DHGR, Palette.NTSC, device="cpu")
    assert got.device.type == "cpu"
    assert np.array_equal(got.store_cost16.numpy(), d.store_cost16.numpy())


def test_cli_chunk_frames_writes_the_same_file(tmp_path):
    clip = str(tmp_path / "clip.npz")
    np.savez(clip, frames=gradient_movie(F=10), frame_rate=30.0)
    outs = []
    for extra in ([], ["--chunk_frames", "2"]):
        out = str(tmp_path / ("out%d.a2m" % len(outs)))
        cli.main([clip, "--device", "cpu", "--output", out, "--k", "16",
                  "--j", "4"] + extra)
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and len(outs[0]) % 2048 == 0
