"""iivision_tpu_torch end to end on the CPU: Movie against the JAX
package's Movie (DHGR and HGR; its file and its object-level stream), the
FFT resample against the JAX one, and the CLI (DHGR, HGR, the yiq and mono
colour models, and the `--mesh` clamp)."""

import json
import os

import numpy as np
import pytest
import torch

from iivision_tpu import audio as jaudio
from iivision_tpu.movie import Movie as JaxMovie
from iivision_tpu.movie import get_distance
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import audio as taudio
from iivision_tpu_torch import cli
from iivision_tpu_torch.movie import Movie
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.sim import PlayerVM
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_encoder import get_dist
from tests.test_pipeline import gradient_movie


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


def check_stream(data, movie, levels):
    """The player VM decodes the stream, its duty cycles are the audio
    levels and its final screens are the encoder's model (except the
    padding op's cell; HGR has no aux bank)."""
    res = PlayerVM().decode(data)
    assert res.ok, (res.error, res.error_pos)
    assert res.n_ops == movie.plan.n_ops
    assert np.array_equal(res.duty, levels[:movie.plan.n_ops] * 2 + 34)
    pairs = [(res.main, movie.final_main)]
    if movie.video_mode == VideoMode.DHGR:
        pairs.append((res.aux, movie.final_aux))
    for vm, model in pairs:
        eq = vm == np.asarray(model).astype(np.uint8)
        eq[0, 0] = True
        assert eq.all(), np.argwhere(~eq)[:5]


def test_movie_matches_jax_movie(tmp_path):
    """A 4-frame gradient clip with 14,700 Hz audio (levels need no
    resample, so they are exact) gives a byte-identical .a2m through both
    packages' Movie."""
    check_movie_matches_jax(tmp_path, VideoMode.DHGR)


def test_hgr_movie_matches_jax_movie(tmp_path):
    """The same clip in HGR: one bank, 8-bit bytes, whole-frame chunks."""
    check_movie_matches_jax(tmp_path, VideoMode.HGR)


def check_movie_matches_jax(tmp_path, mode, palette=Palette.NTSC, k=8, j=1,
                            seed=0, colour_model="window",
                            joint_content=False):
    """The 4-frame gradient clip through both packages' Movie at one
    setting (the JAX distance model from `get_distance`): equal .a2m
    bytes, op counts and final screens, and the port's stream plays in
    its player VM (`check_stream`)."""
    rgb = gradient_movie(F=4)
    tone = (np.sin(2 * np.pi * 440 * np.arange(4410) / 4410)
            * 16000).astype(np.float32)
    kw = dict(frames_source=rgb, every_n_video_frames=2, k=k, j=j,
              seed=seed, colour_model=colour_model,
              joint_content=joint_content)
    jpal = JPalette[palette.name]
    jmov = JaxMovie(audio_source=jaudio.Audio(data=tone, rate=14700,
                                              bitrate=14700),
                    dist=get_distance(jm(mode), jpal, colour_model),
                    video_mode=jm(mode), palette=jpal, **kw)
    tm = Movie(audio_source=taudio.Audio(data=tone, rate=14700,
                                         bitrate=14700, device="cpu"),
               device="cpu", video_mode=mode, palette=palette, **kw)
    p_jax, p_torch = str(tmp_path / "jax.a2m"), str(tmp_path / "torch.a2m")
    jmov.transcode(p_jax)
    stats = tm.transcode(p_torch)
    data = open(p_torch, "rb").read()
    assert data == open(p_jax, "rb").read()
    assert stats["n_ops"] == tm.plan.n_ops == jmov.plan.n_ops > 0
    assert np.array_equal(tm.final_main, np.asarray(jmov.final_main))
    assert np.array_equal(tm.final_aux, np.asarray(jmov.final_aux))
    check_stream(data, tm, tm.audio.levels())


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
def test_emit_stream_equals_the_file(tmp_path, mode):
    """Movie.emit_stream, the object-level stream through StreamFramer
    (encoder.ops_to_ticks), gives the bytes Movie.transcode writes with
    the C++ emitter, and the JAX package's Movie.emit_stream."""
    rgb = gradient_movie(F=4)
    tone = (np.sin(2 * np.pi * 440 * np.arange(4410) / 4410)
            * 16000).astype(np.float32)
    kw = dict(frames_source=rgb, every_n_video_frames=2, k=8, seed=3)
    tm = Movie(audio_source=taudio.Audio(data=tone, rate=14700,
                                         bitrate=14700, device="cpu"),
               device="cpu", video_mode=mode, **kw)
    chunks = list(tm.emit_stream())
    assert len(chunks) > 1 and all(isinstance(c, bytes) for c in chunks)
    path = str(tmp_path / "torch.a2m")
    tm.transcode(path)
    data = b"".join(chunks)
    assert data == open(path, "rb").read()
    jmov = JaxMovie(audio_source=jaudio.Audio(data=tone, rate=14700,
                                              bitrate=14700),
                    dist=get_dist(jm(mode)), video_mode=jm(mode), **kw)
    assert data == b"".join(jmov.emit_stream())


def test_resample_fft_matches_jax():
    """torch.fft against jnp.fft on 1 s of 44.1 kHz audio resampled to
    14,700 Hz.  complex64 FFTs in two libraries sum in different orders,
    so samples agree to 1e-3 of the peak; levels are truncated integers,
    so at most 0.1% of them may differ, each by at most 1."""
    rng = np.random.RandomState(0)
    t = np.arange(44100) / 44100.0
    x = (np.sin(2 * np.pi * 440 * t) * 9000 + np.sin(2 * np.pi * 3100 * t)
         * 4000 + rng.randn(44100) * 800).astype(np.float32)
    ref = np.asarray(jaudio.resample_fft(x, 44100, 14700))
    got = taudio.resample_fft(x, 44100, 14700, "cpu").numpy()
    assert got.shape == ref.shape == (14700,)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()

    lv_ref = jaudio.Audio(data=x, rate=44100, bitrate=14700).levels()
    lv = taudio.Audio(data=x, rate=44100, bitrate=14700,
                      device="cpu").levels()
    assert lv.shape == lv_ref.shape
    diff = np.abs(lv.astype(np.int64) - lv_ref)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 0.001 * len(lv)


@pytest.mark.parametrize("extra,flag", [
    (["--mesh", "2"], "--mesh"),
    (["b.npy", "--mesh", "4"], "--mesh"),
])
def test_cli_refuses_unported_flags(monkeypatch, extra, flag):
    """--mesh is ported (iivision_tpu/cli.py `_group_mesh`): a solo input
    is a group of one and runs unsharded, and a group's mesh is the
    request clamped to the host's cards and then to the largest divisor of
    the group's size; 'auto' is every card, one for the CPU."""
    args = cli.build_parser().parse_args(["a.npy"] + extra
                                         + ["--device", "cpu"])
    got = cli._group_mesh(getattr(args, flag[2:]), len(args.input),
                          args.device)
    assert got == (None if len(args.input) == 1
                   else (torch.device("cpu"),) * 2)
    cpu = torch.device("cpu")
    for arg, size, n in (("4", 6, 3), ("5", 4, 4), ("3", 4, 2), ("7", 7, 7),
                         ("2", 3, 1), ("auto", 4, 1), (None, 4, 1)):
        want = None if n == 1 else (cpu,) * n
        assert cli._group_mesh(arg, size, "cpu") == want, (arg, size)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert cli._group_mesh("auto", 4, "cuda") == cards
    assert cli._group_mesh("8", 6, "cuda") == cards
    assert cli._group_mesh("auto", 3, "cuda") is None


def test_cli_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = str(tmp_path / "clip.npy")
    np.save(clip, gradient_movie(F=2))
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main([clip, "--device", "cuda"])
    with pytest.raises(RuntimeError, match="is_available"):
        Movie(frames_source=gradient_movie(F=2), device="cuda")


def test_cli_transcodes_on_cpu(tmp_path, capsys):
    clip = str(tmp_path / "clip.npy")
    np.save(clip, gradient_movie(F=6))
    out = str(tmp_path / "clip.a2m")
    stats_path = str(tmp_path / "stats.json")
    cli.main([clip, "--device", "cpu", "--output", out, "--k", "16", "--j",
              "4", "--stats_json", stats_path])
    assert "Wrote %s" % out in capsys.readouterr().out
    stats = json.load(open(stats_path))[0]
    assert stats["device"] == "cpu" and stats["n_ops"] > 0
    res = PlayerVM().decode(open(out, "rb").read())
    assert res.ok and res.n_ops == stats["n_ops"]
    assert os.path.getsize(out) % 2048 == 0


@pytest.mark.parametrize("extra", [
    ["--video_mode", "HGR"],
    ["--colour_model", "yiq"],
    ["--colour_model", "mono"],
])
def test_cli_transcodes_mode_and_model_on_cpu(tmp_path, monkeypatch, extra):
    """HGR and the yiq and mono colour models through the CLI (mono picks
    the 1-bit mono dither and builds its store-cost table into the user
    cache); the player VM plays each stream."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    clip = str(tmp_path / "clip.npy")
    np.save(clip, gradient_movie(F=4))
    out = str(tmp_path / "clip.a2m")
    stats_path = str(tmp_path / "stats.json")
    cli.main([clip, "--device", "cpu", "--output", out, "--stats_json",
              stats_path] + extra)
    stats = json.load(open(stats_path))[0]
    res = PlayerVM().decode(open(out, "rb").read())
    assert res.ok and res.n_ops == stats["n_ops"] > 0
    if extra[-1] == "mono":
        assert os.listdir(tmp_path / "iivision_tpu" / "store_cost") == [
            "v1_DHGR_NTSC_mono.npz"]
