"""The port's host-side gap fillers on the CPU against the JAX package:
`render` and `quality.stream_psnr` (numpy, exact), the render and quality
checks of tests/test_render_quality.py on the port's `Movie`,
`ops.editdist.load_tables`, `audio.resample_polyphase`,
`frames.resize_frame` and `frames.reference_cache_dir` (all exact), and
`ops.dither.frame_to_memory`, whose ordered and HGR quantizers are float32
Lab argmins held to tests/test_torch_ingest.py's ceiling (0.5% of values;
measured here: 0)."""

import os

import numpy as np
import pytest
import torch

from iivision_tpu import audio as jaudio
from iivision_tpu import frames as jframes
from iivision_tpu import quality as jquality
from iivision_tpu.ops import dither as jdither
from iivision_tpu.ops import editdist as jed
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import audio, encoder, frames, quality, render
from iivision_tpu_torch.movie import Movie
from iivision_tpu_torch.ops import distance, dither, editdist
from iivision_tpu_torch.palettes import Palette, palette_rgb_array
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_pipeline import gradient_movie
from tests.test_torch_ingest import CODE_MISMATCH_CEILING

DHGR, HGR = VideoMode.DHGR, VideoMode.HGR


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


def screens(mode, seed, n=2):
    rng = np.random.RandomState(seed)
    hi = 0x80 if mode == DHGR else 0x100
    return (rng.randint(0, hi, (n, 32, 256)).astype(np.uint8),
            rng.randint(0, hi, (n, 32, 256)).astype(np.uint8))


# --- render -----------------------------------------------------------------

def test_dhgr_render_roundtrip():
    """Codes -> memory (the port's packing) -> render recovers the codes,
    and a solid colour renders as its palette entry."""
    codes = np.random.RandomState(0).randint(0, 16, (192, 140)).astype(
        np.int32)
    main, aux = dither.dhgr_codes_to_memory(torch.as_tensor(codes))
    assert np.array_equal(
        render.dhgr_screen_codes(main.numpy(), aux.numpy()), codes)
    main, aux = dither.dhgr_codes_to_memory(
        torch.full((192, 140), 12, dtype=torch.int32))
    rgb = render.screen_to_rgb(main.numpy(), aux.numpy(), DHGR, Palette.NTSC)
    assert np.allclose(rgb, palette_rgb_array(Palette.NTSC)[12])


def test_hgr_render_solid_colours():
    main = np.full((32, 256), 0x7F, np.uint8)
    assert (render.hgr_screen_codes(main) == 0b1111).mean() > 0.95
    assert np.all(render.hgr_screen_codes(np.zeros((32, 256), np.uint8)) == 0)
    violet = torch.full((192, 140), 0b0011, dtype=torch.int32)
    mem = dither.hgr_bytes_to_memory(dither.hgr_dots_to_bytes(
        dither.hgr_desired_dots(violet))).numpy()
    assert (render.hgr_screen_codes(mem) == 0b0011).mean() > 0.9


def test_psnr_basics():
    """The counterpart of tests/test_render_quality.py's test."""
    a = np.zeros((10, 10, 3))
    assert render.psnr(a, a) == float("inf")
    assert abs(render.psnr(a, a + 10.0) - (20 * np.log10(255 / 10))) < 1e-6


@pytest.mark.parametrize("mode", [DHGR, HGR])
@pytest.mark.parametrize("palette", [Palette.NTSC, Palette.IIGS])
def test_stream_psnr_matches_jax(mode, palette):
    main, aux = screens(mode, 5)
    src = np.random.RandomState(6).randint(0, 256, (2, 192, 140, 3))
    got = quality.stream_psnr(main, aux, src, mode, palette)
    want = jquality.stream_psnr(main, aux, src, jm(mode),
                                JPalette[palette.name])
    assert np.isfinite(got) and got == want
    rgb = render.screen_to_rgb(main, aux, mode, palette)
    assert quality.stream_psnr(main, aux, rgb, mode, palette) == float("inf")


def test_quality_end_to_end_converged():
    """The counterpart of tests/test_render_quality.py's test on the
    port's Movie: at about one frame a second the replay error converges
    and the final screen renders as the last target does."""
    rgb = gradient_movie(F=2)
    aud = audio.Audio(data=np.zeros(29000, np.float32), rate=14700,
                      bitrate=14700, normalization=1.0, device="cpu")
    dist = distance.ComputedDistance(DHGR, Palette.NTSC, device="cpu")
    m = Movie(frames_source=rgb, audio_source=aud, every_n_video_frames=1,
              video_mode=DHGR, dist=dist, k=8, frame_rate=1.0, device="cpu")
    flat, _ = m.encode_ops()
    lanes_tgt, _ = encoder.prepare_targets(
        m.frames.targets_main, m.frames.targets_aux, DHGR, "cpu")
    rep = quality.replay_frame_errors(flat, m.plan, lanes_tgt, DHGR, m.dist)
    assert len(rep.frame_errors) == 2
    assert rep.final_error < 1.0
    tgt_rgb = render.screen_to_rgb(m.frames.targets_main[-1],
                                   m.frames.targets_aux[-1], DHGR,
                                   Palette.NTSC)
    assert quality.stream_psnr(m.final_main, m.final_aux, tgt_rgb, DHGR,
                               Palette.NTSC) > 30.0


# --- the smaller gaps -------------------------------------------------------

def test_load_tables_round_trip_and_jax(tmp_path, monkeypatch):
    """`load_tables` gives back the symmetric tables `save_tables` wrote,
    and what the JAX `load_tables` reads from the same file (a 5-bit
    stand-in spec in both modules: the full tables are 512 MB)."""
    class Small:
        NAME = "DHGR"
        MASKED_BITS = 5

    monkeypatch.setattr(editdist, "spec_for_mode", lambda mode: Small)
    monkeypatch.setattr(jed.screen, "spec_for_mode", lambda mode: Small)
    half = np.random.RandomState(7).randint(0, 999, (4, 32, 32))
    sym = np.triu(half, 1)
    sym = (sym + sym.transpose(0, 2, 1)).astype(np.uint16).reshape(4, -1)
    path = editdist.save_tables(sym, DHGR, Palette.NTSC, str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    got = editdist.load_tables(DHGR, Palette.NTSC, str(tmp_path))
    assert got.dtype == np.uint16 and np.array_equal(got, sym)
    assert np.array_equal(got, jed.load_tables(JVideoMode.DHGR, JPalette.NTSC,
                                               str(tmp_path)))


@pytest.mark.parametrize("ratio,n", [(3, 44100), (2, 9999), (1, 500)])
def test_resample_polyphase_matches_jax(ratio, n):
    rng = np.random.RandomState(ratio)
    x = (np.sin(np.arange(n) / 7.0) * 9000 + rng.randn(n) * 500).astype(
        np.float32)
    got = audio.resample_polyphase(x, ratio)
    want = jaudio.resample_polyphase(x, ratio)
    assert got.dtype == np.float32 and got.shape == (int(round(n / ratio)),)
    assert np.array_equal(got, want)
    d = audio.StreamingDecimator(ratio)
    parts = [d.feed(x[:n // 3]), d.feed(x[n // 3:]), d.flush(n)]
    assert np.array_equal(np.concatenate(parts), got)


@pytest.mark.parametrize("h,w", [(192, 280), (240, 320), (192, 140)])
def test_resize_frame_matches_jax(h, w):
    rgb = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    got = frames.resize_frame(rgb)
    assert got.shape == (192, 140, 3) and got.dtype == np.uint8
    assert np.array_equal(got, jframes.resize_frame(rgb))


def test_reference_cache_dir_matches_jax():
    for mode in (DHGR, HGR):
        got = frames.reference_cache_dir("/clips/a.b/movie.mp4", mode,
                                         Palette.IIGS)
        assert got == jframes.reference_cache_dir(
            "/clips/a.b/movie.mp4", jm(mode), JPalette.IIGS)
        assert got == "/clips/a.b/movie/%s/IIGS" % mode.name


@pytest.mark.parametrize("mode,dither_mode", [(DHGR, "ordered"),
                                              (HGR, "ordered"),
                                              (DHGR, "atkinson")])
def test_frame_to_memory_within_pinned_mismatch(mode, dither_mode):
    """One frame through the port's device quantizers (on the CPU)
    against the JAX function; the error-diffusion path is C++ on the host
    in both and exact."""
    rgb = np.random.RandomState(12).randint(0, 256, (192, 140, 3)).astype(
        np.uint8)
    got = dither.frame_to_memory(rgb, mode, Palette.NTSC, dither_mode,
                                 device="cpu")
    want = jdither.frame_to_memory(rgb, jm(mode), JPalette.NTSC, dither_mode)
    ceiling = CODE_MISMATCH_CEILING if dither_mode == "ordered" else 0.0
    for g, w in zip(got, want):
        if w is None:
            assert g is None and mode == HGR
            continue
        assert g.dtype == torch.uint8 and g.shape == (32, 256)
        assert (g.numpy() != np.asarray(w)).mean() <= ceiling
