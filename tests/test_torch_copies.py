"""iivision_tpu_torch keeps its own copies of the JAX package's host-side
tables and functions (it imports nothing of the JAX package).  Each copy
gives what the original gives, exactly: screen tables and specs, the plan,
stream emission and opcode addresses, palettes, colour codes and the
nominal-colour helpers, the scalar edit-distance oracles, the
dither tables and host quantizers, resize, host ingest, audio levels, op
replay, the yiq tables, the renderer and the player VM; and each native
C++ source under `sim/csrc/` is the original byte for byte."""

import os

import numpy as np
import pytest
import torch

from iivision_tpu import audio as jaudio
from iivision_tpu import cli as jcli
from iivision_tpu import colours as jcolours
from iivision_tpu import encoder as jenc
from iivision_tpu import frames as jframes
from iivision_tpu import palettes as jpalettes
from iivision_tpu import quality as jquality
from iivision_tpu import render as jrender
from iivision_tpu import screen as jscreen
from iivision_tpu.ops import distance as jdist
from iivision_tpu.ops import dither as jdither
from iivision_tpu.ops import editdist as jed
from iivision_tpu.ops import resize as jresize
from iivision_tpu.ops import yiq as jyiq
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.sim import PlayerVM as JPlayerVM
from iivision_tpu.sim import native as jnative
from iivision_tpu.stream.emit_fast import emit_stream_fast as j_emit
from iivision_tpu.stream.opcodes import default_addresses as j_addresses
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import audio, cli, colours, encoder, frames, palettes
from iivision_tpu_torch import quality
from iivision_tpu_torch import render, screen
from iivision_tpu_torch.ops import distance, dither, editdist, resize, yiq
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.sim import PlayerVM
from iivision_tpu_torch.sim import native
from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
from iivision_tpu_torch.stream.opcodes import default_addresses
from iivision_tpu_torch.video_mode import VideoMode

MODES = [VideoMode.DHGR, VideoMode.HGR]
PALETTES = [Palette.NTSC, Palette.IIGS]


def jm(mode):
    """The JAX package's member of the port's VideoMode or Palette."""
    return (JVideoMode if isinstance(mode, VideoMode) else JPalette)[
        mode.name]


def test_enum_values():
    assert [(m.name, m.value) for m in VideoMode] == [
        (m.name, m.value) for m in JVideoMode]
    assert [(p.name, p.value) for p in Palette] == [
        (p.name, p.value) for p in JPalette]


def test_screen_tables():
    for name in ("SCREEN_HOLES", "X_Y_TO_PAGE", "X_Y_TO_OFFSET"):
        got, want = getattr(screen, name), getattr(jscreen, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for page in (0, 1):
        assert [screen.y_to_base_addr(y, page) for y in range(192)] == \
            jscreen.Y_TO_BASE_ADDR[page]


@pytest.mark.parametrize("mode", MODES)
def test_spec_constants_and_updates(mode):
    got, want = screen.spec_for_mode(mode), jscreen.spec_for_mode(jm(mode))
    for name in ("NAME", "MASKED_BITS", "MASKED_DOTS", "N_LANES", "PHASES"):
        assert getattr(got, name) == getattr(want, name), name
    banks = (False, True) if mode == VideoMode.DHGR else (False,)
    assert [got.bank_lanes(a) for a in banks] == \
        [want.bank_lanes(a) for a in banks]
    rng = np.random.RandomState(1)
    vals = rng.randint(0, 1 << got.MASKED_BITS, 500)
    content = rng.randint(0, 256, 500)
    for lane in range(got.N_LANES):
        if mode == VideoMode.DHGR:
            a, b = got.masked_update(vals, content), \
                want.masked_update(vals, content)
        else:
            a, b = got.masked_update(vals, content, lane), \
                want.masked_update(vals, content, lane)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("lane", [0, 1])
def test_hgr_to_dots(lane):
    vals = np.random.RandomState(2).randint(0, 1 << 14, 4000)
    want = jscreen.hgr_to_dots(vals, lane)
    assert np.array_equal(screen.hgr_to_dots(vals, lane), want)
    assert np.array_equal(
        screen.hgr_to_dots(torch.as_tensor(vals, dtype=torch.int32),
                           lane).numpy(), want)


@pytest.mark.parametrize("n_frames,ticks,fps,tps,every_n,mode,k,j", [
    (2, 1200, 12.0, 14700.0, 1, VideoMode.DHGR, 8, 1),
    (300, 147000, 30.0, 14700.0, 2, VideoMode.DHGR, 16, 4),
    (40, 20000, 30.0, 14700.0, 2, VideoMode.HGR, 8, 1),
    (3, 2000, 1.0, 350.0, 1, VideoMode.DHGR, 4, 3),
])
def test_plan_movie(n_frames, ticks, fps, tps, every_n, mode, k, j):
    kw = dict(n_frames=n_frames, n_audio_ticks=ticks, input_frame_rate=fps,
              ticks_per_second=tps, every_n_video_frames=every_n, k=k, j=j)
    got, n = encoder.plan_movie(mode=mode, **kw)
    want, jn = jenc.plan_movie(mode=jm(mode), **kw)
    assert n == jn
    for f in ("n_ops", "k", "j", "chunk_steps"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("step_frame", "step_bank", "step_recompute", "step_nvalid",
              "op_tick_index"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    ops = np.random.RandomState(3).randint(
        0, 256, (len(got.step_frame), k * j, 6)).astype(np.uint8)
    assert np.array_equal(encoder.flatten_ops(ops, got),
                          jenc.flatten_ops(ops, want))


@pytest.mark.parametrize("mode,n,cap", [
    (VideoMode.DHGR, 1500, None), (VideoMode.HGR, 700, None),
    (VideoMode.DHGR, 1500, 5000), (VideoMode.DHGR, 0, None)])
def test_emit_stream_fast_bytes(mode, n, cap):
    rng = np.random.RandomState(4)
    flat = np.concatenate([rng.randint(32, 64, (n, 1)),
                           rng.randint(0, 256, (n, 5))], axis=1)
    levels = rng.randint(-15, 17, n)
    got = emit_stream_fast(flat, levels, mode, max_bytes_out=cap)
    assert got == j_emit(flat, levels, jm(mode), max_bytes_out=cap)
    assert len(got) % 2048 == 0


def test_opcode_addresses():
    got, want = default_addresses(), j_addresses()
    assert (got.header, got.terminate, got.nop, got.ack) == \
        (want.header, want.terminate, want.nop, want.ack)
    assert got.tick == want.tick


@pytest.mark.parametrize("palette", PALETTES)
def test_palettes_and_costs(palette):
    assert np.array_equal(palettes.palette_rgb_array(palette),
                          jpalettes.palette_rgb_array(jm(palette)))
    assert np.array_equal(palettes.diff_matrix(palette),
                          jpalettes.diff_matrix(jm(palette)))
    assert np.array_equal(editdist.substitute_matrix(palette),
                          jed.substitute_matrix(jm(palette)))
    assert np.array_equal(distance.sub16(palette), jdist.sub16(jm(palette)))
    rgb = np.random.RandomState(5).randint(0, 256, (64, 3))
    assert np.array_equal(palettes.srgb_to_lab(rgb),
                          jpalettes.srgb_to_lab(rgb))
    assert np.array_equal(dither._palette_lab(palette),
                          jdither._palette_lab(jm(palette)))


def test_distance_helpers():
    assert np.array_equal(distance.sub16_mono(), jdist.sub16_mono())
    assert distance._user_cache_dir() == jdist._user_cache_dir()
    for mode in MODES:
        assert distance.n_contents(mode) == jdist.n_contents(jm(mode))
        for pal in PALETTES:
            for model in ("window", "yiq", "mono"):
                assert distance.store_cost_path(mode, pal, model) == \
                    jdist.store_cost_path(jm(mode), jm(pal), model)
    assert cli._default_out("dir/clip.mp4") == \
        jcli._default_out("dir/clip.mp4") == "dir/clip.a2m"


@pytest.mark.parametrize("mode,lane", [(VideoMode.DHGR, 0),
                                       (VideoMode.DHGR, 3),
                                       (VideoMode.HGR, 1)])
def test_lane_pixel_codes_and_scalar_oracle(mode, lane):
    codes = editdist.lane_pixel_codes(mode, lane)
    assert codes.dtype == np.uint8
    assert np.array_equal(codes, jed.lane_pixel_codes(jm(mode), lane))
    sub = editdist.substitute_matrix(Palette.NTSC)
    rng = np.random.RandomState(6)
    for i, jx in rng.randint(0, len(codes), (6, 2)):
        a, b = list(codes[i]), list(codes[jx])
        assert editdist.dam_lev_scalar(a, b, sub) == \
            jed.dam_lev_scalar(a, b, sub)


def test_diagonal_dp_scalar():
    """The diagonal recurrence's scalar form equals the JAX package's and
    the full Damerau-Levenshtein on random strings at L = 3, 10 and 18,
    and gives tests/test_editdist.py's transposition costs."""
    sub = editdist.substitute_matrix(Palette.NTSC)
    rng = np.random.RandomState(42)
    for L in (3, 10, 18):
        for _ in range(60):
            a, b = rng.randint(0, 16, size=(2, L))
            got = editdist.diagonal_dp_scalar(a, b, sub)
            assert got == jed.diagonal_dp_scalar(a, b, sub)
            assert got == editdist.dam_lev_scalar(a, b, sub)
    a, b = np.array([3, 7, 7, 7]), np.array([7, 3, 7, 7])
    assert editdist.diagonal_dp_scalar(a, b, sub) == 1.0
    assert editdist.diagonal_dp_scalar(a, a, sub) == 0.0
    assert editdist.diagonal_dp_scalar(np.array([1, 2, 3, 4]),
                                       np.array([2, 1, 4, 3]), sub) == 2.0


def test_nominal_colour_helpers():
    """rol / ror, the two nominal-colour enums and the scalar dot-stream
    decoders equal the JAX package's, and give tests/test_colours.py's
    golden runs; the vectorised decoder agrees with the scalar one."""
    for v in range(16):
        for r in range(8):
            assert colours.rol(v, r) == jcolours.rol(v, r)
            assert colours.ror(v, r) == jcolours.ror(v, r)
            assert colours.ror(colours.rol(v, r), r) == v
    assert colours.rol(0b1000, 1) == 0b0001
    assert colours.ror(0b0010, 2) == 0b1000
    for ours, theirs in ((colours.HGRColours, jcolours.HGRColours),
                         (colours.DHGRColours, jcolours.DHGRColours)):
        assert issubclass(ours, colours.NominalColours)
        assert [(c.name, c.value) for c in ours] == [
            (c.name, c.value) for c in theirs]
    C = colours.HGRColours
    assert colours.dots_to_nominal_colour_pixels(
        31, 0b00000000000000000000111000000000, C, init_phase=0) == tuple(
        [C.BLACK] * 6 + [C.DARK_BLUE, C.MED_BLUE, C.AQUA, C.AQUA, C.GREEN,
                         C.BROWN] + [C.BLACK] * 19)
    cycle = [C.BLACK, C.MAGENTA, C.VIOLET, C.LIGHT_BLUE, C.WHITE, C.AQUA,
             C.GREEN, C.BROWN]
    assert colours.dots_to_nominal_colour_pixels(
        31, 0b0000111100001111000011110000, C, init_phase=0) == tuple(
        cycle * 3 + [C.BLACK] * 7)
    rng = np.random.RandomState(0)
    dots = rng.randint(0, 2 ** 21, size=32, dtype=np.int64)
    for phase in range(4):
        vec = colours.dots_to_pixels_vec(dots, num_bits=18,
                                         init_phase=phase)
        for i, d in enumerate(dots):
            for ours, theirs in ((colours.HGRColours, jcolours.HGRColours),
                                 (colours.DHGRColours,
                                  jcolours.DHGRColours)):
                got = colours.dots_to_nominal_colour_pixel_values(
                    18, int(d), ours, init_phase=phase)
                assert got == jcolours.dots_to_nominal_colour_pixel_values(
                    18, int(d), theirs, init_phase=phase)
                assert [p.name for p in colours.dots_to_nominal_colour_pixels(
                    18, int(d), ours, phase)] == [
                    p.name for p in jcolours.dots_to_nominal_colour_pixels(
                        18, int(d), theirs, phase)]
            assert tuple(vec[i].tolist()) == \
                colours.dots_to_nominal_colour_pixel_values(
                    18, int(d), colours.HGRColours, init_phase=phase)


def test_ops_to_ticks():
    """encoder.ops_to_ticks (the object-level stream's ticks) equals the
    JAX package's, field for field, and refuses too few audio levels."""
    rng = np.random.RandomState(8)
    flat = np.concatenate([rng.randint(32, 64, (50, 1)),
                           rng.randint(0, 256, (50, 5))], axis=1)
    levels = rng.randint(0, 32, 60)
    got = list(encoder.ops_to_ticks(flat, levels))
    want = list(jenc.ops_to_ticks(flat, levels))
    assert len(got) == len(want) == 50
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__ == "Tick"
        assert vars(g) == vars(w)
    with pytest.raises(ValueError, match="49 audio levels for 50 ops"):
        list(encoder.ops_to_ticks(flat, levels[:49]))


def test_save_tables_layout(tmp_path, monkeypatch):
    """The reference npz layout (upper triangle, flattened per lane) on a
    5-bit stand-in spec, patched into both modules: the full tables are
    512 MB."""
    class Small:
        NAME = "DHGR"
        MASKED_BITS = 5

    monkeypatch.setattr(editdist, "spec_for_mode", lambda mode: Small)
    monkeypatch.setattr(jed.screen, "spec_for_mode", lambda mode: Small)
    tables = np.random.RandomState(7).randint(0, 999, (4, 32 * 32)).astype(
        np.uint16)
    got = editdist.save_tables(tables, VideoMode.DHGR, Palette.NTSC,
                               str(tmp_path / "a"))
    want = jed.save_tables(tables, JVideoMode.DHGR, JPalette.NTSC,
                           str(tmp_path / "b"))
    assert os.path.basename(got) == os.path.basename(want) == \
        "DHGR_palette_5_edit_distance.npz"
    assert np.array_equal(np.load(got)["edit_distance"],
                          np.load(want)["edit_distance"])


@pytest.mark.parametrize("mode", MODES)
def test_yiq_tables(mode):
    assert yiq.n_pixels(mode) == jyiq.n_pixels(jm(mode))
    assert np.array_equal(yiq.pair_lut(Palette.NTSC),
                          jyiq.pair_lut(JPalette.NTSC))
    assert np.array_equal(yiq.lane_subs(mode, Palette.NTSC),
                          jyiq.lane_subs(jm(mode), JPalette.NTSC))


def test_dither_tables_and_host_quantizers(tmp_path, monkeypatch):
    """The Bayer matrix, the HGR colour sets, the fused LUT built by each
    package (at 3-bit bins, into separate caches) and the C++ quantize,
    pack, HGR fit and error-diffusion paths on the same inputs."""
    assert np.array_equal(dither._bayer_matrix(8), jdither._bayer_matrix(8))
    assert (dither.HGR_COLOURS_P0, dither.HGR_COLOURS_P1,
            dither.FUSED_LUT_BITS, dither.MONO_W) == (
        jdither.HGR_COLOURS_P0, jdither.HGR_COLOURS_P1,
        jdither.FUSED_LUT_BITS, jdither.MONO_W)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "port"))
    lut = dither._host_fused_lut(Palette.NTSC, (0, 3, 6, 9, 12, 15), 24.0, 3)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "jax"))
    jlut = jdither._host_fused_lut(JPalette.NTSC, (0, 3, 6, 9, 12, 15), 24.0,
                                   3)
    assert lut.shape == (64 << 9,) and np.array_equal(lut, jlut)

    rng = np.random.RandomState(8)
    rgb = rng.randint(0, 256, (2, 192, 140, 3)).astype(np.uint8)
    codes = native.quantize_fused(rgb, lut)
    assert np.array_equal(codes, jnative.quantize_fused(rgb, lut))
    for a, b in zip(native.dhgr_pack(codes), jnative.dhgr_pack(codes)):
        assert np.array_equal(a, b)
    assert np.array_equal(native.hgr_fit(codes), jnative.hgr_fit(codes))
    for kernel in ("buckels", "atkinson", "d9"):
        assert np.array_equal(
            dither.quantize_error_diffusion(rgb[0], Palette.NTSC, kernel),
            jdither.quantize_error_diffusion(rgb[0], JPalette.NTSC, kernel))


@pytest.mark.parametrize("h,w,h_out,w_out", [(192, 280, 192, 140),
                                             (240, 320, 192, 560)])
def test_resize_matrix_and_host_resize(h, w, h_out, w_out):
    assert np.array_equal(resize.resize_matrix(w, w_out),
                          jresize.resize_matrix(w, w_out))
    src = np.random.RandomState(9).randint(0, 256, (2, h, w, 3)).astype(
        np.uint8)
    assert np.array_equal(resize.resize_host(src, h_out, w_out),
                          jresize.resize_batch(src, h_out, w_out))


@pytest.mark.parametrize("mode,dither_mode", [
    (VideoMode.DHGR, "ordered"), (VideoMode.HGR, "ordered"),
    (VideoMode.DHGR, "mono"), (VideoMode.HGR, "buckels")])
def test_host_ingest(mode, dither_mode):
    """frames.ingest on an in-memory 280x192 clip, every 2nd frame."""
    from tests.test_pipeline import gradient_movie

    rgb = gradient_movie(F=6, h=192, w=280)
    kw = dict(every_n_video_frames=2, dither_mode=dither_mode,
              frame_rate=24.0)
    got = frames.ingest(rgb, mode, Palette.NTSC, **kw)
    want = jframes.ingest(rgb, jm(mode), JPalette.NTSC, **kw)
    assert (got.n_frames_total, got.input_frame_rate) == (
        want.n_frames_total, want.input_frame_rate)
    assert np.array_equal(got.targets_main, want.targets_main)
    if mode == VideoMode.DHGR:
        assert np.array_equal(got.targets_aux, want.targets_aux)
    else:
        assert got.targets_aux is None and want.targets_aux is None


@pytest.mark.parametrize("stream", [False, True])
def test_audio_levels_and_decode(tmp_path, stream):
    """A 44.1 kHz WAV decoded by both packages; with stream=True both run
    the polyphase decimator (numpy, exact), so the levels are equal."""
    from scipy.io import wavfile

    t = np.arange(44100 // 2) / 44100.0
    x = (np.sin(2 * np.pi * 440 * t) * 9000).astype(np.int16)
    path = str(tmp_path / "tone.wav")
    wavfile.write(path, 44100, x)
    got_data, got_rate = audio.decode_audio(path)
    want_data, want_rate = jaudio.decode_audio(path)
    assert got_rate == want_rate and np.array_equal(got_data, want_data)
    if stream:
        got = audio.Audio(path, stream=True, device="cpu")
        want = jaudio.Audio(path, stream=True)
        assert got.normalization == want.normalization
        assert np.array_equal(got.levels(), want.levels())
    else:
        got = audio.Audio(data=x, rate=14700, device="cpu")
        want = jaudio.Audio(data=x, rate=14700)
        assert np.array_equal(got.levels(), want.levels())


def test_replay_ops_and_player_vm():
    """The copied replay and the copied player VM on one emitted stream."""
    rng = np.random.RandomState(10)
    n = 1200
    flat = np.concatenate([rng.randint(32, 64, (n, 1)),
                           rng.randint(0, 256, (n, 5))], axis=1).astype(
        np.uint8)
    bank = rng.randint(0, 2, n)
    bounds = np.array([100, 555, n - 1])
    assert np.array_equal(quality.replay_ops(flat, bank, bounds),
                          jquality.replay_ops(flat, bank, bounds))
    data = emit_stream_fast(flat, rng.randint(-15, 17, n), VideoMode.DHGR)
    got, want = PlayerVM().decode(data), JPlayerVM().decode(data)
    for f in ("ok", "error", "error_pos", "n_ops", "n_acks", "cycles",
              "video_mode"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("main", "aux", "duty"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.ok and got.n_ops == n


@pytest.mark.parametrize("mode", MODES)
def test_render(mode):
    """Every function of the copied renderer on seeded screens (a batch of
    two and a single screen): colour codes, the dot stream, and the
    window, yiq and mono renders, each exactly the original's."""
    rng = np.random.RandomState(11)
    hi = 0x80 if mode == VideoMode.DHGR else 0x100
    main = rng.randint(0, hi, (2, 32, 256)).astype(np.uint8)
    aux = rng.randint(0, hi, (2, 32, 256)).astype(np.uint8)
    for m, a in ((main, aux), (main[0], aux[0])):
        if mode == VideoMode.DHGR:
            assert np.array_equal(render._row_dots_dhgr(m, a),
                                  jrender._row_dots_dhgr(m, a))
            got = render.dhgr_screen_codes(m, a)
            want = jrender.dhgr_screen_codes(m, a)
        else:
            assert np.array_equal(render._hgr_row_dots(m),
                                  jrender._hgr_row_dots(m))
            got, want = render.hgr_screen_codes(m), jrender.hgr_screen_codes(m)
        assert got.shape == m.shape[:-2] + (192, 140)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(render._row_bits(m, a, mode),
                              jrender._row_bits(m, a, jm(mode)))
        for palette in PALETTES:
            assert np.array_equal(
                render.screen_to_rgb(m, a, mode, palette),
                jrender.screen_to_rgb(m, a, jm(mode), jm(palette)))
        got = render.screen_to_rgb_yiq(m, a, mode, Palette.NTSC)
        assert got.shape == m.shape[:-2] + (192, 140, 3)
        assert np.array_equal(got, jrender.screen_to_rgb_yiq(
            m, a, jm(mode), JPalette.NTSC))
        got = render.screen_to_rgb_mono(m, a, mode)
        assert got.shape == m.shape[:-2] + (192, 560, 3)
        assert np.array_equal(got, jrender.screen_to_rgb_mono(m, a, jm(mode)))
    x = rng.randint(0, 256, (4, 5, 3))
    y = rng.randint(0, 256, (4, 5, 3))
    assert render.psnr(x, y) == jrender.psnr(x, y)


@pytest.mark.parametrize("name", ["apple2_vm", "player_vm", "dither",
                                  "ingest_fast", "resize_fast"])
def test_native_sources_are_the_originals(name):
    """The port builds its own copy of each C++ source; the copy equals
    the original byte for byte."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(repo, pkg, "sim", "csrc", name + ".cpp")
             for pkg in ("iivision_tpu_torch", "iivision_tpu")]
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        got, want = f.read(), g.read()
    assert got == want and len(got) > 1000
