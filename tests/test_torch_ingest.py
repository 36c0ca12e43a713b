"""Device ingest in iivision_tpu_torch (ops/dither, ops/resize,
parallel.mesh.ingest_movies_batch) on the CPU against the JAX package.

The packing and the mono quantizer are integer-only and bit-exact.  The
ordered and HGR quantizers are float32 Lab argmins: torch has no `cbrt`
and its `pow` rounds differently from XLA's, so a pixel on a near-tie may
pick another code.  Their ceiling is 0.5% of pixels; on these inputs the
measured rate is 0 (0 of 322,560 ordered codes and 0 of 98,304 HGR bytes,
for each palette).  The resize is float64 in the port and float32 in the
JAX package: within one uint8 level, with a measured share of 3.1e-6
(192x280 -> 192x140) and 1.2e-5 (240x320 -> 192x140) of values one level
apart, pinned at 1e-3.  The fused DHGR ingest differs from the JAX one in
1 of 98,304 target bytes (a resize level that crossed a dither threshold);
the HGR one in none.

On a card the batch ingest is one launch of csrc/ingest.cu (`ops/ingest`),
held to the chain in tests/test_torch_ingest_kernel.py; here the kernel's
tables, which it builds on the host, are held to what the chain uses, and
the CPU batch ingest to the chain with no kernel launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu.ops import dither as jdither
from iivision_tpu.ops import resize as jresize
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.parallel import mesh as jmesh
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import palettes, trace
from iivision_tpu_torch.ops import dither, ingest, resize
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.parallel import mesh
from iivision_tpu_torch.video_mode import VideoMode

CODE_MISMATCH_CEILING = 0.005  # share of pixels (measured: 0)
RESIZE_MISMATCH_CEILING = 1e-3  # share of values one level apart


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


def rgb_frames(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
def test_mono_and_packing_bit_exact(mode):
    """quantize_mono, the DHGR code packing, the HGR dot fit and the row
    interleave equal the JAX package's numpy forms bit for bit."""
    rgb560 = rgb_frames((3, 192, 560, 3), 1)
    want = jdither.quantize_mono(rgb560, jm(mode))
    got = dither.quantize_mono(torch.as_tensor(rgb560), mode)
    assert got[0].dtype == torch.uint8
    assert np.array_equal(got[0].numpy(), want[0])
    if mode == VideoMode.DHGR:
        assert np.array_equal(got[1].numpy(), want[1])
    else:
        assert got[1] is None and want[1] is None

    codes = np.random.RandomState(2).randint(0, 16, (3, 192, 140))
    tc = torch.as_tensor(codes)
    for w, g in zip(jdither.dhgr_codes_to_memory(codes),
                    dither.dhgr_codes_to_memory(tc)):
        assert np.array_equal(g.numpy(), w)
    dots = jdither.hgr_desired_dots(codes)
    assert np.array_equal(dither.hgr_desired_dots(tc).numpy(), dots)
    by = jdither.hgr_dots_to_bytes(dots)
    assert np.array_equal(dither.hgr_dots_to_bytes(
        torch.as_tensor(dots)).numpy(), by)
    assert np.array_equal(dither.hgr_bytes_to_memory(
        torch.as_tensor(by)).numpy(), jdither.hgr_bytes_to_memory(by))


@pytest.mark.parametrize("palette", [Palette.NTSC, Palette.IIGS])
def test_quantizers_within_pinned_mismatch(palette):
    """quantize_ordered codes and quantize_hgr screen bytes against the
    jitted JAX functions on 12 random frames."""
    rgb = rgb_frames((12, 192, 140, 3), 3)
    want = np.asarray(jax.jit(
        lambda x: jdither.quantize_ordered(x, JPalette[palette.name]))(
            jnp.asarray(rgb)))
    got = dither.quantize_ordered(torch.as_tensor(rgb), palette)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert (got.numpy() != want).mean() <= CODE_MISMATCH_CEILING

    want = np.asarray(jax.jit(
        lambda x: jdither.quantize_hgr(x, JPalette[palette.name]))(
            jnp.asarray(rgb)))
    got = dither.quantize_hgr(torch.as_tensor(rgb), palette)
    assert got.dtype == torch.uint8 and got.shape == want.shape == (
        12, 32, 256)
    assert (got.numpy() != want).mean() <= CODE_MISMATCH_CEILING


@pytest.mark.parametrize("h,w", [(192, 280), (240, 320)])
def test_resize_within_one_level(h, w):
    """resize_batch against the JAX device path (float32 HIGHEST
    einsums), modelled on tests/test_frames.py's device-resize check."""
    src = rgb_frames((4, h, w, 3), 4)
    want = np.asarray(jresize.resize_batch(jnp.asarray(src), 192, 140))
    got = resize.resize_batch(torch.as_tensor(src), 192, 140)
    assert got.dtype == torch.uint8 and got.shape == (4, 192, 140, 3)
    d = np.abs(got.numpy().astype(int) - want)
    assert d.max() <= 1
    assert (d > 0).mean() <= RESIZE_MISMATCH_CEILING


@pytest.mark.parametrize("mode,h,w", [(VideoMode.DHGR, 192, 280),
                                      (VideoMode.HGR, 240, 320)])
def test_ingest_movies_batch_matches_jax(mode, h, w):
    """The fused batch ingest (resize, quantize, pack, lanes) against the
    JAX one: bytes within the quantizers' ceiling, and lanes equal
    wherever a frame's bytes are equal."""
    B, F = 2, 3
    rgb = rgb_frames((B, F, h, w, 3), 5)
    j_lanes, j_bytes = jmesh.ingest_movies_batch(rgb, jm(mode),
                                                 JPalette.NTSC)
    j_lanes, j_bytes = np.asarray(j_lanes), np.asarray(j_bytes)
    lanes, bytes_ = mesh.ingest_movies_batch(torch.as_tensor(rgb), mode,
                                             Palette.NTSC)
    assert lanes.shape == j_lanes.shape and bytes_.shape == j_bytes.shape
    assert lanes.dtype == bytes_.dtype == torch.int32
    assert (bytes_.numpy() != j_bytes).mean() <= CODE_MISMATCH_CEILING
    same = (bytes_.numpy() == j_bytes).reshape(B * F, -1).all(axis=1)
    assert same.any()
    assert np.array_equal(lanes.numpy().reshape(B * F, -1)[same],
                          j_lanes.reshape(B * F, -1)[same])


def test_ingest_refuses_host_arrays_and_meshes():
    """A host array is refused; a CPU mesh of 2 ingests two shards equal to
    the unsharded ingest, and refuses a batch it does not divide."""
    rgb = rgb_frames((2, 1, 192, 140, 3), 6)
    with pytest.raises(TypeError, match="tensor"):
        mesh.ingest_movies_batch(rgb, VideoMode.DHGR, Palette.NTSC)
    two = mesh.make_mesh(2, "cpu")
    lanes, bytes_ = mesh.ingest_movies_batch(torch.as_tensor(rgb),
                                             VideoMode.DHGR, Palette.NTSC)
    s_lanes, s_bytes = mesh.ingest_movies_batch(
        torch.as_tensor(rgb), VideoMode.DHGR, Palette.NTSC, mesh=two)
    assert [len(x) for x in s_lanes] == [1, 1]
    assert torch.equal(torch.cat(s_lanes), lanes)
    assert torch.equal(torch.cat(s_bytes), bytes_)
    with pytest.raises(ValueError, match="does not split"):
        mesh.ingest_movies_batch(torch.as_tensor(rgb[:1]), VideoMode.DHGR,
                                 Palette.NTSC, mesh=two)


@pytest.mark.parametrize("h,w", [(192, 280), (192, 140), (360, 640),
                                 (720, 1280)])
def test_ingest_kernel_taps_rebuild_resize_matrix(h, w):
    """The kernel's banded taps (int32 source index, float64 weight) add up,
    entry for entry, to the float64 matrices the chain's einsums take
    (`resize_matrix` as float32, then double); every index lies in the
    source."""
    c = ingest.constants(VideoMode.DHGR, Palette.NTSC, h, w)
    for axis, n_in, n_out in (("h", h, 192), ("w", w, 140)):
        idx, wt = c[axis + "_idx"].numpy(), c[axis + "_w"].numpy()
        assert idx.dtype == np.int32 and wt.dtype == np.float64
        assert idx.shape == wt.shape and idx.shape[0] == n_out
        assert idx.min() >= 0 and idx.max() < n_in
        dense = np.zeros((n_out, n_in))
        np.add.at(dense, (np.repeat(np.arange(n_out), idx.shape[1]),
                          idx.ravel()), wt.ravel())
        want = torch.as_tensor(resize.resize_matrix(n_in, n_out)).double()
        assert np.array_equal(dense, want.numpy())
    assert 24 % ingest.rows_per_step(w) == 0


@pytest.mark.parametrize("mode,palette", [(VideoMode.DHGR, Palette.NTSC),
                                          (VideoMode.DHGR, Palette.IIGS),
                                          (VideoMode.HGR, Palette.NTSC),
                                          (VideoMode.HGR, Palette.IIGS)])
def test_ingest_kernel_constants_are_the_chains(mode, palette):
    """The kernel's Bayer thresholds tile to `_bayer_tile` at 192x140, its
    XYZ matrix and white point are `srgb_to_lab`'s float32 values, and its
    palette (Lab values, the -2 Lab and |p|^2 scores, the colour code of
    each entry) is the one `quantize_ordered` / `quantize_hgr` pick from."""
    c = ingest.constants(mode, palette, 192, 280)
    assert torch.equal(c["bayer"].tile((25, 18))[:192, :140],
                       dither._bayer_tile(192, 140, "cpu"))
    m = torch.as_tensor(palettes._SRGB_TO_XYZ.T, dtype=torch.float32)
    assert torch.equal(c["xyz"][:9].reshape(3, 3).T, m)
    assert torch.equal(c["xyz"][9:], torch.as_tensor(
        palettes._D65_WHITE, dtype=torch.float32))
    codes = (list(range(16)) if mode == VideoMode.DHGR else
             sorted(set(dither.HGR_COLOURS_P0) | set(dither.HGR_COLOURS_P1)))
    assert c["codes"].tolist() == codes and c["codes"].dtype == torch.int32
    lab = torch.as_tensor(dither._palette_lab(palette)[codes],
                          dtype=torch.float32)
    assert torch.equal(c["lab"], lab)
    scores = ingest.palette_scores(lab)
    assert torch.equal(scores[:3], -2.0 * lab.T)
    assert torch.equal(scores[3], (lab ** 2).sum(dim=-1))


def test_ingest_kernel_is_the_cards_alone(monkeypatch):
    """On the CPU ingest_movies_batch takes the torch chain (its stage
    spans open, `ingest.kernel` does not) and launches no ingest kernel;
    `ingest_batch` itself refuses frames off a card."""
    rgb = torch.as_tensor(rgb_frames((2, 2, 192, 280, 3), 7))
    before = trace.counters()["ingest_batch.launches"]
    opened = []
    real = trace.span.__init__

    def record(self, name, into=None):
        opened.append(name)
        real(self, name, into)

    monkeypatch.setattr(trace.span, "__init__", record)
    lanes, bytes_ = mesh.ingest_movies_batch(rgb, VideoMode.HGR,
                                             Palette.NTSC)
    monkeypatch.undo()
    assert trace.counters()["ingest_batch.launches"] == before
    assert "ingest.kernel" not in opened
    assert {"ingest", "ingest.resize", "ingest.quantize", "ingest.targets",
            "ingest.cat"} <= set(opened)
    want = mesh.ingest_batch_plain(rgb, VideoMode.HGR, Palette.NTSC)
    assert torch.equal(lanes, want[0]) and torch.equal(bytes_, want[1])
    with pytest.raises(ValueError, match="card"):
        ingest.ingest_batch(rgb, VideoMode.HGR, Palette.NTSC)
