"""iivision_tpu_torch screen lanes and distance model against the JAX
package: the same numpy-seeded inputs through both, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu import screen as jscreen
from iivision_tpu.ops import distance as jdist
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode
from iivision_tpu_torch import screen
from iivision_tpu_torch.ops import distance, editdist, subop

MODES = [VideoMode.DHGR, VideoMode.HGR]


def _banks(seed, n=3):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 32, 256)).astype(np.uint8),
            rng.randint(0, 256, (n, 32, 256)).astype(np.uint8))


@pytest.mark.parametrize("mode", MODES)
def test_masked_lanes_match_numpy_and_jax(mode):
    main, aux = _banks(1)
    if mode == VideoMode.DHGR:
        got = screen.dhgr_masked_lanes(torch.as_tensor(main),
                                       torch.as_tensor(aux))
        ref_np = jscreen.dhgr_masked_lanes(main, aux)
        ref_jax = jscreen.dhgr_masked_lanes(jnp.asarray(main),
                                            jnp.asarray(aux))
    else:
        got = screen.hgr_masked_lanes(torch.as_tensor(main))
        ref_np = jscreen.hgr_masked_lanes(main)
        ref_jax = jscreen.hgr_masked_lanes(jnp.asarray(main))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref_np)
    assert np.array_equal(got.numpy(), np.asarray(ref_jax))


def test_interleave_bank_lanes():
    rng = np.random.RandomState(2)
    e, o = rng.randint(0, 999, (2, 32, 128))
    got = screen.interleave_bank_lanes(torch.as_tensor(e), torch.as_tensor(o))
    assert np.array_equal(got.numpy(), jscreen.interleave_bank_lanes(e, o))


@pytest.mark.parametrize("mode", MODES)
def test_lane_pixels_match_numpy_and_jax(mode):
    spec = jscreen.spec_for_mode(mode)
    vals = np.random.RandomState(3).randint(
        0, 1 << spec.MASKED_BITS, (32, 128)).astype(np.int32)
    for lane in range(spec.N_LANES):
        got = distance.lane_pixels(torch.as_tensor(vals), mode, lane)
        assert got.shape == (32, 128, spec.MASKED_DOTS)
        assert np.array_equal(got.numpy(),
                              jdist.lane_pixels(vals, mode, lane))
        assert np.array_equal(got.numpy(), np.asarray(
            jdist.lane_pixels(jnp.asarray(vals), mode, lane)))


@pytest.mark.parametrize("mode", MODES)
def test_dist_pixel_pairs_plain_matches_numpy_and_jax(mode):
    """The plain recurrence (a cost lookup per position) equals the JAX
    package's one-hot float32 form on real lane pixel codes, with and
    without adjacent transpositions."""
    spec = jscreen.spec_for_mode(mode)
    rng = np.random.RandomState(4)
    va = rng.randint(0, 1 << spec.MASKED_BITS, (2, 32, 128))
    # half the targets differ from the source in one bit: near pairs,
    # where transpositions are eligible
    flip = np.left_shift(1, rng.randint(0, spec.MASKED_BITS, va.shape))
    vb = np.where(rng.rand(*va.shape) < 0.5, va ^ flip,
                  rng.randint(0, 1 << spec.MASKED_BITS, va.shape))
    sub = distance.sub16(Palette.NTSC)
    for lane in range(spec.N_LANES):
        pa = jdist.lane_pixels(va, mode, lane)
        pb = jdist.lane_pixels(vb, mode, lane)
        got = distance.dist_pixel_pairs_plain(
            torch.as_tensor(pa), torch.as_tensor(pb), torch.as_tensor(sub))
        ref_np = jdist.dist_pixel_pairs(pa, pb, sub)
        ref_jax = np.asarray(jdist.dist_pixel_pairs(
            jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(sub)))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref_np.astype(np.int64))
        assert np.array_equal(got.numpy(), ref_jax.astype(np.int64))
        # the wrapper takes the plain version for a CPU tensor
        wrapped = distance.dist_pixel_pairs(
            torch.as_tensor(pa), torch.as_tensor(pb), torch.as_tensor(sub))
        assert torch.equal(wrapped, got)


def test_dist_lane_pairs_matches_computed_distance():
    mode = VideoMode.DHGR
    rng = np.random.RandomState(5)
    va, vb = rng.randint(0, 1 << 13, (2, 32, 128)).astype(np.int32)
    jd = jdist.ComputedDistance(mode, Palette.NTSC)
    td = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
    for lane in range(4):
        got = distance.dist_lane_pairs(torch.as_tensor(va),
                                       torch.as_tensor(vb), mode, lane,
                                       td.sub)
        ref = np.asarray(jd.lane_diff(jnp.asarray(va), jnp.asarray(vb),
                                      lane))
        assert np.array_equal(got.numpy(), ref.astype(np.int64))


def test_store_cost_table_matches_jax():
    td = distance.ComputedDistance(VideoMode.DHGR, Palette.NTSC,
                                   device="cpu")
    ref = np.asarray(jdist.store_cost_table(VideoMode.DHGR, Palette.NTSC))
    assert td.store_cost16.dtype == torch.int16
    assert td.store_cost16.shape == (4, 8192, 128)
    assert np.array_equal(td.store_cost16.numpy().astype(np.float32), ref)
    assert np.array_equal(td.sub.numpy(), distance.sub16(Palette.NTSC))


def test_unported_models_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        distance.sub_for(VideoMode.DHGR, Palette.NTSC, "yiq")


def test_wrappers_refuse_devices_without_a_kernel():
    """No fallback: a tensor on a device other than the CPU either runs
    the kernel or raises (the meta device has no kernel)."""
    meta = torch.empty((8, 10), dtype=torch.int32, device="meta")
    sub = torch.zeros((16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        editdist.pair_distance(meta, meta, sub)
    with pytest.raises(ValueError, match="no kernel"):
        editdist.dist_pairs_elementwise(meta, meta, sub)
    rows = torch.empty((2, 4, 256), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        subop.sub_op_chain(rows, None, None, None, None, 1, 0,
                           torch.empty((1, 2, 6), device="meta"))
