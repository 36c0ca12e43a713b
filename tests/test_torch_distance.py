"""iivision_tpu_torch screen lanes and distance model against the JAX
package: the same numpy-seeded inputs through both, exact equality.  Covers
the window, yiq and mono bases and the store-cost build."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu import screen as jscreen
from iivision_tpu.ops import distance as jdist
from iivision_tpu.ops import yiq as jyiq
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import screen
from iivision_tpu_torch.ops import body, distance, editdist
from iivision_tpu_torch.ops import yiq as tyiq
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

MODES = [VideoMode.DHGR, VideoMode.HGR]


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


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
    spec = jscreen.spec_for_mode(jm(mode))
    vals = np.random.RandomState(3).randint(
        0, 1 << spec.MASKED_BITS, (32, 128)).astype(np.int32)
    for lane in range(spec.N_LANES):
        got = distance.lane_pixels(torch.as_tensor(vals), mode, lane)
        assert got.shape == (32, 128, spec.MASKED_DOTS)
        assert np.array_equal(got.numpy(),
                              jdist.lane_pixels(vals, jm(mode), lane))
        assert np.array_equal(got.numpy(), np.asarray(
            jdist.lane_pixels(jnp.asarray(vals), jm(mode), lane)))


@pytest.mark.parametrize("mode", MODES)
def test_dist_pixel_pairs_plain_matches_numpy_and_jax(mode):
    """The plain recurrence (a cost lookup per position) equals the JAX
    package's one-hot float32 form on real lane pixel codes, with and
    without adjacent transpositions."""
    spec = jscreen.spec_for_mode(jm(mode))
    rng = np.random.RandomState(4)
    va = rng.randint(0, 1 << spec.MASKED_BITS, (2, 32, 128))
    # half the targets differ from the source in one bit: near pairs,
    # where transpositions are eligible
    flip = np.left_shift(1, rng.randint(0, spec.MASKED_BITS, va.shape))
    vb = np.where(rng.rand(*va.shape) < 0.5, va ^ flip,
                  rng.randint(0, 1 << spec.MASKED_BITS, va.shape))
    sub = distance.sub16(Palette.NTSC)
    for lane in range(spec.N_LANES):
        pa = jdist.lane_pixels(va, jm(mode), lane)
        pb = jdist.lane_pixels(vb, jm(mode), lane)
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
    jd = jdist.ComputedDistance(jm(mode), JPalette.NTSC)
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
    ref = np.asarray(jdist.store_cost_table(JVideoMode.DHGR, JPalette.NTSC))
    assert td.store_cost16.dtype == torch.int16
    assert td.store_cost16.shape == (4, 8192, 128)
    assert np.array_equal(td.store_cost16.numpy().astype(np.float32), ref)
    assert np.array_equal(td.sub.numpy(), distance.sub16(Palette.NTSC))


def test_unported_models_raise():
    with pytest.raises(ValueError, match="unknown colour model"):
        distance.sub_for(VideoMode.DHGR, Palette.NTSC, "lab")


@pytest.mark.parametrize("model", ["window", "yiq", "mono"])
def test_sub_for_matches_jax(model):
    for mode in MODES:
        got = distance.sub_for(mode, Palette.NTSC, model)
        assert np.array_equal(got, jdist.sub_for(jm(mode), JPalette.NTSC, model))
        # every basis is integer-valued: the port's int32 copy is exact
        assert np.array_equal(got.astype(np.int32).astype(np.float32), got)


@pytest.mark.parametrize("mode", MODES)
def test_lane_windows_match_numpy_and_jax(mode):
    spec = jscreen.spec_for_mode(jm(mode))
    vals = np.random.RandomState(6).randint(
        0, 1 << spec.MASKED_BITS, (32, 128)).astype(np.int32)
    for lane in range(spec.N_LANES):
        got = tyiq.lane_windows(torch.as_tensor(vals), mode, lane)
        assert got.dtype == torch.int32
        assert got.shape == (32, 128, jyiq.n_pixels(jm(mode)))
        assert np.array_equal(got.numpy(), jyiq.lane_windows(vals, jm(mode),
                                                              lane))
        assert np.array_equal(got.numpy(), np.asarray(
            jyiq.lane_windows(jnp.asarray(vals), jm(mode), lane)))


@pytest.mark.parametrize("mode", MODES)
def test_yiq_window_sums_match_jax(mode):
    """The gather-sum against the JAX one-hot einsums: per lane through
    `dist_lane_pairs` (rank dispatch) and both lanes of a bank stacked
    through `dist_window_sums_sub2`."""
    spec = jscreen.spec_for_mode(jm(mode))
    rng = np.random.RandomState(7)
    va, vb = rng.randint(0, 1 << spec.MASKED_BITS,
                         (2, spec.N_LANES, 32, 128))
    sub = jdist.sub_for(jm(mode), JPalette.NTSC, "yiq")
    tsub = torch.as_tensor(sub.astype(np.int32))
    for lane in range(spec.N_LANES):
        got = distance.dist_lane_pairs(torch.as_tensor(va[lane]),
                                       torch.as_tensor(vb[lane]), mode,
                                       lane, tsub)
        ref = np.asarray(jdist.dist_lane_pairs(
            jnp.asarray(va[lane]), jnp.asarray(vb[lane]), jm(mode), lane,
            jnp.asarray(sub)))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref.astype(np.int64))
    lanes = (0, 1)
    wa = np.stack([jyiq.lane_windows(va[i], jm(mode), l)
                   for i, l in enumerate(lanes)])
    wb = np.stack([jyiq.lane_windows(vb[i], jm(mode), l)
                   for i, l in enumerate(lanes)])
    got = distance.dist_window_sums_sub2(
        torch.as_tensor(wa), torch.as_tensor(wb), tsub[list(lanes)])
    ref = np.asarray(jdist.dist_window_sums_sub2(
        jnp.asarray(wa), jnp.asarray(wb), jnp.asarray(sub[list(lanes)])))
    assert np.array_equal(got.numpy(), ref.astype(np.int64))


def test_build_store_cost_matches_shipped_table():
    """The DHGR NTSC window table built here (the plain recurrence on the
    CPU) is the shipped npz, exactly."""
    built = distance.build_store_cost(VideoMode.DHGR, Palette.NTSC,
                                      "window", "cpu")
    shipped = np.load(jdist.store_cost_path(JVideoMode.DHGR, JPalette.NTSC,
                                            "window"))["cost"]
    assert built.dtype == torch.int32 and built.shape == shipped.shape
    assert np.array_equal(built.numpy(), shipped.astype(np.int32))


def test_mono_store_cost_built_cached_and_exact(tmp_path, monkeypatch):
    """No mono table is shipped: the first lookup builds it and saves it to
    the user cache in the JAX package's layout, the second loads it; 64
    sampled rows equal the JAX `dist_lane_pairs` on the same (t, c)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    mode = VideoMode.DHGR
    path = jdist.store_cost_path(jm(mode), JPalette.NTSC, "mono",
                                 jdist._user_cache_dir())
    assert path.startswith(str(tmp_path)) and not os.path.exists(path)
    table = distance.store_cost_table(mode, Palette.NTSC, "mono", "cpu")
    assert os.path.exists(path)
    assert table.dtype == np.int16 and table.shape == (4, 8192, 128)
    saved = np.load(path)["cost"]
    assert saved.dtype == np.uint16  # exact integers, as the JAX package
    assert np.array_equal(saved.astype(np.int16), table)
    assert np.array_equal(distance.store_cost_table(mode, Palette.NTSC,
                                                    "mono", "cpu"), table)

    spec = jscreen.spec_for_mode(jm(mode))
    sub = jnp.asarray(jdist.sub16_mono())
    rng = np.random.RandomState(8)
    c = np.arange(128)[None, :]
    for lane in range(4):
        t = rng.randint(0, 8192, 16)[:, None] + 0 * c  # (16, 128)
        want = np.asarray(jdist.dist_lane_pairs(
            jnp.asarray(spec.masked_update(t, c)), jnp.asarray(t), jm(mode),
            lane, sub))
        assert np.array_equal(table[lane, t[:, 0]], want.astype(np.int16))


def test_hgr_store_cost_rows_match_shipped_table():
    """`store_cost_rows` at L = 18 (HGR, both lanes' masked updates) on
    sampled rows of the shipped HGR table."""
    shipped = np.load(jdist.store_cost_path(JVideoMode.HGR, JPalette.NTSC,
                                            "window"))["cost"]
    sub = torch.as_tensor(distance.sub16(Palette.NTSC).astype(np.int32))
    t = torch.as_tensor(np.random.RandomState(9).randint(0, 1 << 14, 48))
    for lane in range(2):
        got = distance.store_cost_rows(VideoMode.HGR, lane, t, sub)
        assert np.array_equal(got.numpy(),
                              shipped[lane, t.numpy()].astype(np.int32))


def test_wrappers_refuse_devices_without_a_kernel():
    """No fallback: a tensor on a device other than the CPU either runs
    the kernel or raises (the meta device has no kernel)."""
    meta = torch.empty((8, 10), dtype=torch.int32, device="meta")
    sub = torch.zeros((16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        editdist.pair_distance(meta, meta, sub)
    with pytest.raises(ValueError, match="no kernel"):
        editdist.dist_pairs_elementwise(meta, meta, sub)
    state = torch.empty((1, 2, 32, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        body.encode_body(state, state, state, None, None, 0, 0, None, None,
                         None, 0, 1, torch.empty((1, 1, 1, 1, 6),
                                                 device="meta"),
                         VideoMode.DHGR)
