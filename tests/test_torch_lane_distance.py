"""The port's lane distance (`distance.dist_lane_pairs` for a (16, 16)
basis, kernel A's lane-distance entry on a card) against the JAX
package's `dist_lane_pairs` on the CPU: the same numpy-seeded lane values
through both, for every DHGR and HGR lane under the window and the mono
basis.  Tolerance 0: every distance is an integer.  Also the wrapper's
argument checks, its (rows, cols) stride reduction, and the store-cost
table's range guard."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu import screen as jscreen
from iivision_tpu.ops import distance as jdist
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch.ops import distance, editdist
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

LANES = [(VideoMode.DHGR, lane) for lane in range(4)] \
    + [(VideoMode.HGR, lane) for lane in range(2)]


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


def jax_lane_pairs(va, vb, mode, lane, sub):
    return np.asarray(jdist.dist_lane_pairs(
        jnp.asarray(va), jnp.asarray(vb), jm(mode), lane,
        jnp.asarray(sub))).astype(np.int64)


def swap_bits(rng, vals, n_bits, apart):
    """`vals` with bits i and i + apart exchanged, i drawn per element:
    four apart in DHGR dots (two in HGR body bits) transposes two
    neighbouring colour codes."""
    i = rng.randint(0, n_bits - apart, vals.shape)
    flip = ((vals >> i) ^ (vals >> (i + apart))) & 1
    return vals ^ (flip << i) ^ (flip << (i + apart))


@pytest.mark.parametrize("model", ["window", "mono"])
@pytest.mark.parametrize("mode,lane", LANES)
def test_dist_lane_pairs_matches_jax(mode, lane, model):
    """Random pairs, pairs that transpose neighbouring codes, and every
    masked value of the lane against a fixed one."""
    bits = int(jscreen.spec_for_mode(jm(mode)).MASKED_BITS)
    n = 1 << bits
    rng = np.random.RandomState(20 + 10 * lane + (model == "mono"))
    sub = jdist.sub_for(jm(mode), JPalette.NTSC, model)
    assert np.array_equal(sub, distance.sub_for(mode, Palette.NTSC, model))
    tsub = torch.as_tensor(sub.astype(np.int32))
    va = rng.randint(0, n, (3, 32, 128)).astype(np.int32)
    vb = rng.randint(0, n, va.shape).astype(np.int32)
    vb[1] = swap_bits(rng, va[1], bits, 4 if mode == VideoMode.DHGR else 2)
    every = np.arange(n, dtype=np.int32)
    fixed = np.full(n, rng.randint(n), np.int32)
    transposed = 0
    for a, b in ((va, vb), (every, fixed)):
        got = distance.dist_lane_pairs(torch.as_tensor(a), torch.as_tensor(b),
                                       mode, lane, tsub)
        assert got.dtype == torch.int32 and got.shape == a.shape
        assert np.array_equal(got.numpy(), jax_lane_pairs(a, b, mode, lane,
                                                          sub))
        # the wrapper and its plain version are the same function here
        for fn in (editdist.lane_distance, distance.dist_lane_pairs_plain):
            assert torch.equal(fn(torch.as_tensor(a), torch.as_tensor(b),
                                  mode, lane, tsub), got)
        pa = jdist.lane_pixels(a, jm(mode), lane)
        pb = jdist.lane_pixels(b, jm(mode), lane)
        transposed += int(((pa[..., 1:] == pb[..., :-1])
                           & (pa[..., :-1] == pb[..., 1:])
                           & (pa[..., 1:] != pa[..., :-1])).any(-1).sum())
    assert transposed > 0  # the recurrence's transposition branch was open


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
def test_dist_lane_pairs_on_views(mode):
    """The callers' views: a lane sliced out of (..., n_lanes) arrays (the
    scorer) and a column broadcast along rows (the store-cost build)."""
    spec = jscreen.spec_for_mode(jm(mode))
    n, nl = 1 << int(spec.MASKED_BITS), int(spec.N_LANES)
    rng = np.random.RandomState(31)
    sub = jdist.sub_for(jm(mode), JPalette.NTSC, "window")
    tsub = torch.as_tensor(sub.astype(np.int32))
    both = rng.randint(0, n, (2, 4, 32, 128, nl)).astype(np.int32)
    new = rng.randint(0, n, (64, 128)).astype(np.int32)
    col = rng.randint(0, n, (64, 1)).astype(np.int32)
    lane = nl - 1
    for ta, tb in ((torch.as_tensor(both[0])[..., lane],
                    torch.as_tensor(both[1])[..., lane]),
                   (torch.as_tensor(new),
                    torch.as_tensor(col).expand(new.shape))):
        assert not tb.is_contiguous()
        got = distance.dist_lane_pairs(ta, tb, mode, lane, tsub)
        assert np.array_equal(got.numpy(), jax_lane_pairs(
            ta.contiguous().numpy(), tb.contiguous().numpy(), mode, lane,
            sub))


def as_grid(t, rows, cols, strides):
    """What the kernel reads: element (r, c) at r * row_stride + c *
    col_stride from the tensor's first element."""
    return torch.as_strided(t, (rows, cols), strides, t.storage_offset())


@pytest.mark.parametrize("case", ["contiguous", "lane_view", "broadcast",
                                  "transposed", "permuted", "scalar",
                                  "no_merge"])
def test_rows_cols_reads_every_pair_in_order(case):
    """`editdist.rows_cols` reduces both tensors to one (rows, cols) grid
    with two strides each; reading the grid in row-major order must give
    the tensors' elements in their own order, in place where the dims
    merge and from contiguous copies where they do not."""
    base = torch.arange(2 * 3 * 4 * 5 * 6, dtype=torch.int32)
    a, b = {
        "contiguous": lambda: (base.reshape(6, 20, 6),
                               base.flip(0).reshape(6, 20, 6)),
        "lane_view": lambda: (base.reshape(4, 6, 5, 6)[..., 2],
                              base.reshape(4, 6, 5, 6)[..., 5]),
        "broadcast": lambda: (base[:60].reshape(12, 5),
                              base[100:112].reshape(12, 1).expand(12, 5)),
        "transposed": lambda: (base[:60].reshape(5, 12).T,
                               base[:60].reshape(12, 5)),
        "permuted": lambda: (base[:210].reshape(6, 7, 5).permute(2, 0, 1),
                             base[:210].reshape(5, 6, 7)),
        "scalar": lambda: (base[7], base[9]),
        # a: (2, 3, 5) strides (60, 1, 6); b: strides (1, 10, 2); no split
        # of the dims merges for both
        "no_merge": lambda: (base[:120].reshape(2, 10, 6)[:, :5]
                             .permute(0, 2, 1)[:, :3],
                             base[:30].reshape(3, 5, 2).permute(2, 0, 1)),
    }[case]()
    assert a.shape == b.shape
    ra, rb, rows, cols, sa, sb = editdist.rows_cols(a, b)
    assert rows * cols == a.numel()
    assert torch.equal(as_grid(ra, rows, cols, sa).reshape(-1), a.reshape(-1))
    assert torch.equal(as_grid(rb, rows, cols, sb).reshape(-1), b.reshape(-1))
    copied = ra.data_ptr() != a.data_ptr()
    assert copied == (case == "no_merge")


def test_lane_distance_refuses_what_the_kernel_does_not_take():
    """Argument checks, on the meta device (no kernel, no data): a wrong
    dtype, shape, lane, cost basis or device raises; nothing falls back to
    the plain version."""
    D = VideoMode.DHGR
    v = torch.empty((4, 128), dtype=torch.int32, device="meta")
    sub = torch.zeros((16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        editdist.lane_distance(v, v, D, 0, sub)
    with pytest.raises(ValueError, match="no kernel"):
        distance.dist_lane_pairs(v, v, D, 0, sub)
    with pytest.raises(ValueError, match="int32"):
        editdist.lane_distance(v.to(torch.int64), v, D, 0, sub)
    with pytest.raises(ValueError, match="int32"):
        editdist.lane_distance(v, v.to(torch.float32), D, 0, sub)
    with pytest.raises(ValueError, match="one device"):
        editdist.lane_distance(v, torch.zeros((4, 128), dtype=torch.int32),
                               D, 0, sub)
    with pytest.raises(ValueError, match="shapes differ"):
        editdist.lane_distance(v, v[:2], D, 0, sub)
    with pytest.raises(ValueError, match="no lane"):
        editdist.lane_distance(v, v, VideoMode.HGR, 2, sub)
    with pytest.raises(ValueError, match="no lane"):
        editdist.lane_distance(v, v, D, -1, sub)
    with pytest.raises(ValueError, match=r"\(16, 16\)"):
        editdist.lane_distance(v, v, D, 0, sub[:8])
    # the CPU path checks its arguments too
    c = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="no lane"):
        editdist.lane_distance(c, c, D, 4, torch.zeros((16, 16)))


@pytest.mark.parametrize("value", [-1, 1 << 15],
                         ids=["negative", "overflow"])
def test_store_cost_table_refuses_costs_outside_int15(tmp_path, monkeypatch,
                                                      value):
    """The joint body kernel reads a cost's bits as a float, exact only for
    0 <= cost < 2^15: a doctored cached table with one cost outside that
    range is refused, and the same table in range loads."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    mode = VideoMode.DHGR
    cost = np.zeros((4, 8192, 128), np.float32)
    cost[2, 17, 5] = 300
    distance.save_store_cost(cost.astype(np.int32), mode, Palette.NTSC,
                             "mono", distance._user_cache_dir())
    table = distance.store_cost_table(mode, Palette.NTSC, "mono", "cpu")
    assert table.dtype == np.int16 and table[2, 17, 5] == 300
    cost[1, 3, 9] = value
    path = distance.store_cost_path(mode, Palette.NTSC, "mono",
                                    distance._user_cache_dir())
    with open(path, "wb") as f:  # float32, so a negative cost survives
        np.savez_compressed(f, cost=cost)
    with pytest.raises(ValueError, match="store costs outside"):
        distance.store_cost_table(mode, Palette.NTSC, "mono", "cpu")
