"""iivision_tpu_torch edit-distance tiles against the JAX package's Pallas
kernel (interpret mode), its XLA tile and the scalar Damerau-Levenshtein
oracle, and the host side of kernel A's all-pairs tile: the same-codes
check and the symmetric cost matrices, a LUT lane's one-code-set call, and
the kernel's byte-packed step per element.  Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iivision_tpu.ops import distance as jdist
from iivision_tpu.ops import editdist as jed
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import make_tables
from iivision_tpu_torch.ops import distance, editdist
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


@pytest.fixture(scope="module")
def sub():
    return jed.substitute_matrix(JPalette.NTSC)


@pytest.mark.parametrize("mode,n,tm,tn", [(VideoMode.DHGR, 64, 64, 128),
                                          (VideoMode.HGR, 32, 32, 128)])
def test_tile_matches_pallas_and_xla(sub, mode, n, tm, tn):
    codes = jed.lane_pixel_codes(jm(mode), 0).astype(np.int32)
    rows, cols = codes[:n], codes[512:512 + 4 * n]
    sub_f = jnp.asarray(sub.astype(np.float32))
    pallas = np.asarray(jed.pallas_distance(
        jnp.asarray(rows), jnp.asarray(cols), sub_f, tile_m=tm, tile_n=tn,
        interpret=True))
    xla = np.asarray(jed.dp_distance_tile(jnp.asarray(rows),
                                          jnp.asarray(cols), sub_f))
    got = editdist.dp_distance_tile(torch.as_tensor(rows),
                                    torch.as_tensor(cols),
                                    torch.as_tensor(sub))
    assert got.shape == (n, 4 * n) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), pallas.astype(np.int64))
    assert np.array_equal(got.numpy(), xla.astype(np.int64))
    # the all-pairs wrapper: uint16 like pallas_distance, plain on CPU
    wrapped = editdist.pair_distance(torch.as_tensor(rows),
                                     torch.as_tensor(cols),
                                     torch.as_tensor(sub))
    assert wrapped.dtype == torch.uint16
    assert np.array_equal(wrapped.numpy(), pallas)


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
def test_tile_matches_dam_lev_scalar(sub, mode):
    codes = jed.lane_pixel_codes(jm(mode), 1).astype(np.int32)
    rng = np.random.RandomState(9)
    idx = rng.randint(0, len(codes), 12)
    got = editdist.dp_distance_tile(torch.as_tensor(codes[idx]),
                                    torch.as_tensor(codes[idx]),
                                    torch.as_tensor(sub)).numpy()
    assert np.all(np.diag(got) == 0)
    assert np.array_equal(got, got.T)
    for i in range(0, 12, 3):
        for j in range(12):
            assert got[i, j] == jed.dam_lev_scalar(
                list(codes[idx[i]]), list(codes[idx[j]]), sub), (i, j)


def test_pair_distance_writes_out(sub):
    codes = torch.as_tensor(
        jed.lane_pixel_codes(JVideoMode.DHGR, 2)[:48].astype(np.int32))
    out = torch.zeros((48, 48), dtype=torch.uint16)
    res = editdist.pair_distance(codes, codes, torch.as_tensor(sub), out)
    assert res is out
    ref = jed.dp_distance_tile(jnp.asarray(codes.numpy()),
                               jnp.asarray(codes.numpy()),
                               jnp.asarray(sub.astype(np.float32)))
    assert np.array_equal(out.numpy(), np.asarray(ref).astype(np.uint16))
    with pytest.raises(ValueError, match="out must be"):
        editdist.pair_distance(codes, codes, torch.as_tensor(sub),
                               torch.zeros((48, 47), dtype=torch.uint16))


def test_make_tables_refuses_store_cost(monkeypatch):
    """A store-cost build for a card that is not there raises; it is not
    run anywhere else."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_tables.main(["--what", "store_cost", "--device", "cuda"])


def test_make_tables_store_cost_writes_the_shipped_table(tmp_path,
                                                        monkeypatch):
    """`--what store_cost` on the CPU asks `build_store_cost` for the DHGR
    NTSC window table and writes what it returns in the JAX package's npz
    layout: uint16 under "cost", equal to the shipped file.  (The build
    itself is held against the shipped npz in test_torch_distance; here it
    returns that npz.)"""
    want = np.load(jdist.store_cost_path(JVideoMode.DHGR, JPalette.NTSC,
                                         "window"))["cost"]
    calls = []

    def built(mode, palette, model, device):
        calls.append((mode, palette, model, device.type))
        return torch.as_tensor(want.astype(np.int32), device=device)

    monkeypatch.setattr(distance, "build_store_cost", built)
    make_tables.main(["--data_dir", str(tmp_path), "--modes", "DHGR",
                      "--palettes", "NTSC", "--what", "store_cost",
                      "--models", "window", "--device", "cpu"])
    assert calls == [(VideoMode.DHGR, Palette.NTSC, "window", "cpu")]
    path = jdist.store_cost_path(JVideoMode.DHGR, JPalette.NTSC, "window",
                                 str(tmp_path))
    got = np.load(path)["cost"]
    assert got.dtype == want.dtype == np.uint16
    assert np.array_equal(got, want)


def test_same_codes_and_symmetric_costs(sub):
    """The symmetric path needs one code set on both sides (a tensor or a
    view of the same storage with equal shape and strides: `same_codes`)
    and a symmetric cost matrix, which the kernel checks; both palettes'
    matrices are symmetric, and so are the distances they give."""
    codes = torch.as_tensor(
        jed.lane_pixel_codes(JVideoMode.DHGR, 0)[:40].astype(np.int32))
    assert editdist.same_codes(codes, codes)
    assert editdist.same_codes(codes, codes[:])
    assert not editdist.same_codes(codes, codes.clone())
    assert not editdist.same_codes(codes, codes[:39])
    assert not editdist.same_codes(codes[1:], codes[:39])
    for palette in (Palette.NTSC, Palette.IIGS):
        m = editdist.cost_matrix(palette, "cpu")
        assert torch.equal(m, m.T), palette
        d = editdist.dp_distance_tile(codes, codes, m)
        assert torch.equal(d, d.T), palette


def packed_step_distance(a, b, sub) -> int:
    """One pair as the all-pairs tile computes it: b's codes as bytes
    (code x 4) packed four to a 32-bit word; step k reads byte k of b as
    the offset into the cost row of a_k, and tests the transposition as
    one 32-bit compare of b's bytes (b_{k-1}, b_k, b_k, b_k) with
    a_k x 4 + a_{k-1} x 4 x 0x01010100; float32 sums."""
    words = [0] * ((len(b) + 3) // 4)
    for k, c in enumerate(b):
        words[k >> 2] |= (int(c) & 15) * 4 << (8 * (k & 3))

    def byte(k):
        return (words[k >> 2] >> (8 * (k & 3))) & 0xFF

    cost = np.asarray(sub, np.float32).reshape(-1)  # row a at a * 16
    ak = (int(a[0]) & 15) * 4
    d1, d2 = cost[ak * 4 + byte(0) // 4], np.float32(0)
    for k in range(1, len(a)):
        ap, ak = ak, (int(a[k]) & 15) * 4
        dk = np.float32(d1 + cost[ak * 4 + byte(k) // 4])
        if byte(k - 1) | byte(k) * 0x01010100 == ak + ap * 0x01010100:
            dk = min(dk, np.float32(d2 + 1))
        d2, d1 = d1, dk
    return int(d1)


@pytest.mark.parametrize("palette", [JPalette.NTSC, JPalette.IIGS])
@pytest.mark.parametrize("L", [10, 18])
def test_packed_step_matches_jax(L, palette):
    """The tile's byte-packed step equals the JAX package's scalar
    Damerau-Levenshtein oracle on random pairs, half of them one adjacent
    swap apart (the transposition branch)."""
    sub = jed.substitute_matrix(palette)
    rng = np.random.RandomState(L)
    pa = rng.randint(0, 16, (120, L))
    pb = rng.randint(0, 16, (120, L))
    for r in range(0, 120, 2):
        i = rng.randint(0, L - 1)
        pb[r] = pa[r]
        pb[r, i], pb[r, i + 1] = pa[r, i + 1], pa[r, i]
    for a, b in zip(pa, pb):
        want = jed.dam_lev_scalar(list(a), list(b), sub)
        assert packed_step_distance(a, b, sub) == want, (a, b)


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
@pytest.mark.parametrize("palette", [Palette.NTSC, Palette.IIGS])
def test_pair_distance_one_code_set_matches_jax(mode, palette):
    """A LUT lane's call, one code set on both sides under the port's cost
    matrix (the kernel's symmetric path on the card), equals the JAX
    package's XLA tile under its own matrix."""
    codes = editdist.lane_codes(mode, 1, "cpu")[100:164].contiguous()
    got = editdist.pair_distance(codes, codes,
                                 editdist.cost_matrix(palette, "cpu"))
    jsub = jed.substitute_matrix(JPalette[palette.name])
    want = jed.dp_distance_tile(jnp.asarray(codes.numpy()),
                                jnp.asarray(codes.numpy()),
                                jnp.asarray(jsub.astype(np.float32)))
    assert got.dtype == torch.uint16
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.uint16))
