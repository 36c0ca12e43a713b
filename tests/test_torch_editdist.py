"""iivision_tpu_torch edit-distance tiles against the JAX package's Pallas
kernel (interpret mode), its XLA tile and the scalar Damerau-Levenshtein
oracle: exact equality."""

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
