"""The shipped mode x palette x colour model settings and the solo
headline's (k, j) = (32, 10) through both packages' Movie on the CPU:
IIGS under DHGR and HGR (window, HGR yiq, DHGR joint content) and DHGR
NTSC at k=32 j=10 (seeded, deterministic and joint).  The HGR IIGS yiq
store-cost table is not shipped: the port builds it, its sampled rows are
held to the JAX `dist_lane_pairs`, and both packages read it from a
temporary user cache.  chip_smoke.py's copy of the quality matrix
(tests/quality_matrix_common.py) is held to the original.  Every
comparison is exact: stream bytes, final screens, integer costs, clip
and tone arrays."""

import os

import numpy as np
import pytest

import chip_smoke
from iivision_tpu import movie as jmovie
from iivision_tpu.ops import distance as jdist
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch.ops import distance
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

from tests import quality_matrix_common as qmc
from tests.test_torch_pipeline import check_movie_matches_jax

DHGR, HGR = VideoMode.DHGR, VideoMode.HGR
NTSC, IIGS = Palette.NTSC, Palette.IIGS

# (mode, palette, colour model, k, j, seed, joint content)
CASES = [(DHGR, IIGS, "window", 8, 1, 0, False),
         (HGR, IIGS, "window", 8, 1, 0, False),
         (HGR, IIGS, "yiq", 8, 1, 0, False),
         (DHGR, IIGS, "window", 16, 4, 0, True),
         (DHGR, NTSC, "window", 32, 10, 0, False),
         (DHGR, NTSC, "window", 32, 10, None, False),
         (DHGR, NTSC, "window", 32, 10, 0, True)]


def case_id(case):
    mode, pal, model, k, j, seed, joint = case
    return "%s-%s-%s-k%d-j%d-seed%s%s" % (mode.name, pal.name, model, k, j,
                                          seed, "-joint" if joint else "")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A user cache (XDG_CACHE_HOME) holding the port-built HGR IIGS yiq
    table, written before any Movie is made; returns (cache root, the
    built (n_lanes, 2^14, 256) int32 table).  Both packages' table
    lookups run with this cache, never the real one; JAX's in-process
    table cache is emptied before and after, so no table read here serves
    a later test."""
    root = str(tmp_path_factory.mktemp("xdg_cache"))
    built = distance.build_store_cost(HGR, IIGS, "yiq", "cpu").numpy()
    distance.save_store_cost(built.astype(np.float32), HGR, IIGS, "yiq",
                             os.path.join(root, "iivision_tpu"))
    jdist.store_cost_table.cache_clear()
    yield root, built
    jdist.store_cost_table.cache_clear()


def test_hgr_iigs_yiq_table_rows_equal_jax(cache, monkeypatch):
    """64 sampled target rows per HGR lane of the port-built IIGS yiq
    table equal the JAX `dist_lane_pairs` on the same targets and
    contents, float for integer; the port's lookup reads the saved table
    back from the temporary cache as the same int16 costs."""
    root, built = cache
    monkeypatch.setenv("XDG_CACHE_HOME", root)
    assert built.shape == (2, 1 << 14, 256)
    assert 0 <= built.min() and built.max() < 1 << 15
    table = distance.store_cost_table(HGR, IIGS, "yiq", "cpu")
    assert np.array_equal(table, built.astype(np.int16))

    from iivision_tpu import screen as jscreen
    import jax.numpy as jnp

    spec = jscreen.spec_for_mode(JVideoMode.HGR)
    sub = jnp.asarray(jdist.sub_for(JVideoMode.HGR, JPalette.IIGS, "yiq"))
    rng = np.random.RandomState(12)
    c = np.arange(256)[None, :]
    for lane in range(2):
        for _ in range(4):
            t = rng.randint(0, 1 << 14, 16)[:, None] + 0 * c  # (16, 256)
            want = np.asarray(jdist.dist_lane_pairs(
                jnp.asarray(spec.masked_update(t, c, lane)), jnp.asarray(t),
                JVideoMode.HGR, lane, sub))
            assert want.dtype == np.float32
            assert np.array_equal(built[lane, t[:, 0]].astype(np.float32),
                                  want)


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_movie_matches_jax_movie(cache, monkeypatch, tmp_path, case):
    """A 4-frame gradient clip with 14,700 Hz audio, every 2nd frame
    (tests/test_torch_pipeline.py `check_movie_matches_jax`): the port's
    Movie writes the JAX Movie's .a2m bytes and ends on its final
    screens, and the stream plays in the port's player VM to those
    screens with the audio's duty cycles."""
    mode, pal, model, k, j, seed, joint = case
    monkeypatch.setenv("XDG_CACHE_HOME", cache[0])
    check_movie_matches_jax(tmp_path, mode, palette=pal, k=k, j=j, seed=seed,
                            colour_model=model, joint_content=joint)


class _Stop(Exception):
    pass


def test_smoke_matrix_copy_equals_quality_matrix_common(monkeypatch):
    """chip_smoke.py's matrix: the same 12 row keys with the same clip,
    mode, palette and colour model (by name), the same two clips byte for
    byte (clip A the port bench's `synth_clip`), and `compute_row`'s
    encoder setting and tone (caught at its Movie call)."""
    want = [(key, clip, mode.name, pal.name, model)
            for key, clip, mode, pal, model in qmc.ROWS]
    assert list(chip_smoke.MATRIX_ROWS) == want
    assert chip_smoke.MATRIX_SECONDS == qmc.CLIP_SECONDS
    clips = chip_smoke.matrix_clips()
    assert clips["sweep"].dtype == np.uint8
    assert np.array_equal(clips["sweep"], qmc.clip_sweep())
    assert np.array_equal(clips["blocks"], qmc.clip_blocks())

    seen = {}

    def record(**kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(jmovie, "Movie", record)
    with pytest.raises(_Stop):
        qmc.compute_row(clips["blocks"], JVideoMode.HGR, JPalette.IIGS, "yiq")
    assert seen["video_mode"] == JVideoMode.HGR
    assert seen["palette"] == JPalette.IIGS
    assert seen["colour_model"] == "yiq"
    for name, value in chip_smoke.MATRIX_SETTING.items():
        assert seen[name] == value, name
    ref = seen["audio_source"]
    got = chip_smoke.tone_levels("cpu", chip_smoke.MATRIX_SECONDS)
    assert got._data.dtype == ref._data.dtype == np.float32
    assert np.array_equal(got._data, ref._data)
    assert (got._rate, got.sample_rate) == (ref._rate, ref.sample_rate)
    assert np.array_equal(got.levels(), ref.levels())
