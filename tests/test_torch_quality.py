"""The quality scorer in iivision_tpu_torch (quality.score_screens and
replay_frame_errors) on the CPU against iivision_tpu.quality, on one
encoded stream, under the window and yiq colour models.  Every lane
distance is an integer, so the means agree to float32 rounding: the
tolerance is rtol 1e-6."""

import functools

import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu import quality as jquality
from iivision_tpu.ops import distance as jdist
from iivision_tpu.palettes import Palette as JPalette
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import encoder, quality
from iivision_tpu_torch.ops import distance
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_encoder import random_frames

DHGR = VideoMode.DHGR
HGR = VideoMode.HGR


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


@functools.lru_cache(None)
def dists(mode, model):
    return (jdist.ComputedDistance(jm(mode), JPalette.NTSC, model),
            distance.ComputedDistance(mode, Palette.NTSC, model,
                                      device="cpu"))


@pytest.mark.parametrize("mode,model", [(DHGR, "window"), (DHGR, "yiq"),
                                        (HGR, "window")])
def test_replay_frame_errors_match_jax(mode, model):
    """A 3-frame seeded stream, replayed and scored at each encoded
    frame's end by both packages; then score_screens alone on the replayed
    screens, with targets given as a tensor."""
    jd, td = dists(mode, model)
    fmain, faux = random_frames(jm(mode), n_frames=3, seed=12)
    plan, _ = jenc.plan_movie(
        n_frames=3, n_audio_ticks=1500, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=jm(mode), k=8)
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, mode, "cpu")
    ops, _, _ = encoder.encode_movie(td, lanes, bytes_tgt, plan, mode,
                                     seed=1)
    flat = encoder.flatten_ops(ops.numpy(), plan)

    want = jquality.replay_frame_errors(flat, plan, lanes.numpy(), jm(mode),
                                        jd)
    got = quality.replay_frame_errors(flat, plan, lanes, mode, td)
    assert got.frame_errors.shape == want.frame_errors.shape == (3,)
    assert got.frame_errors.dtype == np.float32
    np.testing.assert_allclose(got.frame_errors, want.frame_errors,
                               rtol=1e-6)
    assert got.mean_error == pytest.approx(want.mean_error, rel=1e-6)
    assert got.final_error == pytest.approx(want.final_error, rel=1e-6)
    assert got.mean_error > 0

    op_bank = np.repeat(plan.step_bank, plan.step_nvalid)
    states = quality.replay_ops(flat, op_bank, np.array([len(flat) - 1]))
    states = np.concatenate([states, np.zeros_like(states)])
    tl = lanes[[2, 0]]
    want = jquality.score_screens(states, tl.numpy(), jm(mode), jd.sub)
    got = quality.score_screens(states, tl, mode, td.sub)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert isinstance(tl, torch.Tensor)
