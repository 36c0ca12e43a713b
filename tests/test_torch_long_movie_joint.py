"""The long-movie path of iivision_tpu_torch on the CPU, joint content:
`encode_movie_chunked` and `encode_movie_streaming` with joint content
against the port's whole-movie encode and the JAX package's segmented
encoders (tests/test_torch_long_movie.py holds the rest of the path and
the helpers).  Exact (`np.array_equal`)."""

import numpy as np
import pytest

from iivision_tpu import encoder as jenc
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import encoder

from tests.test_encoder import get_dist, random_frames
from tests.test_torch_long_movie import (DHGR, assert_same, batches,
                                         torch_dist, whole_movie)


@pytest.mark.parametrize("which", ["chunked", "streaming"])
def test_joint_segments_match_unchunked_and_jax(which):
    """Joint content through the segmented encoders (k=4, j=2)."""
    main, aux = random_frames(JVideoMode.DHGR, 5, seed=8)
    plan, _ = jenc.plan_movie(
        n_frames=5, n_audio_ticks=1800, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1,
        mode=JVideoMode.DHGR, k=4, j=2)
    ref = whole_movie(main, aux, plan, DHGR, 2, joint=True)
    assert not np.array_equal(ref[0], whole_movie(main, aux, plan, DHGR,
                                                  2)[0])
    jd = get_dist(JVideoMode.DHGR)
    if which == "chunked":
        got = encoder.encode_movie_chunked(
            torch_dist(DHGR), main, aux, plan, DHGR, seed=2, chunk_frames=2,
            joint=True)
        want = jenc.encode_movie_chunked(
            jd, main, aux, plan, JVideoMode.DHGR, seed=2, chunk_frames=2,
            joint=True)
    else:
        got = encoder.encode_movie_streaming(
            torch_dist(DHGR), batches(main, aux, (1, 4)), plan, DHGR, seed=2,
            chunk_frames=2, joint=True)[:3]
        want = jenc.encode_movie_streaming(
            jd, batches(main, aux, (1, 4)), plan, JVideoMode.DHGR, seed=2,
            chunk_frames=2, joint=True)[:3]
    assert_same(got, ref)
    assert_same(got, want)
