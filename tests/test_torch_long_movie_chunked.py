"""The long-movie path of iivision_tpu_torch on the CPU, chunked:
`encode_movie_chunked` against the port's whole-movie encode and the JAX
package's chunked encode, and `Movie` taking the streaming encoder past
its threshold (tests/test_torch_long_movie.py holds the rest of the path
and the helpers).  Exact (`np.array_equal`, equal bytes)."""

import numpy as np
import pytest

from iivision_tpu import encoder as jenc
from iivision_tpu_torch import encoder
from iivision_tpu_torch import movie as tmovie

from tests.test_encoder import get_dist, random_frames
from tests.test_pipeline import gradient_movie
from tests.test_torch_long_movie import (DHGR, HGR, assert_same, jm,
                                         torch_dist, transcode, whole_movie)

# --- chunked ----------------------------------------------------------------

CHUNKED_CASES = [(DHGR, None, 2, 1), (DHGR, 7, 3, 1), (DHGR, 7, 2, 4),
                 (HGR, 7, 2, 1)]


def chunked_inputs(mode, j):
    fmain, faux = random_frames(jm(mode), n_frames=6, seed=11)
    plan, n_enc = jenc.plan_movie(
        n_frames=6, n_audio_ticks=2400, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=jm(mode), k=8,
        j=j)
    assert n_enc == 6
    return fmain, faux, plan


@pytest.mark.parametrize("mode,seed,chunk,j", CHUNKED_CASES)
def test_chunked_matches_unchunked_and_jax(mode, seed, chunk, j):
    """The cases of tests/test_encoder.py's chunked test: records of every
    plan step and both final banks equal the port's whole-movie encode and
    the JAX package's chunked encode."""
    fmain, faux, plan = chunked_inputs(mode, j)
    got = encoder.encode_movie_chunked(torch_dist(mode), fmain, faux, plan,
                                       mode, seed=seed, chunk_frames=chunk)
    assert got[0].dtype == np.uint8
    assert got[0].shape == (len(plan.step_frame), 8 * j, 6)
    assert_same(got, whole_movie(fmain, faux, plan, mode, seed))
    assert_same(got, jenc.encode_movie_chunked(
        get_dist(jm(mode)), fmain, faux, plan, jm(mode), seed=seed,
        chunk_frames=chunk))


# --- Movie ---------------------------------------------------------------

@pytest.mark.parametrize("mode,joint", [(DHGR, False), (HGR, False),
                                        (DHGR, True)])
def test_movie_takes_the_streaming_encoder_past_the_threshold(
        tmp_path, monkeypatch, mode, joint):
    """With STREAM_MIN_FRAMES lowered, the same in-memory clip takes
    `encode_movie_streaming` (segments of 2 frames) and gives the same
    bytes, final screens and targets."""
    rgb = gradient_movie(F=10)
    kw = dict(frames_source=rgb, video_mode=mode, dist=torch_dist(mode),
              joint_content=joint, stream_chunk_frames=2)
    m_whole, want = transcode(tmp_path, "whole.a2m", **kw)
    assert m_whole.encoder_used == "whole"
    monkeypatch.setattr(tmovie, "STREAM_MIN_FRAMES", 3)
    m, got = transcode(tmp_path, "stream.a2m", **kw)
    assert m.encoder_used == "streaming"
    assert got == want
    assert np.array_equal(m.final_main, m_whole.final_main)
    assert np.array_equal(m.final_aux, m_whole.final_aux)
    n = len(m.frames.targets_main)
    assert n >= int(m.plan.step_frame.max()) + 1
    assert np.array_equal(m.frames.targets_main,
                          m_whole.frames.targets_main[:n])
