"""The port's mixed-length batch (`encode_movies_mixed`) against the JAX
package's, op for op (split from tests/test_torch_batch.py, which holds
the helpers, so that `--dist loadfile` spreads them).  Exact
(`np.array_equal`)."""

import numpy as np
import pytest

from iivision_tpu.parallel import mesh as jmesh
from iivision_tpu_torch.parallel import mesh

from tests.test_encoder import get_dist, random_frames
from tests.test_torch_batch import DHGR, jm
from tests.test_torch_joint import torch_dist


@pytest.mark.parametrize("specs,fps,tps", [
    # tests/test_mesh.py:26: (n_input_frames, n_ticks, seed)
    ([(4, 2000, 0), (2, 900, 1)], 12.0, 14700.0),
    # tests/test_mesh.py:65: a long-audio, short-video movie
    ([(2, 1398, 0), (4, 500, 1)], 1.0, 350.0),
])
def test_mixed_matches_jax(specs, fps, tps):
    """encode_movies_mixed (shared dominating plan, last-frame padding,
    each movie cut to its own n_ops) equals the JAX one op for op."""
    movies = []
    for nf, nt, sd in specs:
        main, aux = random_frames(jm(DHGR), nf, 40 + sd)
        movies.append((main, aux, nf, nt))
    seeds = [sd + 3 for _, _, sd in specs]
    kw = dict(input_frame_rate=fps, ticks_per_second=tps,
              every_n_video_frames=1, k=8, seeds=seeds)
    j_flats, j_plan, j_n = jmesh.encode_movies_mixed(
        get_dist(jm(DHGR)), movies, jm(DHGR), **kw)
    flats, plan_max, n_ops = mesh.encode_movies_mixed(
        torch_dist(DHGR), movies, DHGR, **kw)
    assert n_ops == j_n and plan_max.n_ops == j_plan.n_ops
    for got, want in zip(flats, j_flats):
        assert got.shape == want.shape
        assert np.array_equal(got, want)
