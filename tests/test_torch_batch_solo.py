"""The port's batch encode against the JAX package's vmapped scan and
against its own solo encodes, DHGR and HGR at (k, j) = (8, 1) and (4, 2)
(split from tests/test_torch_batch.py, which holds the helpers, so that
`--dist loadfile` spreads them).  Exact (`np.array_equal`)."""

import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu.parallel import mesh as jmesh
from iivision_tpu_torch import encoder
from iivision_tpu_torch.parallel import mesh

from tests.test_encoder import get_dist
from tests.test_torch_batch import DHGR, HGR, batch_targets, flat_plan, jm
from tests.test_torch_joint import torch_dist


@pytest.mark.parametrize("mode", [DHGR, HGR])
@pytest.mark.parametrize("k,j", [(8, 1), (4, 2)])
def test_batch_matches_jax_and_solo(mode, k, j):
    """Three distinct movies with seeds 4, 9, 2: the port's flat batch ops
    and final screens equal the JAX vmapped scan's, and each movie equals
    the port's solo encode with its own seed."""
    B, seeds = 3, [4, 9, 2]
    plan = flat_plan(mode, k, j)
    main, aux = batch_targets(mode, B, 2, 30)
    F = main.shape[1]
    j_lanes, j_bytes = jenc.prepare_targets(
        main.reshape(B * F, 32, 256),
        None if aux is None else aux.reshape(B * F, 32, 256), jm(mode))
    j_lanes = np.asarray(j_lanes).reshape((B, F) + j_lanes.shape[1:])
    j_bytes = np.asarray(j_bytes).reshape((B, F) + j_bytes.shape[1:])
    j_ops, j_main, j_aux = jmesh.encode_movies_batch(
        get_dist(jm(mode)), j_lanes, j_bytes, plan, jm(mode), seeds=seeds)
    S = len(plan.step_frame)
    want = jmesh.fetch_ops(j_ops, plan)[:, :S]

    lanes, bytes_ = encoder.prepare_targets(main, aux, mode, "cpu")
    assert np.array_equal(lanes.numpy(), j_lanes)
    assert np.array_equal(bytes_.numpy(), j_bytes)
    ops, fin_main, fin_aux = mesh.encode_movies_batch(
        torch_dist(mode), lanes, bytes_, plan, mode, seeds=seeds)
    assert ops.shape == (B, S * k * j * 6) and ops.dtype == torch.uint8
    got = mesh.fetch_ops(ops, plan)
    assert np.array_equal(got, want)
    assert np.array_equal(fin_main.numpy(), np.asarray(j_main))
    assert np.array_equal(fin_aux.numpy(), np.asarray(j_aux))
    for i in range(B):
        solo, solo_main, _ = encoder.encode_movie(
            torch_dist(mode), lanes[i], bytes_[i], plan, mode,
            seed=seeds[i])
        assert np.array_equal(solo.numpy(), got[i]), i
        assert np.array_equal(solo_main.numpy(), fin_main[i].numpy())
