"""The port's host tools against the JAX package's: `encoder_host` (the
numpy oracle of the encoder) op for op with its final screens, the port's
deterministic encode on the CPU against that oracle, and `encoder_parity`
(the reference-order k=1 greedy) op for op.  All bit-exact.  The plans
are tests/test_encoder.py's 2-frame, 700-tick differential plan."""

import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu import encoder_host as jhost
from iivision_tpu import encoder_parity as jparity
from iivision_tpu_torch import encoder, encoder_host, encoder_parity
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_encoder import get_dist, random_frames
from tests.test_torch_batch import jm
from tests.test_torch_joint import joint_plan, torch_dist

DHGR = VideoMode.DHGR
HGR = VideoMode.HGR
CASES = [(DHGR, 4, 2, False), (HGR, 4, 3, False), (DHGR, 4, 2, True)]


def targets(mode, seed=3):
    """Both packages' targets of the same random frames."""
    fmain, faux = random_frames(jm(mode), n_frames=2, seed=seed)
    lanes, bytes_ = encoder.prepare_targets(fmain, faux, mode, "cpu")
    j_lanes, j_bytes = jenc.prepare_targets(fmain, faux, jm(mode))
    return lanes, bytes_, np.asarray(j_lanes), np.asarray(j_bytes)


def jax_replay(mode, plan, lanes, bytes_, joint):
    """JAX's HostEncoder over the plan: (ops, final banks)."""
    henc = jhost.HostEncoder(jm(mode), get_dist(jm(mode)), k=plan.k,
                             seed=None, j=plan.j, joint=joint)
    ops = []
    for s in range(len(plan.step_frame)):
        f, b = int(plan.step_frame[s]), int(plan.step_bank[s])
        if plan.step_recompute[s]:
            henc.recompute(lanes[f], b)
        ops.extend(henc.step(bytes_[f, b], f, b, int(plan.step_nvalid[s])))
    return np.asarray(ops, np.int32), henc.banks


@pytest.mark.parametrize("mode,k,j,joint", CASES)
def test_host_oracle_matches_jax(mode, k, j, joint):
    """encode_movie_host and a HostEncoder replay equal JAX's oracle: every
    op, and the final banks."""
    plan = joint_plan(mode, k, j)
    lanes, bytes_, j_lanes, j_bytes = targets(mode)
    want_ops, want_banks = jax_replay(mode, plan, j_lanes, j_bytes, joint)
    got = encoder_host.encode_movie_host(torch_dist(mode), lanes, bytes_,
                                         plan, mode, joint=joint)
    assert got.dtype == np.int32 and got.shape == (plan.n_ops, 6)
    assert np.array_equal(got, want_ops)
    henc = encoder_host.HostEncoder(mode, torch_dist(mode), k=k, j=j,
                                    joint=joint)
    assert np.array_equal(
        np.asarray(encoder_host.run_plan(henc, lanes, bytes_, plan),
                   np.int32), want_ops)
    assert np.array_equal(henc.banks, want_banks)


@pytest.mark.parametrize("mode,k,j,joint", CASES)
def test_deterministic_encode_matches_the_oracle(mode, k, j, joint):
    """The port's deterministic (seed None) encode_movies on the CPU, two
    movies at once, equals the port's oracle on each: ops and final
    screens."""
    plan = joint_plan(mode, k, j)
    movies = [targets(mode, seed)[:2] for seed in (3, 8)]
    lanes = np.stack([m[0].numpy() for m in movies])
    bytes_ = np.stack([m[1].numpy() for m in movies])
    ops, fin_main, fin_aux = encoder.encode_movies(
        torch_dist(mode), torch.as_tensor(lanes), torch.as_tensor(bytes_),
        plan, mode, None, joint)
    for i, (ln, by) in enumerate(movies):
        henc = encoder_host.HostEncoder(mode, torch_dist(mode), k=k, j=j,
                                        joint=joint)
        want = np.asarray(encoder_host.run_plan(henc, ln, by, plan))
        assert np.array_equal(encoder.flatten_ops(ops[i].numpy(), plan),
                              want), i
        assert np.array_equal(fin_main[i].numpy(), henc.banks[0])
        assert np.array_equal(fin_aux[i].numpy(), henc.banks[-1])


@pytest.mark.parametrize("mode", [DHGR, HGR])
def test_reference_order_matches_jax(mode):
    """encode_movie_reference_order equals JAX's op for op on a k=1 plan
    (tests/test_parity_reference.py's), is deterministic, and refuses a
    plan with k > 1."""
    fmain, faux = random_frames(jm(mode), n_frames=2, seed=42)
    plan, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=2400, input_frame_rate=12.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode,
        k=1, j=1)
    lanes, bytes_ = encoder.prepare_targets(fmain, faux, mode, "cpu")
    j_lanes, j_bytes = jenc.prepare_targets(fmain, faux, jm(mode))
    want = jparity.encode_movie_reference_order(
        get_dist(jm(mode)), j_lanes, j_bytes, plan, jm(mode))
    got = encoder_parity.encode_movie_reference_order(
        torch_dist(mode), lanes, bytes_, plan, mode)
    assert got.shape == (plan.n_ops, 6) and got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got, encoder_parity.encode_movie_reference_order(
        torch_dist(mode), lanes.numpy(), bytes_.numpy(), plan, mode))
    plan_k8, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=2400, input_frame_rate=12.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8)
    with pytest.raises(ValueError, match="k=1, j=1"):
        encoder_parity.encode_movie_reference_order(
            torch_dist(mode), lanes, bytes_, plan_k8, mode)
