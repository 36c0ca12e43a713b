"""The batch transcode in iivision_tpu_torch (parallel.mesh,
encoder.encode_movies, the CLI's several-input mode) on the CPU: the
compact op fetch, the mesh rules and the CLI's batch mode, with the
helpers of the split-off files (tests/test_torch_batch_solo.py: seeded
batches byte-equal to the JAX package's `iivision_tpu.parallel.mesh`,
each movie equal to its solo encode; tests/test_torch_batch_mixed.py:
mixed-length batches; tests/test_torch_mesh.py runs sharded batches)."""

import json
import os

import numpy as np
import pytest
import torch

from iivision_tpu import encoder as jenc
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import cli, encoder, frames
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.parallel import mesh
from iivision_tpu_torch.sim import PlayerVM
from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_encoder import random_frames
from tests.test_pipeline import gradient_movie
from tests.test_torch_joint import torch_dist

DHGR = VideoMode.DHGR
HGR = VideoMode.HGR


def jm(mode):
    """The JAX package's VideoMode member of the port's `mode`."""
    return JVideoMode[mode.name]


def batch_targets(mode, B, n_frames, seed):
    """B movies' distinct random targets, stacked: numpy (main, aux)."""
    mains, auxes = zip(*(random_frames(jm(mode), n_frames, seed + i)
                         for i in range(B)))
    return np.stack(mains), (np.stack(auxes) if mode == DHGR else None)


def flat_plan(mode, k, j):
    plan, _ = jenc.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=14700.0 / 350,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=jm(mode),
        k=k, j=j)
    return plan


def test_fetch_ops_compact_matches_flatten():
    """The static-index gather of valid ops equals flatten_ops of the
    padded view, movie by movie."""
    plan = flat_plan(DHGR, 4, 2)
    main, aux = batch_targets(DHGR, 3, 2, 80)
    lanes, bytes_ = encoder.prepare_targets(main, aux, DHGR, "cpu")
    ops, _, _ = mesh.encode_movies_batch(torch_dist(DHGR), lanes, bytes_,
                                         plan, DHGR, seeds=[0, 1, 2])
    compact = mesh.fetch_ops_compact(ops, plan)
    full = mesh.fetch_ops(ops, plan)
    assert compact.shape == (3, plan.n_ops, 6)
    for i in range(3):
        assert np.array_equal(compact[i], encoder.flatten_ops(full[i], plan))


@pytest.mark.parametrize("bad", [2, 4, ["cuda:0", "cuda:1"]])
def test_mesh_refuses_more_than_one_card(bad):
    """The mesh rules: a mesh must divide the batch (one movie on a CPU
    mesh of 2 or 4 entries is refused), and may name no card the host
    lacks; a one-entry mesh runs unsharded and returns tensors."""
    plan = flat_plan(DHGR, 8, 1)
    main, aux = batch_targets(DHGR, 1, 2, 0)
    lanes, bytes_ = encoder.prepare_targets(main, aux, DHGR, "cpu")
    if isinstance(bad, int):
        bad, match = mesh.make_mesh(bad, "cpu"), "does not split"
    else:
        match = "this host has %d CUDA card" % torch.cuda.device_count()
    with pytest.raises(ValueError, match=match):
        mesh.encode_movies_batch(torch_dist(DHGR), lanes, bytes_, plan,
                                 DHGR, seeds=[0], mesh=bad)
    for one in (torch.device("cpu"), ["cpu"]):
        ops, _, _ = mesh.encode_movies_batch(torch_dist(DHGR), lanes, bytes_,
                                             plan, DHGR, seeds=[0], mesh=one)
        assert isinstance(ops, torch.Tensor) and ops.shape[0] == 1


def test_cli_batch_transcodes_on_cpu(tmp_path, capsys):
    """Two clips of different length through the CLI's batch mode with
    --joint_content and --mesh auto: each stream plays in the player VM at
    its own op count, and the shorter one equals its padded solo encode
    (joint, seed args.seed + 1)."""
    clips = []
    for name, F in (("long", 6), ("short", 2)):
        path = str(tmp_path / ("%s.npy" % name))
        np.save(path, gradient_movie(F=F))
        clips.append(path)
    out_dir = str(tmp_path / "out")
    stats_path = str(tmp_path / "stats.json")
    cli.main(clips + ["--device", "cpu", "--output", out_dir, "--seed", "5",
                      "--joint_content", "--mesh", "auto", "--stats_json",
                      stats_path])
    assert capsys.readouterr().out.count("Wrote ") == 2
    rows = json.load(open(stats_path))
    assert [r["batch_size"] for r in rows] == [2, 2]
    vm = PlayerVM()
    for row in rows:
        res = vm.decode(open(row["output"], "rb").read())
        assert res.ok and res.n_ops == row["n_ops"] > 0
    assert rows[0]["n_ops"] > rows[1]["n_ops"]
    assert sorted(os.listdir(out_dir)) == ["long.a2m", "short.a2m"]

    # the short clip, padded to the batch's plan and encoded alone
    fr = [frames.ingest(c, DHGR, Palette.NTSC, every_n_video_frames=2)
          for c in clips]
    ticks = [int(f.n_frames_total / f.input_frame_rate * 14700) + 1
             for f in fr]
    plan_max, n_enc = encoder.plan_movie(
        n_frames=fr[0].n_frames_total, n_audio_ticks=max(ticks),
        input_frame_rate=fr[0].input_frame_rate, ticks_per_second=14700.0,
        every_n_video_frames=2, mode=DHGR, k=8)

    def pad(t):
        reps = max(0, n_enc - len(t))
        return np.concatenate([t, np.repeat(t[-1:], reps, 0)])[:n_enc]

    lanes, bytes_ = encoder.prepare_targets(
        pad(fr[1].targets_main), pad(fr[1].targets_aux), DHGR, "cpu")
    ops, _, _ = encoder.encode_movie(torch_dist(DHGR), lanes, bytes_,
                                     plan_max, DHGR, seed=6, joint=True)
    solo = encoder.flatten_ops(ops.numpy(), plan_max)[:rows[1]["n_ops"]]
    levels = np.zeros(len(solo), np.int32)
    assert emit_stream_fast(solo, levels, DHGR) == open(
        rows[1]["output"], "rb").read()
