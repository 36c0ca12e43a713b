"""iivision_tpu_torch needs no JAX: its entry points import, and tiny DHGR
and HGR yiq encodes, a B=2 batch encode with joint content, a batch
ingest, a replay score and the sub-op microbenchmark run, in a process
where importing jax fails.  `bench.synth_clip`, which chip_smoke.py uses,
imports there too."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys


class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())

import numpy as np

import iivision_tpu_torch
import iivision_tpu_torch.cli
import iivision_tpu_torch.make_tables
from iivision_tpu_torch import bench_subop, encoder, quality
from iivision_tpu_torch.movie import Movie
from iivision_tpu_torch.ops import distance, dither, resize, yiq
from iivision_tpu_torch.parallel import mesh
import bench
import torch
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode

mode = VideoMode.DHGR
dist = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
rng = np.random.RandomState(0)
fmain = rng.randint(0, 0x80, (1, 32, 256)).astype(np.uint8)
faux = rng.randint(0, 0x80, (1, 32, 256)).astype(np.uint8)
plan, _ = encoder.plan_movie(
    n_frames=1, n_audio_ticks=300, input_frame_rate=30.0,
    ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8)
lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, mode, "cpu")
ops, main, aux = encoder.encode_movie(dist, lanes, bytes_tgt, plan, mode,
                                      seed=0)
flat = encoder.flatten_ops(ops.numpy(), plan)
assert flat.shape == (plan.n_ops, 6) and plan.n_ops > 0

hgr = VideoMode.HGR
dist = distance.ComputedDistance(hgr, Palette.NTSC, "yiq", device="cpu")
plan, _ = encoder.plan_movie(
    n_frames=1, n_audio_ticks=300, input_frame_rate=30.0,
    ticks_per_second=14700.0, every_n_video_frames=1, mode=hgr, k=8)
lanes, bytes_tgt = encoder.prepare_targets(fmain, None, hgr, "cpu")
ops, main, aux = encoder.encode_movie(dist, lanes, bytes_tgt, plan, hgr,
                                      seed=0)
assert yiq.lane_windows(lanes[0, ..., 1], hgr, 1).shape == (32, 128, 15)

clip = torch.as_tensor(np.stack([bench.synth_clip(seconds=0.1, phase=p)
                                 for p in (0.0, 1.0)]))
lanes_b, bytes_b = mesh.ingest_movies_batch(clip, mode, Palette.NTSC)
assert lanes_b.shape == (2, 3, 32, 128, 4)
dist = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
plan, _ = encoder.plan_movie(
    n_frames=3, n_audio_ticks=400, input_frame_rate=30.0,
    ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=4)
ops_b, _, _ = mesh.encode_movies_batch(dist, lanes_b, bytes_b, plan, mode,
                                       seeds=[0, 1], joint=True)
flat_b = mesh.fetch_ops_compact(ops_b, plan)
assert flat_b.shape == (2, plan.n_ops, 6)
rep = quality.replay_frame_errors(flat_b[0], plan, lanes_b[0], mode, dist)
assert rep.mean_error > 0
recs = bench_subop.run("cpu", B=1, K=2, ts=(2,),
                       variants=("plain", "plain_i16"))
assert len(recs) == 2
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
# the compile-cache opt-out was set only while the shared package loaded
import os
assert "IIVISION_NO_COMPILE_CACHE" not in os.environ
print("no-jax ok", plan.n_ops)
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("IIVISION_NO_COMPILE_CACHE", None)  # the port sets it itself
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax ok" in proc.stdout


def test_port_sources_do_not_import_jax():
    pkg = os.path.join(REPO, "iivision_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert "import jax" not in text and "from jax" not in text, \
                    name
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        text = f.read()
    assert "import jax" not in text and "from jax" not in text
