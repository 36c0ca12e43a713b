"""The control of the check that decides `correct`: the plain reference put
in the program's place, one precision step below what the configuration
states (`reference/check.control_outputs`), judged by the same numbers
against the same limits.  It has to come out not correct.

    python3 -m benchmark.control --workload NAME --seeds 1,2,3 [--cpu]

runs it at the cell's own sizes on as many clips as a run checks, one
seed after another, and prints one JSON line per seed with each number
and the verdict.  It needs no measured window and imports nothing of the
program.
"""

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import drive, harness
from benchmark.gen import clips as gen
from benchmark.reference import check


def sample_clips(cfg: dict, tr: dict, seed: int, device):
    """As many clips as a run of the cell checks, made from `seed` by the
    cell's generator: ClipIns with frames already at every encoded
    frame."""
    rng = np.random.default_rng(seed & ((1 << 64) - 1))
    fps = float(cfg["source_fps"])
    every = int(cfg["every_n_video_frames"])
    copies = int(tr.get("copies", 1))
    n_frames = int(round(tr["clip_seconds"] * fps))
    if tr["client"] == "batch_pipelined":
        n = int(tr["sample_rounds"]) * int(tr["sample_movies"])
        F = len(range(0, n_frames, every))
        rgb = gen.synth_movies_device(gen.phases(rng, n), F, device)
        frames = [rgb[i] for i in range(n)]
    else:
        n = int(tr["sample_clips"])
        rgb = gen.synth_movies_device(gen.phases(rng, n), n_frames,
                                      device).cpu().numpy()
        frames = [gen.rolled(rgb[i], copies)[::every] for i in range(n)]
    waves = drive.waves(rng, cfg, tr["clip_seconds"] * copies, n)
    base = int(rng.integers(1, 1 << 30))
    return [check.ClipIn(f, w, base + i)
            for i, (f, w) in enumerate(zip(frames, waves))]


def control_numbers(workload: str, seed: int, device,
                    traffic_override: dict = None) -> dict:
    man = harness.manifest()
    w = harness.cell(man, workload)
    cfg = harness.config_of(man, w)
    tr = dict(harness.traffic_of(w), **(traffic_override or {}))
    clips = sample_clips(cfg, tr, seed, device)
    n_src = int(round(tr["clip_seconds"] * tr.get("copies", 1)
                      * float(cfg["source_fps"])))
    st = check.Setting(cfg, tr["ingest"], n_src, len(clips[0].wave), device)
    limits = check.load_limits(tr["client"])
    numbers = check.judge(st, clips, check.control_outputs(st, clips),
                          limits)
    return dict(numbers, correct=check.verdict(numbers, limits))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if args.cpu else "cuda")
    for s in args.seeds.split(","):
        out = control_numbers(args.workload, int(s), dev)
        print(json.dumps(dict(out, workload=args.workload, seed=int(s))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
