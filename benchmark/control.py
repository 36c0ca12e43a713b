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
from benchmark.reference import check


def sample_clips(cfg: dict, tr: dict, seed: int, device):
    """As many clips as a run of the cell checks, made from `seed` by the
    generator of the cell's client (its `Client.control_clips`): ClipIns
    with frames already at every encoded frame, each with its own
    length."""
    rng = np.random.default_rng(seed & ((1 << 64) - 1))
    return drive.client(tr["client"]).control_clips(cfg, tr, rng, device)


def control_numbers(workload: str, seed: int, device,
                    traffic_override: dict = None) -> dict:
    man = harness.manifest()
    w = harness.cell(man, workload)
    cfg = harness.config_of(man, w)
    tr = dict(harness.traffic_of(w), **(traffic_override or {}))
    clips = sample_clips(cfg, tr, seed, device)
    st = check.Setting(cfg, tr["ingest"], device)
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
