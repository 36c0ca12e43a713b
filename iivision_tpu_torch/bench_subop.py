"""Sub-op microbenchmark on a torch device (counterpart of
tools/bench_subop_pallas.py).

    python -m iivision_tpu_torch.bench_subop --device cuda

Times T sequential sub-op selections on (B*K, 256) float32 state
(ops/subop_bench.py) in three variants:

  plain:      an eager torch loop, one sub-op after another (the tool's
              `xla`);
  kernel:     kernel C, all T sub-ops in one launch (the tool's `pallas`);
  plain_i16:  the eager loop with int16 state between sub-ops and int32
              math (the tool's `xla_i16`).

T is swept over `--ts`; each point is the best of 3 runs after a
synchronised warm-up, timed with CUDA events on a card (the host clock on
the CPU).  A fit of intercept + slope*T per variant separates the fixed
per-call cost from the marginal cost of one sub-op.  For every T the
float variants run once more on the same inputs: their final states must
be bit-equal, and each record carries the float64 sum of the state as its
digest.  One JSON line per point and per fit goes to standard output, and
to `--out` when it is given.  `kernel` runs only on a CUDA device.
"""

import argparse
import json
import time

import numpy as np
import torch

from iivision_tpu_torch import require_device
from iivision_tpu_torch.ops import subop_bench

REPS = 3  # timed runs per point; the best is kept
VARIANTS = {
    "plain": subop_bench.run_plain,
    "kernel": subop_bench.run_kernel,
    "plain_i16": subop_bench.run_plain_i16,
}


def fresh(R: int, salt: int, device):
    """Seeded (up, dw, by, tb): uniform rows scaled by 100, 50, 30 and 20
    (the tool's `fresh`)."""
    r = np.random.RandomState(salt)
    return [torch.as_tensor(r.rand(R, 256).astype(np.float32) * s,
                            device=device)
            for s in (100.0, 50.0, 30.0, 20.0)]


def _seconds(fn, args, device) -> float:
    """Seconds of one call fn(*args), to its last device op."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def run(device, B: int = 32, K: int = 16, ts=(100, 400, 1000),
        variants=("plain", "kernel", "plain_i16"), emit=None):
    """Sweep T for each variant; returns the point and fit records.

    emit(record) is called on each record as it is made.  Raises if the
    float variants' final states differ."""
    device = require_device(device)
    if "kernel" in variants and device.type != "cuda":
        raise ValueError("variant 'kernel' needs a CUDA device, got %s"
                         % device)
    emit = emit or (lambda rec: None)
    R = B * K
    where = dict(B=B, K=K, device=str(device))
    if device.type == "cuda":
        where["device_name"] = torch.cuda.get_device_name(device)
    records = []

    def put(rec):
        records.append(rec)
        emit(rec)

    points = {name: [] for name in variants}
    for T in ts:
        states = {}
        for name in variants:
            fn = VARIANTS[name]
            t0 = time.perf_counter()
            fn(*fresh(R, 1, device), T)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            warmup_s = time.perf_counter() - t0
            best = min(_seconds(fn, fresh(R, 100 + rep, device) + [T],
                                device) for rep in range(REPS))
            states[name] = fn(*fresh(R, 999, device), T)
            digest = sum(float(a.to(torch.float64).sum())
                         for a in states[name])
            points[name].append((T, best))
            put(dict(variant=name, T=T, best_s=best,
                     us_per_subop_raw=best / T * 1e6, warmup_s=warmup_s,
                     digest=digest, **where))
        if "plain" in states and "kernel" in states:
            for a, b in zip(states["plain"], states["kernel"]):
                if not torch.equal(a, b):
                    raise AssertionError(
                        "T=%d: kernel C's state differs from the plain "
                        "loop's" % T)

    for name, pts in points.items():
        if len(pts) >= 2:
            slope, intercept = np.polyfit([p[0] for p in pts],
                                          [p[1] for p in pts], 1)
            put(dict(variant=name, fit=True,
                     us_per_subop_marginal=float(slope) * 1e6,
                     intercept_ms=float(intercept) * 1e3, TS=list(ts),
                     **where))
    return records


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Sub-op selection microbenchmark (PyTorch + CUDA).")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda).")
    p.add_argument("--B", type=int, default=32, help="movies per batch.")
    p.add_argument("--K", type=int, default=16, help="pages per movie.")
    p.add_argument("--ts", default="100,400,1000",
                   help="comma-separated T values (sub-ops per call).")
    p.add_argument("--variants", default="plain,kernel,plain_i16",
                   help="comma-separated subset of %s." % ",".join(VARIANTS))
    p.add_argument("--out", default=None,
                   help="also write the JSON lines to this file.")
    a = p.parse_args(argv)
    variants = a.variants.split(",")
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        p.error("unknown variants: %s" % ",".join(unknown))
    if "kernel" in variants and torch.device(a.device).type != "cuda":
        p.error("variant 'kernel' needs a CUDA device (--device cuda)")
    lines = []

    def emit(rec):
        line = json.dumps(rec)
        lines.append(line)
        print(line, flush=True)

    run(a.device, a.B, a.K, [int(t) for t in a.ts.split(",")], variants,
        emit)
    if a.out:
        with open(a.out, "w") as f:
            f.write("".join(line + "\n" for line in lines))


if __name__ == "__main__":
    main()
