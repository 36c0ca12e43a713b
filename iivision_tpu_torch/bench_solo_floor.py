"""The port's counterpart of the repo's `bench_solo_floor.py`: where the
solo encode's time goes, from the same encode at three movie lengths.

    python -m iivision_tpu_torch.bench --only solo_floor_dhgr_k32_j10

For 2.5, 5 and 10 s DHGR movies at k=32 j=10 on random targets made from
`--seed` and resident on the device, each rep times `encoder.encode_movie`
plus the fetch of the final screen.  The record gives, per length, the
median and best of the reps (4 by default), the plan's steps as the port
runs them (`len(plan.step_frame)`: the port pads no steps into buckets),
the sequential sub-ops and the launches counted on a card; and a line fit
of the best times over the sub-ops: `us_per_subop_marginal` (the slope,
the cost of one more dependent sub-op) and `intercept_ms` (the fixed
cost).  The JAX program's unroll sweep is a knob of its XLA scan and has
no counterpart here.  Lines go to stdout and `--out`, never to
`SOLO_FLOOR.jsonl`.
"""

import time

import numpy as np

from iivision_tpu_torch import encoder
from iivision_tpu_torch.bench import (DHGR, FPS, TICKS, Case, Context, Entry,
                                      encode_launches, sync)

LENGTHS = (2.5, 5.0, 10.0)


def fit_floor(subops, seconds):
    """The line seconds = intercept + slope * subops through the points;
    returns (us_per_subop_marginal, intercept_ms)."""
    slope, intercept = np.polyfit(np.asarray(subops, np.float64),
                                  np.asarray(seconds, np.float64), 1)
    return float(slope * 1e6), float(intercept * 1e3)


def solo_floor(ctx: Context, lengths=LENGTHS, k=32, j=10) -> Case:
    dev, dist = ctx.dev, ctx.dist(DHGR)
    movies = []
    for seconds in lengths:
        plan, n_enc = encoder.plan_movie(
            n_frames=int(seconds * FPS), n_audio_ticks=int(seconds * TICKS),
            input_frame_rate=FPS, ticks_per_second=TICKS,
            every_n_video_frames=2, mode=DHGR, k=k, j=j)
        rng = np.random.RandomState(ctx.seed + int(seconds * 7))
        fm = rng.randint(0, 0x80, (n_enc, 32, 256)).astype(np.uint8)
        fa = rng.randint(0, 0x80, (n_enc, 32, 256)).astype(np.uint8)
        lanes, bytes_ = encoder.prepare_targets(fm, fa, DHGR, dev)
        movies.append((seconds, plan, lanes, bytes_))
    sync(dev)
    times = {s: [] for s in lengths}  # timed reps only
    launched = {}

    def run(i):
        stages = {}
        for seconds, plan, lanes, bytes_ in movies:
            before = encode_launches()
            t0 = time.perf_counter()
            _, main_, _ = encoder.encode_movie(dist, lanes, bytes_, plan,
                                               DHGR, seed=2 + i)
            main_.cpu()
            stages["encode_%gs_s" % seconds] = time.perf_counter() - t0
            launched[seconds] = [a - b for a, b in
                                 zip(encode_launches(), before)]
            if i > 0:  # not the warm-up
                times[seconds].append(stages["encode_%gs_s" % seconds])
        return stages, None

    def check(_):
        rows = []
        for seconds, plan, _, _ in movies:
            S = len(plan.step_frame)
            best = min(times[seconds])
            rows.append(dict(
                seconds=seconds, S=S, subops=S * j, n_ops=plan.n_ops,
                median_s=float(np.median(times[seconds])), best_s=best,
                us_per_subop=best / (S * j) * 1e6,
                chunk_starts_bodies=launched[seconds]))
        slope, intercept = fit_floor([r["subops"] for r in rows],
                                     [r["best_s"] for r in rows])
        return {"rows": rows, "us_per_subop_marginal": slope,
                "intercept_ms": intercept}

    return Case(run, check, info=dict(mode="DHGR", k=k, j=j,
                                      lengths=list(lengths)),
                encodes=tuple((plan, DHGR, 1, "window", False)
                              for _, plan, _, _ in movies))


CONFIGS = {"solo_floor_dhgr_k32_j10": Entry(
    solo_floor, 4, dict(lengths=(0.05, 0.1, 0.15)))}

