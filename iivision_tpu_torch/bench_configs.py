"""The port's counterpart of the repo's `bench_configs.py`: the five
`BASELINE.json` configurations, the yiq colour model, the CLI's batch mode
on 16 inputs, both full LUTs, B=10 batches and a k/j quality sweep.  The
records keep the JAX names in their `config` field.

    python -m iivision_tpu_torch.bench --only NAME[,NAME]

runs some of them (a group name such as `k_sweep` picks the group; see
`iivision_tpu_torch.bench` for the record, the reps and the checks).
Every rep of a configuration encodes with `--seed`, as the JAX program
encodes with the Movie's default seed.  The replay errors (`mean_error`,
`final_error`) are `quality.replay_frame_errors` of the last timed rep's
stream, scored outside the timed window.  Where
tests/data/quality_baseline.json holds a row for the same clip, setting
and seed (the 5 s sweep at k=16 j=4, seed 0), they are held to it as
tests/test_quality_regression.py holds them: mean error at most 1.01x,
final error at most 1.02x + 0.05.  The other configurations report their
errors and do not bound them.
"""

import contextlib
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

from iivision_tpu_torch import audio as audio_mod
from iivision_tpu_torch import cli, encoder, quality
from iivision_tpu_torch.bench import (
    DHGR, FPS, HGR, SRC_W, TICKS, Case, Context, Entry, all_streams_valid,
    lut_case, sync, synth_clip, tone, vm_checks)
from iivision_tpu_torch.movie import Movie
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.parallel import mesh
from iivision_tpu_torch.stream.emit_fast import emit_stream_fast


QUALITY_BASELINE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
    "data", "quality_baseline.json")


def baseline_checks(errors: dict, row_name: str) -> dict:
    """The replay errors against the committed baseline row `row_name`:
    mean error at most 1.01x the row's, final error at most 1.02x + 0.05
    (tests/test_quality_regression.py's bounds)."""
    with open(QUALITY_BASELINE) as f:
        row = json.load(f)["rows"][row_name]
    return {"quality_baseline_row": row_name,
            "mean_error_within_baseline":
                errors["mean_error"] <= row["mean_error"] * 1.01,
            "final_error_within_baseline":
                errors["final_error"] <= row["final_error"] * 1.02 + 0.05}


def scores(flat, m, dists: dict) -> dict:
    """Replay errors of a Movie's ops under each basis: {suffix: dist}."""
    lanes, _ = encoder.prepare_targets(m.frames.targets_main,
                                       m.frames.targets_aux, m.video_mode,
                                       m.device)
    out = {}
    for sfx, d in dists.items():
        rep = quality.replay_frame_errors(flat, m.plan, lanes, m.video_mode,
                                          d)
        out["mean_error" + sfx] = rep.mean_error
        out["final_error" + sfx] = rep.final_error
    return out


def movie_config(ctx: Context, mode, palette, bitrate, silent,
                 seconds=10.0, k=16, j=4, colour_model="window",
                 replay_bases=None) -> Case:
    """bench_configs.py `run_config`: a 280x192 clip at 30 fps (every 2nd
    frame) with a 440 Hz tone at `bitrate`, or silence, through
    `Movie.transcode` at k=16 j=4 with a shared `dist`; the stream through
    the player VM, then its replay errors.  replay_bases: {suffix: colour
    model} to score under (default {"": the encoding basis})."""
    dev = ctx.dev
    dist = ctx.dist(mode, palette, colour_model)
    bases = {sfx: ctx.dist(mode, palette, model)
             for sfx, model in (replay_bases or {"": colour_model}).items()}
    rgb = synth_clip(seconds)
    if silent:
        data = np.zeros(int(seconds * bitrate) + 1, np.float32)
        norm = 1.0
    else:
        data, norm = tone(seconds, bitrate), None

    def audio():
        return audio_mod.Audio(data=data, rate=bitrate, bitrate=bitrate,
                               normalization=norm, device=dev)

    levels = audio().levels()
    plan, _ = encoder.plan_movie(
        n_frames=len(rgb), n_audio_ticks=len(levels), input_frame_rate=FPS,
        ticks_per_second=float(bitrate), every_n_video_frames=2, mode=mode,
        k=k, j=j)
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "movie.a2m")

    def run(i):
        m = Movie(frames_source=rgb, device=dev, audio_source=audio(),
                  every_n_video_frames=2, video_mode=mode, palette=palette,
                  k=k, j=j, seed=ctx.seed, colour_model=colour_model,
                  dist=dist)
        stats = m.transcode(path)
        sync(dev)
        return ({s: stats[s] for s in ("frames_s", "encode_s", "emit_s",
                                       "total_s")}, (m, stats))

    def check(out):
        m, stats = out
        with open(path, "rb") as f:
            data_ = f.read()
        finals = [("main", m.final_main)]
        if mode == DHGR:
            finals.append(("aux", m.final_aux))
        checks = vm_checks(data_, stats["n_ops"], levels[:plan.n_ops],
                           finals)
        flat, _ = m.encode_ops()
        checks.update(scores(flat, m, bases), n_ops=stats["n_ops"],
                      stream_bytes=len(data_))
        return checks

    return Case(run, check, info=dict(
        mode=mode.name, palette=palette.name, audio_bitrate=bitrate,
        silent=silent, colour_model=colour_model, k=k, j=j,
        n_ops=plan.n_ops),
        encodes=((plan, mode, 1, colour_model, False),),
        roofline_stage="encode_s", movie_seconds=plan.n_ops / bitrate,
        close=tmp.cleanup)


def hgr_ntsc_video_only(ctx, seconds=10.0):
    """BASELINE config 1: HGR NTSC, video only (a silent stream)."""
    return movie_config(ctx, HGR, Palette.NTSC, TICKS, True, seconds)


def hgr_ntsc_audio(ctx, seconds=10.0):
    """BASELINE config 2: HGR NTSC with 14.7 kHz 5-bit audio."""
    return movie_config(ctx, HGR, Palette.NTSC, TICKS, False, seconds)


def dhgr_ntsc_audio(ctx, seconds=10.0):
    """BASELINE config 3: DHGR NTSC, MAIN and AUX interleaved."""
    return movie_config(ctx, DHGR, Palette.NTSC, TICKS, False, seconds)


def dhgr_iigs_22500(ctx, seconds=10.0):
    """BASELINE config 4: DHGR with the IIGS palette at 22,500 Hz (the
    //gs 2.8 MHz profile; the shipped IIGS store-cost table)."""
    return movie_config(ctx, DHGR, Palette.IIGS, 22500, False, seconds)


def dhgr_ntsc_yiq(ctx, seconds=10.0):
    """bench_configs.py:129-140: DHGR NTSC encoded in the yiq colour
    model, scored under both bases."""
    return movie_config(ctx, DHGR, Palette.NTSC, TICKS, False, seconds,
                        colour_model="yiq",
                        replay_bases={"_yiq": "yiq", "_window": "window"})


def cli_batch16(ctx: Context, n_inputs=16, max_seconds=10.0,
                min_seconds=4.0) -> Case:
    """bench_configs.py:143-208: `n_inputs` clips of mixed length (4 to 10
    s), distinct content each, through one `cli.main` batch call at k=16
    j=4 with `--stats_json`.  The inputs are `.npz` clips with no audio
    track (the card host has no cv2), written once; the ingest caches
    beside them are removed before every rep, so each rep decodes and
    quantizes.  Every output plays in the VM."""
    dev = ctx.dev
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    rng = np.random.RandomState(ctx.seed)
    base = synth_clip(max_seconds)
    lengths = [int((min_seconds + (max_seconds - min_seconds)
                    * (i / max(n_inputs - 1, 1))) * FPS)
               for i in range(n_inputs)]
    paths, plans = [], []
    for i, f in enumerate(lengths):
        roll = int(rng.randint(0, SRC_W))
        clip = np.stack([np.roll(base[t % len(base)], roll + 3 * t, axis=1)
                         for t in range(f)])
        path = os.path.join(work, "in_%02d.npz" % i)
        np.savez(path, frames=clip, frame_rate=float(FPS))
        paths.append(path)
        plans.append(encoder.plan_movie(
            n_frames=f, n_audio_ticks=int(f / FPS * TICKS) + 1,
            input_frame_rate=FPS, ticks_per_second=TICKS,
            every_n_video_frames=2, mode=DHGR, k=16, j=4)[0])
    del base
    n_max = max(lengths)
    plan_max, _ = encoder.plan_movie(
        n_frames=n_max, n_audio_ticks=int(n_max / FPS * TICKS) + 1,
        input_frame_rate=FPS, ticks_per_second=TICKS, every_n_video_frames=2,
        mode=DHGR, k=16, j=4)
    out_dir = os.path.join(work, "out")
    stats = os.path.join(work, "stats.json")

    def run(i):
        for old in glob.glob(os.path.join(work, "*.iiv_*.npz")):
            os.remove(old)
        # the CLI's lines go to stderr: stdout carries the records
        with contextlib.redirect_stdout(sys.stderr):
            cli.main(paths + ["--device", str(dev), "--output", out_dir,
                              "--video_mode", "DHGR", "--palette", "NTSC",
                              "--k", "16", "--j", "4",
                              "--seed", str(ctx.seed + i),
                              "--stats_json", stats])
        sync(dev)
        with open(stats) as f:
            rows = json.load(f)
        return dict(batch_encode_s=rows[0]["batch_encode_s"]), rows

    def check(rows):
        out = {"per_movie_stats": len(rows),
               "all_outputs": len(rows) == n_inputs}
        valid = True
        for row, plan in zip(rows, plans):
            with open(row["output"], "rb") as f:
                ok = vm_checks(f.read(), plan.n_ops)
            valid &= ok["vm_ok"] and ok["vm_n_ops"]
        out["all_vm_valid"] = bool(valid)
        return out

    total = sum(p.n_ops for p in plans) / TICKS
    return Case(run, check, info=dict(mode="DHGR", k=16, j=4,
                                      n_inputs=n_inputs,
                                      movie_seconds_total=total),
                encodes=((plan_max, DHGR, n_inputs, "window", False),),
                movie_seconds=total, rate="batch_realtime_x",
                close=tmp.cleanup)


def hgr_tablegen(ctx: Context, n_rows=None) -> Case:
    """bench_configs.py:307-320: both lanes of the full HGR LUT, 2 x
    16384^2 uint16, 1 GiB on the device."""
    return lut_case(ctx, HGR, n_rows=n_rows)


def batch10(ctx: Context, mode, tables: bool, B=10, seconds=10.0,
            n_rows=None) -> Case:
    """bench_configs.py:322-386: one 10 s movie's targets broadcast to a
    batch of B, encoded at k=16 j=4 with seeds seed + 1 .. seed + B,
    fetched (every slot), flattened and emitted; `batch_realtime_x` is B
    movie seconds over that (`batch_s`).  With `tables` the rep first
    builds the mode's full LUT (`tablegen_s`).  Every stream plays in the
    VM."""
    dev = ctx.dev
    dist = ctx.dist(mode)
    aud = audio_mod.Audio(data=tone(seconds), rate=TICKS, bitrate=TICKS,
                          device=dev)
    m = Movie(frames_source=synth_clip(seconds), device=dev,
              audio_source=aud, every_n_video_frames=2, video_mode=mode,
              palette=Palette.NTSC, k=16, j=4, dist=dist)
    m.encode_ops()  # the plan and the targets
    plan = m.plan
    lanes, bytes_ = encoder.prepare_targets(
        m.frames.targets_main, m.frames.targets_aux, mode, dev)
    lanes_b = lanes.expand((B,) + tuple(lanes.shape))
    bytes_b = bytes_.expand((B,) + tuple(bytes_.shape))
    levels = aud.levels()[:plan.n_ops]
    lut = lut_case(ctx, DHGR, n_rows=n_rows) if tables else None

    def run(i):
        stages = {}
        if lut is not None:
            stages.update(lut.run(i)[0])
        t0 = time.perf_counter()
        seed = ctx.seed + 1
        ops, _, _ = mesh.encode_movies_batch(
            dist, lanes_b, bytes_b, plan, mode,
            seeds=list(range(seed, seed + B)))
        ops_np = mesh.fetch_ops(ops, plan)
        streams = [emit_stream_fast(encoder.flatten_ops(ops_np[b], plan),
                                    levels, mode) for b in range(B)]
        stages["batch_s"] = time.perf_counter() - t0
        return stages, streams

    def check(streams):
        return all_streams_valid(streams, plan.n_ops, levels)

    return Case(run, check, info=dict(mode=mode.name, k=16, j=4, B=B,
                                      n_ops=plan.n_ops),
                encodes=((plan, mode, B, "window", False),),
                movie_seconds=B * plan.n_ops / TICKS,
                rate="batch_realtime_x", rate_stage="batch_s")


def batch10_plus_tablegen(ctx, B=10, seconds=10.0, n_rows=None):
    """BASELINE config 5: a batch of 10 DHGR movies and the full DHGR LUT
    regeneration."""
    return batch10(ctx, DHGR, True, B, seconds, n_rows)


def hgr_batch10(ctx, B=10, seconds=10.0):
    """The HGR batch at the same B=10 shape."""
    return batch10(ctx, HGR, False, B, seconds)


def k_sweep(k: int, j: int):
    """bench_configs.py:211-249: the 5 s DHGR clip at (k, j): `Movie`
    construction and `encode_ops` timed (`encode_realtime_x`), then the
    stream through the VM and its replay errors; at k=16 j=4 and seed 0
    (the pinned quality clip's setting) those are held to the committed
    baseline."""

    def make(ctx: Context, seconds=5.0):
        dev, dist = ctx.dev, ctx.dist(DHGR)
        rgb = synth_clip(seconds)
        wave = tone(seconds)
        levels = audio_mod.Audio(data=wave, rate=TICKS, bitrate=TICKS,
                                 device=dev).levels()
        plan, _ = encoder.plan_movie(
            n_frames=len(rgb), n_audio_ticks=len(levels),
            input_frame_rate=FPS, ticks_per_second=TICKS,
            every_n_video_frames=2, mode=DHGR, k=k, j=j)

        def run(i):
            m = Movie(frames_source=rgb, device=dev,
                      audio_source=audio_mod.Audio(
                          data=wave, rate=TICKS, bitrate=TICKS, device=dev),
                      every_n_video_frames=2, video_mode=DHGR,
                      palette=Palette.NTSC, k=k, j=j, seed=ctx.seed,
                      dist=dist)
            flat, lv = m.encode_ops()
            sync(dev)
            return dict(encode_s=m.timings["encode_s"]), (m, flat, lv)

        def check(out):
            m, flat, lv = out
            data = emit_stream_fast(flat, lv, DHGR)
            checks = vm_checks(data, plan.n_ops, lv, [
                ("main", m.final_main), ("aux", m.final_aux)])
            errors = scores(flat, m, {"": dist})
            checks.update(errors)
            if seconds == 5.0 and (k, j) == (16, 4) and ctx.seed == 0:
                checks.update(baseline_checks(errors,
                                              "dhgr_ntsc_k16_j4_seed0"))
            return checks

        return Case(run, check, info=dict(mode="DHGR", k=k, j=j,
                                          seconds=seconds, n_ops=plan.n_ops,
                                          plan_steps=len(plan.step_frame)),
                    encodes=((plan, DHGR, 1, "window", False),),
                    roofline_stage="encode_s", movie_seconds=seconds,
                    rate="encode_realtime_x")

    return make


K_SWEEP = ((1, 1), (8, 1), (32, 1), (16, 4), (16, 8), (32, 4), (32, 8))

TINY_CLIP = dict(seconds=0.1)
CONFIGS = {
    "hgr_ntsc_video_only": Entry(hgr_ntsc_video_only, 5, TINY_CLIP),
    "hgr_ntsc_audio": Entry(hgr_ntsc_audio, 5, TINY_CLIP),
    "dhgr_ntsc_audio": Entry(dhgr_ntsc_audio, 5, TINY_CLIP),
    "dhgr_iigs_22500": Entry(dhgr_iigs_22500, 5, TINY_CLIP),
    "dhgr_ntsc_yiq": Entry(dhgr_ntsc_yiq, 5, TINY_CLIP),
    "cli_batch16": Entry(cli_batch16, 3, dict(n_inputs=2, max_seconds=0.2,
                                              min_seconds=0.1)),
    "hgr_tablegen": Entry(hgr_tablegen, 5, dict(n_rows=2)),
    "batch10_plus_tablegen": Entry(batch10_plus_tablegen, 5,
                                   dict(B=2, seconds=0.1, n_rows=2)),
    "hgr_batch10": Entry(hgr_batch10, 5, dict(B=2, seconds=0.1)),
    **{"k_sweep_k%d_j%d" % kj: Entry(k_sweep(*kj), 5, dict(seconds=0.05),
                                     "k_sweep")
       for kj in K_SWEEP},
}

