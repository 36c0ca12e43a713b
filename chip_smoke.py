"""Smoke run of iivision_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py --sweep    # the build and the body cluster sweep
    python3 chip_smoke.py --steps    # the build and recompute_steps
    python3 chip_smoke.py --variants # the recompute prologue's variants
    python3 chip_smoke.py --ingest   # the build and the ingest kernel

Builds the port's CUDA kernels from csrc/ with nvcc (one process per
source, all at once) and checks each against its plain torch version on
the card, bit-equal:
- kernel A's all-pairs tile: DHGR 1024 x 8192 and HGR 512 x 2048 with
  a != b, ragged sizes, the symmetric path (one code set twice) on a
  ragged set in full and on whole DHGR and HGR (16384^2) lanes on sampled
  rows; kernel A's lane-distance entry (every DHGR and HGR lane, window
  and mono bases: every masked value against a fixed one, random pairs,
  pairs that transpose neighbouring codes, strided and broadcast views) and its
  codes entry at L = 10 and 18;
- the chunk start, the body kernel's prologue (a body launched with the
  cost basis against chunk_start_plain then encode_body_plain): DHGR (both
  banks) and HGR, window, mono and yiq bases, B = 1 and 32, on the NTSC
  palette; the IIGS palette's window bases (DHGR and HGR) and its HGR yiq
  stack, B = 1 and 32; both content rules, at every cluster size;
- the body kernel's threefry (B = 32 keys, steps up to 2^20, four
  sub-ops);
- the body kernel, default and joint content, on real plan bodies with
  padded steps and a partial step (DHGR k=8 j=1 and k=16 j=4, HGR k=8 j=1
  with its 256 contents, B = 1 and 32, seeded and deterministic; the
  default rule also at every other setting the bench runs: DHGR (k, j) =
  (32, 10), (32, 1), (1, 1), (16, 8), (32, 4) and (32, 8) at B = 1 and 32,
  DHGR (16, 4) at B = 10 and 16, HGR (16, 4) at B = 1, 10 and 32, seeded
  and deterministic), on
  tie-heavy bodies whose every page and offset choice falls to the nonces,
  and for joint content on bodies whose contents tie (dw all zero, or one
  cost for every content) and at DHGR k=32 j=10 (every warp runs a slot),
  B = 1 and 32, seeded and deterministic; both rules also on the IIGS
  palette's tables (DHGR k=16 j=4, HGR k=8 j=1, B = 1 and 32, seeded and
  deterministic); every case at the chooser's cluster size (timed) and
  at every cluster size the kernel takes, 1, 2, 4, 8 and 16 CTAs per
  movie (bit-equality only);
- the body kernel's cluster sweep (`body_cluster_sweep`): device time at
  each cluster size for DHGR (32, 10) B = 1 seeded and deterministic,
  joint (32, 10) B = 1, (16, 4) B = 32, (8, 1) and (1, 1) B = 1 and HGR
  (16, 4) B = 1, the chooser's size for each, the card's maximum active
  clusters per size and rule, where the CTAs ran (`%smid` recorded per
  CTA) and the host's time per body launch;
- kernel C (the sub-op microbenchmark at 512 and 509 rows, T = 0, 1 and
  100, with crafted rows);
- the ingest kernel against the torch chain of `mesh.ingest_batch_plain`
  (`check_ingest`): DHGR and HGR, NTSC and IIGS, 192x280, 192x140,
  360x640 and 720x1280 sources, (B, F) = (1, 1), (3, 300) and (32, 150),
  random frames and the benchmark's synthetic clips; a second call makes
  no copy and runs one kernel; the batch cells' B = 32 10 s round timed,
  kernel and chain.
Each kernel's device time is the mean of many back-to-back launches
between one event pair, queued behind a sleep so that the host's wrapper
time stays outside the pair.
It reproduces the JAX package's golden stream, then drives each entry
point of the port with the launch counts set to 0 before it and read
after it:

- 10 s DHGR clips at (k=8, j=1) and (k=16, j=4), and a 10 s HGR clip at
  (k=8, j=1), through Movie.transcode and the player VM;
- the full DHGR NTSC LUT (make_tables' path: the bench's lut_dhgr_ntsc,
  whose checks are a zero diagonal, sampled blocks symmetric, sampled rows
  against plain and cells against the scalar Damerau-Levenshtein), then
  its first 1024 rows per lane through `build_tables_sharded` over
  (cuda:0, cuda:0), equal to the full LUT's rows; then the IIGS palette's
  whole DHGR LUT (the same checks) and the first 1024 rows of each HGR
  lane (rows against plain, cells against the scalar recurrence);
- the sub-op microbenchmark's T sweep (bench_subop.run);
- 2 s clips in the yiq colour model (DHGR and HGR: the body kernel's yiq
  recompute) and the mono model (HGR); the mono clip
  builds its store-cost table on the card, and sampled rows of that table
  are held against the plain build;
- the batch transcode (the bench's batch_dhgr_b32_10s_k16_j4): 32
  distinct 10 s clips made on the card through ingest_movies_batch,
  encode_movies_batch at k=16 j=4, fetch_ops_compact and emit; every
  stream through the player VM to the encoder's final screens, and movies
  0 and 31 byte-equal to their solo encodes;
- the same batch sharded over the mesh (cuda:0, cuda:0): two shards of 16
  movies, each ingested, encoded and fetched (`fetch_ops_parallel`) in a
  host thread and a CUDA stream of its own; every stream and final screen
  byte-equal to the unsharded batch's;
- the CLI's batch mode on three .npz clips of 10, 6 and 3 s, with `--mesh
  auto` (one card: unsharded): every stream plays at its own length, and
  the shortest equals its padded solo encode;
- the 5 s quality clip of tests/test_quality_regression.py at k=16 j=4
  and at k=32 j=10, each with and without joint content (the body
  kernel's joint instantiation), replayed and scored on the card: each
  mean error within 1.01x of tests/data/quality_baseline.json, and joint
  below the default rule's baseline at its (k, j); `stream_psnr` of the
  final screen against the last target is printed;
- tests/test_quality_matrix.py's twelve rows (MATRIX_ROWS: two pinned 2 s
  clips over DHGR and HGR x NTSC and IIGS in the window model, and yiq
  for DHGR NTSC and HGR IIGS; k=16 j=4, seed 0) through Movie, scored by
  replay and held to tests/data/quality_matrix_baseline.json (mean
  within 1.01x + 1e-6, final within 1.02x + 0.05); the HGR IIGS yiq table,
  which no package ships, is built on the card, and sampled rows of it
  are held against the plain build on the CPU;
- a 10 s HGR clip through `cli.main --palette IIGS` at k=16 j=4, played
  on the player VM to the encoder's finals;
- the long-movie encoders: a 60 s DHGR clip (900 encoded frames) through
  Movie, which must take the streaming encoder, play on the player VM and
  equal its whole-movie encode byte for byte (both timed, with the device
  memory high-water mark of each); the CLI with `--chunk_frames 32` on a
  10 s clip against the same call without it; `encode_movie_streaming`
  called directly on a 20 s HGR clip (segments of 16 frames, ragged
  batches) and with joint content on the 5 s quality clip, each against
  its unsegmented encode; and the 10 s k=16 j=4 clip forced through the
  streaming encoder at segments of 16 and 64 frames beside its
  whole-movie run.
- the delivery half, on a 10 s DHGR clip at k=16 j=4 and a 5 s HGR clip
  at k=8 j=1 (280x192 source, 30 fps, every 2nd frame, a 440 Hz tone):
  `cli.main --device cuda` writes the `.a2m` file; `verify_stream.main
  --machine` passes it, and the unmodified player, assembled from
  `data/player/main.s` and run cycle by cycle on `sim.machine65`, ends
  with screens equal to the encoder's finals and speaker duties equal to
  the audio levels; `server.build_handler` serves it over a loopback
  socket, plain (bytes equal the file), from the middle through
  `build_seeker` (plays to TERMINATED, every byte stored after the seek
  point as in full playback) and through `build_retargeter` onto a
  relocated player build (equal to the offline `retarget.retarget`, and
  that build plays it to the same screens, duties and cycles);
  `make_disk.build_disk` on the template disk boots through
  `machine65.boot_disk` to the same screens (DHGR); and
  `render_stream.stream_screens` ends on the same screens.  The g++
  build of `sim/csrc/apple2_vm.cpp` and the player's assembly are timed
  apart, before the two paths.
- the host oracle: deterministic (seed None) encodes on the card - 1 s
  DHGR at k=8 j=1, 1 s HGR at k=4 j=3 (NTSC and IIGS), 0.25 s DHGR joint
  at k=16 j=4 - equal op for op, with their final screens, to
  `encoder_host`'s `encode_movie_host` and a `HostEncoder` replay.
- the bench (`python -m iivision_tpu_torch.bench --reps 1`, in this
  process, on one shared bench Context): every configuration at full
  size - the LUT and the batch above among them, each run once - each its
  own counted path (warm-up, one timed rep, one traced rep), its record
  summarised in one `bench:` line; a record that fails a check (VM
  validity, the pipelined streams against one-shot ones, the 80 s stream
  on the 6502 machine, LUT rows against plain, launches against the
  roofline model) fails the run.
From its second clip on, a mode's 10 s path passes the first clip's
distance model to `Movie(dist=...)`.  Every whole-movie clip, the batch
and the mesh batch print a `roofline[...]` line (`roofline.report` on the
card's peaks) and fail unless its modelled chunk starts and bodies equal
the launches counted on the path (a chunk start is a body launch that
runs the recompute in its prologue).

A last, uncounted phase traces 1 s clips with torch.profiler (solo and a
batch of 32 at k=16 j=4, solo at k=8 j=1, solo joint at k=16 j=4): device
busy share, kernel launches per plan step and the kernels that launch
most, and holds the body kernel's timer figure against the profiler's.

Every phase prints one line of numbers; any failure raises, giving a
non-zero exit.  The last two lines are the kernel report and the device
line, both JSON.  Needs one CUDA card; without one it exits non-zero
before printing any result.  Imports nothing of JAX nor of the JAX
package.  Store-cost tables it builds go to a temporary cache directory
that is removed at exit.
"""

import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types

GOLDEN_SHA = "57fdd52adf53d75101ed121d28d8a5389465c09f99d960ba6c47c20dbdb30fbc"

# kernel -> (its launch counter, as `iivision_tpu_torch.trace.counters`
# names it, source, the TPU or JAX function it replaces)
# (the chunk start is the body kernel's prologue: its counters are the body
# wrapper's launches that recompute)
KERNELS = {
    "chunk_start": ("encode_body.recompute_launches",
                    "iivision_tpu_torch/csrc/body.cu",
                    "iivision_tpu/encoder.py:540"),
    "chunk_start_yiq": ("encode_body.yiq_recompute_launches",
                        "iivision_tpu_torch/csrc/body.cu",
                        "iivision_tpu/encoder.py:374"),
    "encode_body": ("encode_body.launches",
                    "iivision_tpu_torch/csrc/body.cu",
                    "iivision_tpu/encoder.py:567"),
    "encode_body_joint": ("encode_body.joint_launches",
                          "iivision_tpu_torch/csrc/body.cu",
                          "iivision_tpu/encoder.py:583"),
    "threefry_uniform": ("threefry_uniform.launches",
                         "iivision_tpu_torch/csrc/body.cu",
                         "iivision_tpu/encoder.py:695"),
    "editdist_tile": ("pair_distance.launches",
                      "iivision_tpu_torch/csrc/editdist.cu",
                      "iivision_tpu/ops/editdist.py:232"),
    "lane_dist": ("lane_distance.launches",
                  "iivision_tpu_torch/csrc/editdist.cu",
                  "iivision_tpu/ops/distance.py:150"),
    "dist_pairs": ("dist_pairs_elementwise.launches",
                   "iivision_tpu_torch/csrc/editdist.cu",
                   "iivision_tpu/ops/distance.py:72"),
    "subop_bench": ("run_kernel.launches",
                    "iivision_tpu_torch/csrc/subop_bench.cu",
                    "tools/bench_subop_pallas.py:183"),
    "ingest_batch": ("ingest_batch.launches",
                     "iivision_tpu_torch/csrc/ingest.cu",
                     "iivision_tpu/parallel/mesh.py:100"),
}


def launch_count(name) -> int:
    from iivision_tpu_torch import trace

    return trace.counters()[KERNELS[name][0]]


def counted(path, want, fn, *args, **kw):
    """Run one path with every launch count at 0; fail unless each kernel
    in `want` launched.  Returns (fn's result, {kernel: launches})."""
    from iivision_tpu_torch import _build, trace

    trace.counters()  # imports every kernel's module: all counters made
    for wrapper, attr in _build.COUNTERS:
        setattr(wrapper, attr, 0)
    t0 = time.time()
    out = fn(*args, **kw)
    got = trace.counters()
    launches = {name: got[KERNELS[name][0]] for name in KERNELS}
    print("launches %s: %s path_s=%.1f" % (path, json.dumps(launches),
                                            time.time() - t0))
    for name in want:
        if launches[name] == 0:
            raise AssertionError("kernel %s never launched on path %s"
                                 % (name, path))
    return out, launches


def main(argv=()):
    """The smoke; argv ["--sweep"]: the build and the body kernel's
    cluster sweep alone (`body_cluster_sweep`); ["--steps"]: the build
    and `recompute_steps` alone; ["--variants"]: `prologue_variants`;
    ["--ingest"]: the build and `check_ingest` alone."""
    import torch

    if list(argv) not in ([], ["--sweep"], ["--steps"], ["--variants"],
                          ["--ingest"]):
        print("usage: chip_smoke.py [--sweep | --steps | --variants | "
              "--ingest]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from iivision_tpu_torch import _build, bench, bench_subop
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # -- 1. build --------------------------------------------------------
    b = _build.build()
    print("build: %s seconds=%.2f built=%s" % (
        os.path.relpath(b["path"]), b["seconds"], b["built"]))
    for line in b["log"].splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            print("  ptxas: " + line.strip())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.library()

    # -- 2. each kernel against its plain version -------------------------
    report = {}
    if list(argv) == ["--sweep"]:
        report["encode_body"] = {}
        body_cluster_sweep(dev, report)
        return 0
    if list(argv) == ["--steps"]:
        recompute_steps(dev)
        return 0
    if list(argv) == ["--variants"]:
        prologue_variants(os.path.dirname(os.path.abspath(__file__)))
        return 0
    if list(argv) == ["--ingest"]:
        check_ingest(dev, report)
        return 0
    check_kernel_a(dev, report)
    check_lane_dist(dev, report)
    check_chunk_start(dev, report)
    check_threefry(dev, report)
    check_body(dev, report)
    check_body(dev, report, joint=True)
    body_cluster_sweep(dev, report)
    check_kernel_c(dev, report)
    check_ingest(dev, report)
    check_golden(dev)
    print("kernel checks done at %.1f s" % (time.time() - t_start))

    # -- 3. the port's paths, each counted --------------------------------
    dhgr, hgr = VideoMode.DHGR, VideoMode.HGR
    enc = ("chunk_start", "encode_body")
    yiq = ("chunk_start_yiq", "encode_body")
    totals = {name: 0 for name in KERNELS}
    dists = {}  # (mode, colour model) -> the first clip's distance model
    results = {}  # path -> what it returned, for the path after it
    ran = set()  # the bench's configurations run among the paths
    with tempfile.TemporaryDirectory() as cache:
        os.environ["XDG_CACHE_HOME"] = cache
        bench_ctx = bench.Context(dev, 0, b)  # shared distance models
        for path, want, fn, args, kw in (
                ("dhgr_10s_k8_j1", enc, run_movie,
                 (dev, dists, dhgr, 8, 1, 10), {}),
                ("dhgr_10s_k16_j4", enc, run_movie,
                 (dev, dists, dhgr, 16, 4, 10), {}),
                ("hgr_10s_k8_j1", enc, run_movie,
                 (dev, dists, hgr, 8, 1, 10), {}),
                ("bench:lut_dhgr_ntsc", ("editdist_tile",), run_bench_config,
                 ("lut_dhgr_ntsc", bench_ctx), {}),
                ("lut_dhgr_ntsc_sharded", ("editdist_tile",),
                 lambda: run_lut_sharded(
                     dev, results.pop("bench:lut_dhgr_ntsc")), (), {}),
                ("lut_iigs", ("editdist_tile",), run_lut_iigs, (dev,), {}),
                ("bench_subop", ("subop_bench",), run_bench,
                 (dev, bench_subop, report), {}),
                ("dhgr_2s_yiq", yiq, run_movie, (dev, dists, dhgr, 8, 1, 2),
                 dict(colour_model="yiq")),
                ("hgr_2s_yiq", yiq, run_movie, (dev, dists, hgr, 8, 1, 2),
                 dict(colour_model="yiq")),
                ("hgr_2s_mono", enc + ("lane_dist",), run_mono,
                 (dev, dists, hgr), {}),
                ("bench:batch_dhgr_b32_10s_k16_j4", enc + ("ingest_batch",),
                 run_bench_config, ("batch_dhgr_b32_10s_k16_j4", bench_ctx),
                 {}),
                ("batch_dhgr_b32_10s_k16_j4_mesh2", enc + ("ingest_batch",),
                 lambda: run_batch_mesh(
                     dev, results.pop("bench:batch_dhgr_b32_10s_k16_j4")),
                 (), {}),
                ("batch_cli_mixed", enc, run_cli_mixed, (dev,), {}),
                ("quality_dhgr_5s_k16_j4",
                 enc + ("lane_dist", "encode_body_joint"), run_quality,
                 (dev, dists, 16, 4), {}),
                ("quality_dhgr_5s_k32_j10",
                 enc + ("lane_dist", "encode_body_joint"), run_quality,
                 (dev, dists, 32, 10), {}),
                ("quality_matrix", enc + ("chunk_start_yiq", "lane_dist"),
                 run_quality_matrix, (dev,), {}),
                ("hgr_10s_iigs_k16_j4", enc, run_cli_palette,
                 (dev, hgr, Palette.IIGS, 16, 4, 10), {}),
                ("dhgr_60s_stream_k8_j1", enc, run_long_stream, (dev, dists),
                 {}),
                ("dhgr_10s_chunked_cli_k16_j4", enc, run_cli_chunked, (dev,),
                 {}),
                ("hgr_20s_stream_k8_j1", enc, run_stream_direct,
                 (dev, dists, hgr, 8, 1, False), {}),
                ("dhgr_5s_stream_joint_k16_j4",
                 ("chunk_start", "encode_body_joint"), run_stream_direct,
                 (dev, dists, dhgr, 16, 4, True), {}),
                ("dhgr_10s_forced_stream_k16_j4", enc, run_forced_stream,
                 (dev, dists), {}),
                ("delivery_dhgr_10s_k16_j4", enc, run_delivery,
                 (dev, dhgr, 16, 4, 10), dict(boot=True)),
                ("delivery_hgr_5s_k8_j1", enc, run_delivery,
                 (dev, hgr, 8, 1, 5), dict(boot=False)),
                *((path, ("chunk_start", "encode_body_joint" if joint
                          else "encode_body"), run_host_oracle,
                   (dev, m, pal, k, j, sec, joint), {})
                  for path, m, pal, k, j, sec, joint in ORACLE_CASES)):
            if path == "delivery_dhgr_10s_k16_j4":
                build_machine()
            out, launches = counted(path, want, fn, *args, **kw)
            if path.startswith("bench:"):
                results[path] = out  # the next path's input
                ran.add(path)
            for name, n in launches.items():
                totals[name] += n
        # the bench's other configurations
        t0 = time.time()
        for path, want in bench_paths():
            if "bench:" + path in ran:
                continue  # ran above, feeding the path after it
            _, launches = counted("bench:" + path, want, run_bench_config,
                                  path, bench_ctx)
            for name, n in launches.items():
                totals[name] += n
        print("bench_s=%.1f" % (time.time() - t0))
        del os.environ["XDG_CACHE_HOME"]
    print("main path launches: %s" % json.dumps(totals))
    t0 = time.time()
    trace_encodes(dev, report)
    print("trace_s=%.1f" % (time.time() - t0))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = []
    for name, (_, src, replaces) in KERNELS.items():
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=totals[name])
        entry.update((k, report[name][k]) for k in keys)
        entry.update(report[name].get("beside", {}))
        # no single PyTorch call computes any of these functions
        entry["library_ms"] = None
        kernels.append(entry)
    print("wall_s=%.1f" % (time.time() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bound(nbytes: float, ops: float = 0.0, int_ops: float = 0.0,
          fp64_ops: float = 0.0) -> dict:
    """The least time card 0 could take: the larger of the bytes over the
    HBM rate and the operations over the card's rate for their type (`ops`
    float32 and `fp64_ops` float64, both outside the tensor cores,
    `int_ops` int32), on the peaks of `roofline.CARD_PEAKS` (a card not in
    that table fails the run)."""
    from iivision_tpu_torch import roofline

    t, by = roofline.least_time(nbytes, ops, int_ops,
                                roofline.device_peaks(0), fp64_ops)
    return dict(bound_ms=t * 1e3, bound_by=by)


def synth_clip(seconds=10.0, fps=30, w=280, h=192, phase=0.0):
    """A moving RGB pattern, (seconds * fps, h, w, 3) uint8: the port's
    `bench.synth_clip` (the JAX benchmark's bench.synth_clip)."""
    from iivision_tpu_torch import bench

    return bench.synth_clip(seconds, fps, w, h, phase)


def as_i32(t):
    """uint16 tensor -> int32 values (through int16, whose CUDA ops torch
    implements in full)."""
    import torch

    return t.view(torch.int16).to(torch.int32) & 0xFFFF


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Device milliseconds per call of fn(): `reps` calls back to back
    between one pair of CUDA events, after a warm-up.  A device sleep ahead
    of the start event holds the stream while the host enqueues every
    call, so the pair brackets the device's work and not the wrappers'
    host time.  setup() builds each call's arguments before the timed
    region.  A call that launches hundreds of small ops (a plain version)
    can outrun the launch queue; its figure then includes host gaps."""
    import torch

    args = [setup() if setup else () for _ in range(reps + 1)]
    fn(*args[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args[0])
    host_s = time.perf_counter() - t0  # enqueue time of one call
    torch.cuda.synchronize()
    # about 2e9 cycles a second: cover the host's enqueue of every call
    torch.cuda._sleep(int(min(2.0, 2 * host_s * reps + 1e-3) * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*args[i + 1])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wrapper_ms(fn, reps: int, setup=None) -> float:
    """Milliseconds from before one call's wrapper to after its launch
    (the smoke's earlier timer): host wrapper time plus the kernel, mean
    of `reps` single calls."""
    import torch

    args = setup() if setup else ()
    fn(*args)
    total = 0.0
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def check_kernel_a(dev, report):
    """Kernel A against its plain version, exact equality.  All pairs: DHGR
    1024 x 8192 and HGR 512 x 2048 with a != b, ragged sizes (DHGR
    1000 x 777, HGR 300 x 517 from other rows), the symmetric path (one code
    set passed twice) on ragged sets in full (DHGR 999, HGR 1000), one
    code set under an asymmetric cost matrix (the kernel's own check must
    send it the general way), and whole DHGR 8192^2 and HGR 16384^2 lanes
    on the symmetric path on 64 sampled rows each.
    The codes entry (dist_pairs, on no counted path since the lane-distance
    entry): 8192 pairs at L = 10 and 18, half of them one adjacent swap
    apart, timed there and at 2^20 pairs.  Times per lane: DHGR and HGR on
    the symmetric path (the LUT build's call), DHGR on the general path
    beside them."""
    import numpy as np
    import torch

    from iivision_tpu_torch.ops import distance, editdist
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    D, H = VideoMode.DHGR, VideoMode.HGR
    sub = editdist.cost_matrix(Palette.NTSC, dev)
    rng = np.random.RandomState(3)
    entry = report["editdist_tile"] = dict(max_abs_err=0)

    def hold(what, got, a, bb, costs=sub):
        want = editdist.dp_distance_tile(a, bb, costs)
        if int(want.max()) >= 1 << 16:
            raise AssertionError("%s: distances overflow uint16" % what)
        err = int((as_i32(got) - want).abs().max())
        print("kernel A all-pairs %s: max_abs_err=%d" % (what, err))
        if err:
            raise AssertionError("kernel A all-pairs %s disagrees with plain"
                                 % what)

    for mode, (ra, na), (rb, nb) in ((D, (0, 1024), (0, 8192)),
                                     (H, (0, 512), (0, 2048)),
                                     (D, (3, 1000), (1001, 777)),
                                     (H, (7, 300), (900, 517))):
        codes = editdist.lane_codes(mode, 1, dev)
        a = codes[ra:ra + na].contiguous()
        bb = codes[rb:rb + nb].contiguous()
        if editdist.same_codes(a, bb):
            raise AssertionError("a != b taken for one code set")
        hold("%s %dx%d L=%d" % (mode.name, na, nb, codes.shape[1]),
             editdist.pair_distance(a, bb, sub), a, bb)
    # the symmetric path on ragged sets, and one code set under a cost
    # matrix made asymmetric, which the kernel must take the general way
    asym = sub.clone()
    asym[3, 9] += 7
    for mode, n, costs, what in ((D, 999, sub, "symmetric"),
                                 (H, 1000, sub, "symmetric"),
                                 (D, 700, asym, "same codes, asymmetric "
                                                "costs")):
        a = editdist.lane_codes(mode, 1, dev)[2:2 + n].contiguous()
        if not editdist.same_codes(a, a):
            raise AssertionError("one code set twice not taken as such")
        hold("%s %dx%d %s" % (mode.name, n, n, what),
             editdist.pair_distance(a, a, costs), a, a, costs)

    # whole lanes on the symmetric path, sampled rows, then timed
    for mode, tag in ((D, ""), (H, "_hgr")):
        codes = editdist.lane_codes(mode, 0, dev)
        n, L = codes.shape
        out = editdist.pair_distance(codes, codes, sub)
        rows = torch.as_tensor(rng.randint(0, n, 64), device=dev)
        hold("%s %dx%d lane symmetric, 64 rows" % (mode.name, n, n),
             out.view(torch.int16)[rows], codes[rows], codes)
        ms = cuda_ms(lambda: editdist.pair_distance(codes, codes, sub, out),
                     5)
        plain_ms = cuda_ms(
            lambda: editdist.dp_distance_tile(codes, codes, sub), 1)
        # bytes: both code sets read, the cost matrix, the uint16 matrix
        # written; float32 operations (the function's type, and the
        # kernel's): an add, two compares and a min per step of the
        # n(n+1)/2 pairs the symmetric path needs
        bnd = bound(2 * n * L * 4 + 1024 + n * n * 2,
                    n * (n + 1) / 2 * L * 4)
        line = "kernel A all-pairs %s %dx%d lane symmetric: ms=%.4f " \
               "plain_ms=%.3f bound_ms=%.4f (%s)" % (
                   mode.name, n, n, ms, plain_ms, bnd["bound_ms"],
                   bnd["bound_by"])
        if not tag:
            other = codes.clone()
            ms_general = cuda_ms(
                lambda: editdist.pair_distance(codes, other, sub, out), 5)
            line += " general_path_ms=%.4f" % ms_general
            entry.update(bnd, ms=ms, plain_ms=plain_ms,
                         ms_general=ms_general)
        else:
            entry.update(ms_hgr=ms, plain_ms_hgr=plain_ms,
                         bound_ms_hgr=bnd["bound_ms"])
        print(line)
        del out

    # the codes entry: (2, 32, 128) pairs of code strings, L = 10 (DHGR) and
    # L = 18 (HGR), under the NTSC window basis
    rng = np.random.RandomState(7)
    wsub = torch.as_tensor(distance.sub_for(VideoMode.HGR, Palette.NTSC)
                           .astype(np.int32), device=dev)
    entry = report["dist_pairs"] = dict(max_abs_err=0)
    for L, tag in ((10, ""), (18, "_l18")):
        pa, pb = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                  for x in code_pairs(rng, (2, 32, 128), L))
        got = editdist.dist_pairs_elementwise(pa, pb, wsub)
        want = distance.dist_pixel_pairs_plain(pa, pb, wsub)
        err = int((got - want).abs().max())
        ms = cuda_ms(lambda: editdist.dist_pairs_elementwise(pa, pb, wsub),
                     200)
        plain_ms = cuda_ms(
            lambda: distance.dist_pixel_pairs_plain(pa, pb, wsub), 50)
        # its loads are strided by L words per thread (left so): the time
        # at the store-cost build's 2^20 pairs shows what that costs
        big_a, big_b = (torch.as_tensor(rng.randint(0, 16, (1 << 20, L)),
                                        dtype=torch.int32, device=dev)
                        for _ in range(2))
        ms_big = cuda_ms(
            lambda: editdist.dist_pairs_elementwise(big_a, big_b, wsub), 20)
        bnd_big = bound(2 * big_a.numel() * 4 + 1024 + (4 << 20),
                        int_ops=4.0 * L * (1 << 20))
        print("kernel A codes entry 8192 pairs L=%d: max_abs_err=%d "
              "ms=%.4f plain_ms=%.4f; 2^20 pairs: ms=%.4f bound_ms=%.4f (%s)"
              % (L, err, ms, plain_ms, ms_big, bnd_big["bound_ms"],
                 bnd_big["bound_by"]))
        if err:
            raise AssertionError("kernel A's codes entry (L=%d) disagrees "
                                 "with plain" % L)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms" + tag] = ms
        entry["plain_ms" + tag] = plain_ms
        entry["ms_2e20" + tag] = ms_big
        entry["bound_ms_2e20" + tag] = bnd_big["bound_ms"]
        if not tag:
            entry.update(bound(2 * pa.numel() * 4 + 1024
                               + pa[..., 0].numel() * 4,
                               int_ops=4.0 * L * pa[..., 0].numel()))


def code_pairs(rng, shape, L: int):
    """Random (shape + (L,)) code pairs in 0..15; in half of them the
    second string is the first with one adjacent pair swapped, so the
    transposition branch is taken."""
    import numpy as np

    pa = rng.randint(0, 16, shape + (L,))
    pb = rng.randint(0, 16, shape + (L,))
    i = rng.randint(0, L - 1, shape + (1,))
    sw = pa.copy()
    np.put_along_axis(sw, i, np.take_along_axis(pa, i + 1, -1), -1)
    np.put_along_axis(sw, i + 1, np.take_along_axis(pa, i, -1), -1)
    return pa, np.where(rng.rand(*shape, 1) < 0.5, sw, pb)


def swap_bits(rng, vals, n_bits: int, apart: int):
    """`vals` with bits i and i + apart exchanged, i drawn per element.
    Two neighbouring colour codes are 4-dot windows that share three dots
    and sit one NTSC phase apart, so what transposes them is the exchange
    of the two dots four apart around the shared ones: bits four apart of a
    DHGR lane (whose value is its dots), two apart of an HGR lane (whose
    body bits are two dots each)."""
    i = rng.randint(0, n_bits - apart, vals.shape)
    flip = ((vals >> i) ^ (vals >> (i + apart))) & 1
    return vals ^ (flip << i) ^ (flip << (i + apart))


def lane_dist_cases(dev, rng, mode, lane: int):
    """[(what, a, b)]: the lane-distance check's pairs for one lane.  Every
    masked value against a fixed one; random pairs as lane views of
    (16, 32, 128, n_lanes) arrays (the scorer's call); pairs an exchange of
    two dots apart that transposes neighbouring codes (`swap_bits`); a
    column broadcast along rows (the store-cost build's call); a permuted
    view."""
    import torch

    from iivision_tpu_torch.screen import spec_for_mode
    from iivision_tpu_torch.video_mode import VideoMode

    spec = spec_for_mode(mode)
    bits = int(spec.MASKED_BITS)
    n = 1 << bits
    both = random_state(dev, rng, (2, 16, 32, 128, int(spec.N_LANES)), n)
    va = rng.randint(0, n, (32, 128))
    vb = swap_bits(rng, va, bits, 4 if mode == VideoMode.DHGR else 2)
    new = random_state(dev, rng, (512, 128), n)
    perm = random_state(dev, rng, (6, 7, 5), n).permute(2, 0, 1)
    return [
        ("every value against one",
         torch.arange(n, dtype=torch.int32, device=dev),
         torch.full((n,), int(rng.randint(n)), dtype=torch.int32,
                    device=dev)),
        ("lane views", both[0][..., lane], both[1][..., lane]),
        ("swapped dots", torch.as_tensor(va, dtype=torch.int32, device=dev),
         torch.as_tensor(vb, dtype=torch.int32, device=dev)),
        ("broadcast column", new,
         random_state(dev, rng, (512, 1), n).expand_as(new)),
        ("permuted view", perm, perm.flip(0))]


def check_lane_dist(dev, report):
    """Kernel A's lane-distance entry (through distance.dist_lane_pairs)
    against dist_lane_pairs_plain, bit-equal, for all 4 DHGR and both HGR
    lanes under the NTSC window and the mono basis, on the pairs of
    `lane_dist_cases`; each call must be one launch, and some swapped pairs
    must reach the transposition branch.  One call under the profiler must
    show one device kernel.  Timed at the scorer's 65,536 pairs and the
    store-cost build's 2^20 pairs, DHGR and HGR, each beside its bound;
    then the scorer's call end to end (wrapper and kernel) beside the
    earlier form: lane_pixels on both sides, then the codes entry."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iivision_tpu_torch.ops import distance, editdist
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.screen import spec_for_mode
    from iivision_tpu_torch.video_mode import VideoMode

    entry = report["lane_dist"] = dict(max_abs_err=0)
    rng = np.random.RandomState(17)

    def basis(mode, model):
        return torch.as_tensor(distance.sub_for(mode, Palette.NTSC, model)
                               .astype(np.int32), device=dev)

    def hold(what, a, b, mode, lane, sub):
        """One call against plain; returns how many pairs offer a
        transposition (neighbouring codes exchanged and different)."""
        before = editdist.lane_distance.launches
        got = distance.dist_lane_pairs(a, b, mode, lane, sub)
        if editdist.lane_distance.launches != before + 1:
            raise AssertionError("dist_lane_pairs (%s) is not one launch"
                                 % what)
        want = distance.dist_lane_pairs_plain(a, b, mode, lane, sub)
        err = int((got - want).abs().max())
        if err or got.shape != a.shape or not torch.equal(got, want):
            raise AssertionError("lane distance %s lane %d (%s) disagrees "
                                 "with plain: max_abs_err=%d" % (
                                     mode.name, lane, what, err))
        pa = distance.lane_pixels(a, mode, lane)
        pb = distance.lane_pixels(b, mode, lane)
        return int(((pa[..., 1:] == pb[..., :-1])
                    & (pa[..., :-1] == pb[..., 1:])
                    & (pa[..., 1:] != pa[..., :-1])).any(-1).sum())

    for mode in (VideoMode.DHGR, VideoMode.HGR):
        nl = int(spec_for_mode(mode).N_LANES)
        for model in ("window", "mono"):
            sub = basis(mode, model)
            pairs = transposed = 0
            for lane in range(nl):
                for what, a, b in lane_dist_cases(dev, rng, mode, lane):
                    n_tr = hold(what, a, b, mode, lane, sub)
                    pairs += a.numel()
                    if what == "swapped dots":
                        transposed += n_tr
            print("lane distance %s %s: %d lanes, %d pairs, max_abs_err=0; "
                  "%d of the swapped pairs offer a transposition" % (
                      mode.name, model, nl, pairs, transposed))
            if not transposed:
                raise AssertionError("no pair reached the transposition "
                                     "branch")

    D = VideoMode.DHGR
    for mode, tag in ((D, ""), (VideoMode.HGR, "_hgr")):
        spec = spec_for_mode(mode)
        n, L = 1 << int(spec.MASKED_BITS), int(spec.MASKED_DOTS)
        sub = basis(mode, "window")
        both = random_state(dev, rng, (2, 16, 32, 128, int(spec.N_LANES)), n)
        C = distance.n_contents(mode)
        new = random_state(dev, rng, ((1 << 20) // C, C), n)
        col = random_state(dev, rng, (new.shape[0], 1), n)
        for size, a, b, nbytes, reps in (
                ("", both[0][..., 1], both[1][..., 1], 3 * 4 << 16, 200),
                ("_2e20", new, col.expand_as(new),
                 (2 * 4 << 20) + col.numel() * 4, 50)):
            ms = cuda_ms(lambda: distance.dist_lane_pairs(a, b, mode, 1, sub),
                         reps)
            plain_ms = cuda_ms(lambda: distance.dist_lane_pairs_plain(
                a, b, mode, 1, sub), 3)
            # bytes: each lane value read once, each distance written, the
            # cost matrix; int32 operations per step and pair: a shift and
            # a mask for each side's code, then an add, two compares and a
            # min (the rotation and HGR's dot expansion left out)
            bnd = bound(nbytes + 1024, int_ops=8.0 * L * a.numel())
            print("lane distance %s %d pairs L=%d: ms=%.4f plain_ms=%.4f "
                  "bound_ms=%.5f (%s)" % (mode.name, a.numel(), L, ms,
                                          plain_ms, bnd["bound_ms"],
                                          bnd["bound_by"]))
            entry["ms" + tag + size] = ms
            entry["plain_ms" + tag + size] = plain_ms
            entry["bound_ms" + tag + size] = bnd["bound_ms"]
            if not tag + size:
                entry.update(bnd)

    # the scorer's call: one device kernel; wrapper and kernel, against the
    # earlier form's torch ops (host time, which cuda_ms does not see)
    sub = basis(D, "window")
    both = random_state(dev, rng, (2, 16, 32, 128, 4), 1 << 13)
    a, b = both[0][..., 1], both[1][..., 1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        distance.dist_lane_pairs(a, b, D, 1, sub)
        torch.cuda.synchronize()
    by_name, _ = profiled_kernels(prof)
    if sum(v[0] for v in by_name.values()) != 1 \
            or not any("lane_dist" in k for k in by_name):
        raise AssertionError("dist_lane_pairs ran %s on the card, not one "
                             "lane-distance kernel" % by_name)
    after = wrapper_ms(lambda: distance.dist_lane_pairs(a, b, D, 1, sub), 50)
    before = wrapper_ms(lambda: editdist.dist_pairs_elementwise(
        distance.lane_pixels(a, D, 1), distance.lane_pixels(b, D, 1), sub),
        50)
    print("dist_lane_pairs DHGR 65536 pairs, wrapper and kernel: "
          "wrapper_ms=%.4f (one kernel: %s); lane_pixels on both sides, then "
          "the codes entry: wrapper_ms=%.4f" % (after, list(by_name)[0],
                                                before))
    entry.update(wrapper_ms=after, wrapper_ms_codes_form=before)


def random_state(dev, rng, shape, hi: int):
    """int32 tensor of the given shape, uniform in [0, hi)."""
    import torch

    return torch.as_tensor(rng.randint(0, hi, shape), dtype=torch.int32,
                           device=dev)


# the recompute's checks: (mode, model, B, bank, tag, palette name)
CHUNK_START_CASES = (
    ("DHGR", "window", 1, 0, "", "NTSC"),
    ("DHGR", "window", 1, 1, "_aux", "NTSC"),
    ("DHGR", "mono", 32, 1, "_mono_b32", "NTSC"),
    ("DHGR", "window", 32, 0, "_b32", "NTSC"),
    ("HGR", "window", 1, 0, "_hgr", "NTSC"),
    ("HGR", "mono", 32, 0, "_hgr_mono_b32", "NTSC"),
    ("DHGR", "yiq", 1, 0, "", "NTSC"), ("DHGR", "yiq", 1, 1, "_aux", "NTSC"),
    ("DHGR", "yiq", 32, 1, "_aux_b32", "NTSC"),
    ("DHGR", "yiq", 32, 0, "_b32", "NTSC"),
    ("HGR", "yiq", 1, 0, "_hgr", "NTSC"),
    ("HGR", "yiq", 32, 0, "_hgr_b32", "NTSC"),
    # the IIGS palette: window bases, and HGR's yiq stack (the table no
    # package ships)
    ("DHGR", "window", 1, 1, "_iigs_aux", "IIGS"),
    ("DHGR", "window", 32, 0, "_iigs_b32", "IIGS"),
    ("HGR", "window", 1, 0, "_hgr_iigs", "IIGS"),
    ("HGR", "window", 32, 0, "_hgr_iigs_b32", "IIGS"),
    ("HGR", "yiq", 1, 0, "_hgr_iigs", "IIGS"),
    ("HGR", "yiq", 32, 0, "_hgr_iigs_b32", "IIGS"))


def check_chunk_start(dev, report):
    """The body kernel's recompute prologue: a body launched with the cost
    basis (`encode_body(..., sub=...)`) against chunk_start_plain then
    encode_body_plain, up, dw, banks and records bit-equal, on every case
    of CHUNK_START_CASES: DHGR (both banks) and HGR, window, mono and yiq
    bases (the yiq recompute its own entry), B = 1 and 32, the NTSC
    palette's bases and the IIGS palette's window bases and HGR yiq
    stack; each case on a real plan body at k=8 j=1 (padded and partial
    steps), seeded random 8-bit banks, targets and state, both content
    rules, seeded and deterministic in turn, at the chooser's cluster size
    and at each of 1, 2, 4, 8 and 16.  The body's part reads the palette's
    window store-cost table whatever the model (it is the body kernel's
    own check).  Timed at the chooser's size, default rule: the fused
    launch, the same body without the recompute, and the plain pair."""
    import numpy as np
    import torch

    from iivision_tpu_torch import roofline
    from iivision_tpu_torch.ops import body, chunk_start, distance
    from iivision_tpu_torch.ops import random as trandom
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    report["chunk_start"] = dict(max_abs_err=0)
    report["chunk_start_yiq"] = dict(max_abs_err=0)
    k, j = 8, 1
    for i, (mode_name, model, B, bank, tag, pal_name) in enumerate(
            CHUNK_START_CASES):
        mode, pal = VideoMode[mode_name], Palette[pal_name]
        entry = report["chunk_start_yiq" if model == "yiq" else "chunk_start"]
        rng = np.random.RandomState(i + 11)
        plan, b0, state, lanes, bytes_tgt, table, nvalid, ops = body_inputs(
            dev, mode, k, j, B, 200 + i, palette=pal)
        nb = chunk_start.n_banks(mode)
        state = [random_state(dev, rng, (B, nb, 32, 256), 5000),
                 random_state(dev, rng, (B, nb, 32, 256), 900),
                 random_state(dev, rng, (B, nb, 32, 256), 256)]
        sub = torch.as_tensor(distance.sub_for(mode, pal, model)
                              .astype(np.int32), device=dev)
        Sc, frame = plan.chunk_steps, int(plan.step_frame[b0])
        for joint in (False, True):
            seeded = (i + joint) % 2 == 0
            keys = trandom.key_words(range(B), dev) if seeded else None
            rest = (lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0,
                    Sc)
            want = [x.clone() for x in state] + [ops.clone()]
            body.encode_body_plain(*want[:3], *rest, want[3], mode, joint,
                                   sub=sub)
            for c in (None,) + body.CLUSTER_SIZES:
                got = [x.clone() for x in state] + [ops.clone()]
                body.encode_body(*got[:3], *rest, got[3], mode, joint,
                                 sub=sub, cluster=c)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    bad = [n for n, g, w in zip(("up", "dw", "banks", "ops"),
                                                got, want)
                           if not torch.equal(g, w)]
                    raise AssertionError(
                        "body with the recompute (%s %s %s B=%d bank=%d "
                        "joint=%s, cluster %s) disagrees with plain in %s"
                        % (mode_name, pal_name, model, B, bank, joint,
                           c or "chosen", bad))
        keys = trandom.key_words(range(B), dev)
        rest = (lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0, Sc)

        def fresh():
            return tuple(x.clone() for x in state) + (ops.clone(),)

        ms = cuda_ms(lambda u, d, b, o: body.encode_body(
            u, d, b, *rest, o, mode, sub=sub), 100, setup=fresh)
        body_ms = cuda_ms(lambda u, d, b, o: body.encode_body(
            u, d, b, *rest, o, mode), 100, setup=fresh)
        plain_ms = cuda_ms(lambda u, d, b, o: body.encode_body_plain(
            u, d, b, *rest, o, mode, sub=sub), 2, setup=fresh)
        nv = plan.step_nvalid[b0:b0 + Sc]
        # bytes and operations of the fused launch: roofline.body_cost of
        # a recomputing body plus roofline.chunk_start_cost
        cost = np.add(roofline.body_cost(mode, k, j, B, Sc,
                                         int((nv > 0).sum()), False, True,
                                         recompute=True),
                      roofline.chunk_start_cost(mode, B, model))
        bnd = bound(*cost)
        print("chunk_start (body prologue) %s %s %s B=%d bank=%d: bit-equal "
              "to plain at every cluster size, both rules; seeded k=%d j=%d "
              "steps=%d ms=%.4f (the body without the recompute %.4f) "
              "plain_ms=%.4f bound_ms=%.5f (%s)" % (
                  mode_name, pal_name, model, B, bank, k, j, Sc, ms, body_ms,
                  plain_ms, bnd["bound_ms"], bnd["bound_by"]))
        entry["ms" + tag] = ms
        entry["body_ms" + tag] = body_ms
        entry["plain_ms" + tag] = plain_ms
        if not tag:
            entry.update(bnd)


def check_threefry(dev, report):
    """The body kernel's threefry (iiv_threefry_uniform) against
    ops/random.step_nonces on the card, bit-equal: 32 keys, steps from 0 to
    2^20, k = 16 slots, j = 4 sub-ops."""
    import torch

    from iivision_tpu_torch.ops import body
    from iivision_tpu_torch.ops import random as trandom

    seeds = list(range(28)) + [2 ** 31 - 1, -1, -5, 123456789]
    keys = trandom.key_words(seeds, dev)
    steps = torch.tensor([0, 1, 2, 37, 4095, 65536, 999999, 1 << 20],
                         dtype=torch.int32, device=dev)
    k, j = 16, 4
    got = body.threefry_uniform(keys, steps, k, j)
    want = trandom.step_nonces(trandom.prng_keys(seeds, dev),
                               steps.to(torch.int64), k, j)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g.view(torch.int32),
                                                 w.view(torch.int32)):
            raise AssertionError("threefry kernel bits differ from "
                                 "step_nonces")
    ms = cuda_ms(lambda: body.threefry_uniform(keys, steps, k, j), 100)
    plain_ms = cuda_ms(lambda: trandom.step_nonces(
        trandom.prng_keys(seeds, dev), steps.to(torch.int64), k, j), 3)
    nbytes = sum(x.numel() * 4 for x in got) + keys.numel() * 4
    print("threefry B=%d steps=%d k=%d j=%d: %d nonces bit-equal ms=%.4f "
          "plain_ms=%.4f" % (len(seeds), len(steps), k, j,
                             sum(x.numel() for x in got), ms, plain_ms))
    report["threefry_uniform"] = dict(max_abs_err=0.0, ms=ms,
                                      plain_ms=plain_ms, **bound(nbytes))


def pick_body(plan) -> int:
    """First step of the first body that holds both a padded step (nvalid
    0) and a partial one (0 < nvalid < k * j); where no body has both (a
    body of one step at k=32 j=10, no partial step at k=1 j=1), the first
    that holds a partial step, else the first that holds a padded one."""
    Sc, full = plan.chunk_steps, plan.k * plan.j
    bodies = [(b0, plan.step_nvalid[b0:b0 + Sc])
              for b0 in range(0, len(plan.step_nvalid), Sc)]
    def padded(nv):
        return (nv == 0).any()

    def partial(nv):
        return ((nv > 0) & (nv < full)).any()

    for want in (lambda nv: padded(nv) and partial(nv), partial, padded):
        for b0, nv in bodies:
            if want(nv):
                return b0
    raise AssertionError("no body with a padded or a partial step")


@functools.lru_cache(None)
def window_table(dev, mode, palette):
    """The (n_lanes * R, C) int16 store-cost table of `palette`'s window
    model on the card, loaded once per mode and palette (read-only)."""
    from iivision_tpu_torch.ops import distance

    dist = distance.ComputedDistance(mode, palette, device=dev)
    return dist.store_cost16.reshape(-1, dist.n_contents)


def body_inputs(dev, mode, k: int, j: int, B: int, seed: int,
                tie: bool = False, palette=None):
    """A real plan's body (1 s at 30 fps, every 2nd frame) with seeded
    random targets and state for B movies, on `palette`'s window
    store-cost table (default NTSC).  tie: every up equal, so each page
    and offset choice falls to the nonces."""
    import numpy as np
    import torch

    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import chunk_start
    from iivision_tpu_torch.palettes import Palette

    rng = np.random.RandomState(seed)
    plan, n_enc = encoder.plan_movie(
        n_frames=30, n_audio_ticks=14700, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=2, mode=mode, k=k,
        j=j)
    b0 = pick_body(plan)
    nb = chunk_start.n_banks(mode)
    hi = 128 if nb == 2 else 256
    tgt = rng.randint(0, hi, (B, n_enc, 2, 32, 256))
    if nb == 1:
        tgt[:, :, 1] = tgt[:, :, 0]
    bytes_tgt = torch.as_tensor(tgt, dtype=torch.int32, device=dev)
    lanes = chunk_start.masked_lanes(bytes_tgt[:, :, :nb], mode).contiguous()
    up = (torch.full((B, nb, 32, 256), 1000, dtype=torch.int32, device=dev)
          if tie else random_state(dev, rng, (B, nb, 32, 256), 3000)
          * random_state(dev, rng, (B, nb, 32, 256), 2))
    state = [up.contiguous(), random_state(dev, rng, (B, nb, 32, 256), 900),
             random_state(dev, rng, (B, nb, 32, 256), hi)]
    table = window_table(dev, mode, palette or Palette.NTSC)
    S = len(plan.step_frame)
    ops = torch.full((S, B, j, k, 6), 7, dtype=torch.uint8, device=dev)
    nvalid = torch.tensor(plan.step_nvalid, dtype=torch.int32, device=dev)
    return plan, b0, state, lanes, bytes_tgt, table, nvalid, ops


# (mode name, k, j, batch sizes) of the body kernel on the bench's paths
# beyond the smoke's own
BENCH_BODIES = (("DHGR", 32, 10, (1, 32)), ("DHGR", 32, 1, (1, 32)),
                ("DHGR", 1, 1, (1, 32)), ("DHGR", 16, 8, (1, 32)),
                ("DHGR", 32, 4, (1, 32)), ("DHGR", 32, 8, (1, 32)),
                ("DHGR", 16, 4, (10, 16)), ("HGR", 16, 4, (1, 10, 32)))


def check_body(dev, report, joint: bool = False):
    """The body kernel against encode_body_plain (the per-step torch loop
    with the plain sub-op chain and step_nonces), state and records
    bit-equal, on real plan bodies that hold padded and partial steps:
    DHGR k=8 j=1 and k=16 j=4, HGR k=8 j=1 (256 contents), B = 1 and 32,
    seeded and deterministic, and tie-heavy bodies (every up equal); and
    the bench's settings (BENCH_BODIES): DHGR (32, 10), (32, 1), (1, 1),
    (16, 8), (32, 4) and (32, 8) at B = 1 and 32, DHGR (16, 4) at B = 10
    and 16, and HGR (16, 4) at B = 1, 10 and 32, seeded and
    deterministic; and on the IIGS palette's tables, DHGR k=16 j=4 and HGR
    k=8 j=1 at B = 1 and 32, seeded and deterministic.
    joint: the kernel's joint instantiation (its own entry), timed at DHGR
    k=16 j=4 (the quality clip's setting) B = 1 and 32 and on HGR, plus
    bodies whose contents tie: dw all zero (no companion gain: the
    cheapest contents at the primary tie) and one cost for every content
    (every content ties); DHGR k=32 j=10 (all 32 pages run a slot) and the
    IIGS cases above, each at B = 1 and 32, seeded and deterministic.
    Each case runs at the chooser's cluster size (`body.cluster_size` on
    the card's maximum active clusters; timed, beside its bound with the
    nonce draws' int32 operations and its issue floor) and at every
    cluster size the kernel takes, each bit-equal to the one plain run."""
    import torch

    from iivision_tpu_torch import roofline
    from iivision_tpu_torch.ops import body
    from iivision_tpu_torch.ops import random as trandom
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    D, H = VideoMode.DHGR, VideoMode.HGR
    name = "encode_body_joint" if joint else "encode_body"
    entry = report[name] = dict(max_abs_err=0)
    # the IIGS palette's window tables (HGR's costs reach 1681)
    iigs = tuple((mode, k, j, B, seeded, "iigs", "%s_iigs_k%d_j%d%s%s" % (
        "_hgr" if mode == H else "", k, j, "_b%d" % B if B > 1 else "",
        "" if seeded else "_det"))
        for mode, k, j in ((D, 16, 4), (H, 8, 1))
        for B in (1, 32) for seeded in (True, False))
    cases = ((D, 16, 4, 1, True, None, ""),
             (D, 16, 4, 1, False, None, "_det"),
             (D, 16, 4, 32, True, None, "_b32"),
             (D, 8, 1, 1, True, None, "_k8_j1"),
             (D, 8, 1, 32, False, None, "_k8_j1_b32_det"),
             (H, 8, 1, 1, True, None, "_hgr"),
             (H, 8, 1, 32, True, None, "_hgr_b32"),
             (D, 16, 4, 32, True, "tie", "_tie_b32"),
             (D, 16, 4, 1, True, "zero_dw", "_zero_dw"),
             (H, 8, 1, 1, False, "one_cost", "_one_cost_hgr"),
             # the solo headline's setting, every warp running a slot
             *((D, 32, 10, B, seeded, None, "_k32_j10%s%s" % (
                 "_b%d" % B if B > 1 else "", "" if seeded else "_det"))
               for B in (1, 32) for seeded in (True, False)),
             *iigs) if joint else (
        (D, 8, 1, 1, True, None, ""),
        (D, 8, 1, 1, False, None, "_det"),
        (D, 16, 4, 1, True, None, "_k16_j4"),
        (D, 16, 4, 32, True, None, "_b32_k16_j4"),
        (D, 16, 4, 32, False, None, "_b32_k16_j4_det"),
        (H, 8, 1, 1, True, None, "_hgr"),
        (H, 8, 1, 32, True, None, "_hgr_b32"),
        (D, 8, 1, 32, True, "tie", "_tie_b32"),
        (D, 16, 4, 32, True, "tie", "_tie_b32_k16_j4"),
        (H, 8, 1, 1, False, "tie", "_tie_hgr_det"),
        # the bench's settings: the solo headline (every warp runs a
        # slot), the k/j sweep's, HGR at k=16 j=4 (its BASELINE configs
        # and B=10 batch), and the B=10 and 16 DHGR batches
        *((mode, k, j, B, seeded, None, "%s_k%d_j%d%s%s" % (
            "_hgr" if mode == H else "", k, j, "_b%d" % B if B > 1 else "",
            "" if seeded else "_det"))
          for name_, k, j, batches in BENCH_BODIES
          for mode in (VideoMode[name_],)
          for B in batches for seeded in (True, False)),
        *iigs)
    counts = body.max_active_clusters(dev, joint)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for mode, k, j, B, seeded, kind, tag in cases:
        plan, b0, state, lanes, bytes_tgt, table, nvalid, ops = body_inputs(
            dev, mode, k, j, B, 50 + len(entry) + 100 * joint, kind == "tie",
            Palette.IIGS if kind == "iigs" else None)
        if kind == "zero_dw":
            state[1].zero_()
        elif kind == "one_cost":
            table = torch.full_like(table, 100)
        Sc = plan.chunk_steps
        frame, bank = int(plan.step_frame[b0]), int(plan.step_bank[b0])
        keys = trandom.key_words(range(B), dev) if seeded else None
        want = [x.clone() for x in state] + [ops.clone()]
        body.encode_body_plain(*want[:3], lanes, bytes_tgt, frame, bank,
                               table, keys, nvalid, b0, Sc, want[3], mode,
                               joint)
        chosen = body.cluster_size(B, k, j, joint, counts)
        # the chooser's size (cluster=None), then every size
        for c in (None,) + body.CLUSTER_SIZES:
            got = [x.clone() for x in state] + [ops.clone()]
            body.encode_body(*got[:3], lanes, bytes_tgt, frame, bank, table,
                             keys, nvalid, b0, Sc, got[3], mode, joint,
                             cluster=c)
            torch.cuda.synchronize()
            err = max(int((g.int() - w.int()).abs().max())
                      for g, w in zip(got, want))
            if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
                bad = [i for i, (g, w) in enumerate(zip(got, want))
                       if not torch.equal(g, w)]
                raise AssertionError(
                    "%s kernel (%s, cluster %s) disagrees with plain in %s "
                    "(up, dw, banks, ops)" % (name, tag or mode.name,
                                              c or "chosen", bad))
            if not (got[3][b0:b0 + Sc] != 7).any():
                raise AssertionError("%s %s wrote no record" % (name, tag))
        st = [x.clone() for x in state] + [ops.clone()]
        ms = cuda_ms(lambda: body.encode_body(
            *st[:3], lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0,
            Sc, st[3], mode, joint), 50 if joint else 100)
        plain_ms = cuda_ms(lambda: body.encode_body_plain(
            *st[:3], lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0,
            Sc, st[3], mode, joint), 2)
        nv = plan.step_nvalid[b0:b0 + Sc]
        # bytes, float32 operations and the nonce draws' int32 operations:
        # roofline.body_cost
        nbytes, ops_f, ops_i = roofline.body_cost(
            mode, k, j, B, Sc, int((nv > 0).sum()), joint, seeded)
        bnd = bound(nbytes, ops_f, ops_i)
        floor_ms = issue_floor_ms(ops_i, min(B * chosen, n_sm))
        print("%s %s k=%d j=%d B=%d seeded=%s %s steps=%d nvalid=%s: "
              "max_abs_err=0 at cluster %d (chosen) and at %s; ms=%.4f "
              "plain_ms=%.4f bound_ms=%.5f (%s) issue_floor_ms=%.5f" % (
                  name, mode.name, k, j, B, seeded, kind or "", Sc,
                  nv.tolist(), chosen, list(body.CLUSTER_SIZES), ms,
                  plain_ms, bnd["bound_ms"], bnd["bound_by"], floor_ms))
        entry["ms" + tag] = ms
        entry["plain_ms" + tag] = plain_ms
        entry["cluster" + tag] = chosen
        if not tag:
            entry.update(bnd, issue_floor_ms=floor_ms)


def issue_floor_ms(int_ops: float, sms: int) -> float:
    """The body kernel's own floor: its int32 operations issued at 64
    lanes a clock on each of the `sms` SMs its launch uses, at
    SM_CLOCK_HZ."""
    return int_ops / (sms * 64 * SM_CLOCK_HZ) * 1e3


# (mode name, k, j, B, seeded, joint) of the cluster sweep: the solo
# headline's body both ways and joint, the batch at B = 32, the one-op
# settings and HGR's 8-step body
SWEEP = (("DHGR", 32, 10, 1, True, False), ("DHGR", 32, 10, 1, False, False),
         ("DHGR", 32, 10, 1, True, True), ("DHGR", 16, 4, 32, True, False),
         ("DHGR", 8, 1, 1, True, False), ("DHGR", 1, 1, 1, True, False),
         ("HGR", 16, 4, 1, True, False))


def placement(dev, args, B: int, c: int):
    """One body launch of `args` at cluster size c with each CTA's SM
    recorded: (distinct SMs, whether two CTAs of one cluster shared an
    SM)."""
    import torch

    from iivision_tpu_torch.ops import body

    smids = torch.full((B * c,), -1, dtype=torch.int32, device=dev)
    body.encode_body(*args, cluster=c, smids=smids)
    ids = smids.tolist()
    if min(ids) < 0:
        raise AssertionError("a CTA did not record its SM")
    shared = any(len(set(ids[m * c:(m + 1) * c])) < c for m in range(B))
    return len(set(ids)), shared


def enqueue_us(fn, n: int = 200) -> float:
    """Host microseconds per call of fn() (a wrapper and its launch), over
    n calls queued behind a device sleep, so that no call waits for the
    card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.1 * 2e9))  # about 0.1 s at 2e9 cycles a second
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def host_us(call, n: int = 200) -> dict:
    """Host microseconds per call of a kernel wrapper: the whole call
    (`enqueue_us`), its Python side alone (the C entry replaced by a no-op)
    and the CUDA runtime's launch call inside it (torch.profiler's CPU
    time of that API call, over n calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iivision_tpu_torch import _build

    out = dict(call=enqueue_us(call, n))
    real = _build.launch
    _build.launch = lambda *args: None
    try:
        out["python"] = enqueue_us(call, n)
    finally:
        _build.launch = real
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.1 * 2e9))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            call()
    torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx"):
            out[e.key] = e.cpu_time_total / max(e.count, 1)
    return out


def body_cluster_sweep(dev, report):
    """The body kernel's device time at every cluster size, each call on
    the same fresh state (SWEEP), with and without the chunk start's
    recompute in its prologue (the NTSC window basis), beside the plain
    pair (chunk_start_plain then encode_body_plain), the chooser's size,
    the design's issue floor at each size and the card's maximum active
    clusters per size and rule; then where the CTAs ran, each CTA's SM
    recorded at every size for the solo (32, 10) body and the B = 32
    batch; and the host's time per body launch (`host_us`), with and
    without the recompute.  Fails unless the solo headline's body runs on
    more than one SM."""
    import numpy as np
    import torch

    from iivision_tpu_torch import roofline
    from iivision_tpu_torch.ops import body, distance
    from iivision_tpu_torch.ops import random as trandom
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    counts = {joint: body.max_active_clusters(dev, joint)
              for joint in (False, True)}
    print("body max_active_clusters (cluster size: clusters; %d SMs): "
          "default %s joint %s" % (n_sm, counts[False], counts[True]))
    sweep = report["encode_body"]["sweep"] = []
    for mode_name, k, j, B, seeded, joint in SWEEP:
        mode = VideoMode[mode_name]
        plan, b0, state, lanes, bytes_tgt, table, nvalid, ops = body_inputs(
            dev, mode, k, j, B, 77)
        Sc = plan.chunk_steps
        frame, bank = int(plan.step_frame[b0]), int(plan.step_bank[b0])
        keys = trandom.key_words(range(B), dev) if seeded else None
        rest = (lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0, Sc,
                ops, mode, joint)

        def fresh():
            return tuple(x.clone() for x in state)

        def timed(**kw):
            return cuda_ms(lambda u, d, b: body.encode_body(u, d, b, *rest,
                                                            **kw),
                           30 if joint else 50, setup=fresh)

        sub = torch.as_tensor(distance.sub_for(mode, Palette.NTSC)
                              .astype(np.int32), device=dev)
        ms = {c: timed(cluster=c) for c in body.CLUSTER_SIZES}
        ms_fused = {c: timed(cluster=c, sub=sub) for c in body.CLUSTER_SIZES}
        plain_ms = cuda_ms(lambda u, d, b: body.encode_body_plain(
            u, d, b, *rest, sub=sub), 2, setup=fresh)
        chosen = body.cluster_size(B, k, j, joint, counts[joint])
        nv = plan.step_nvalid[b0:b0 + Sc]
        _, _, ops_i = roofline.body_cost(mode, k, j, B, Sc,
                                         int((nv > 0).sum()), joint, seeded)
        rec = dict(mode=mode_name, k=k, j=j, B=B, seeded=seeded, joint=joint,
                   ms=ms, ms_fused=ms_fused, plain_pair_ms=plain_ms,
                   chosen=chosen,
                   floor_ms={c: issue_floor_ms(ops_i, min(B * c, n_sm))
                             for c in body.CLUSTER_SIZES})
        line = "body_cluster_sweep %s k=%d j=%d B=%d seeded=%s joint=%s " \
            "steps=%d run=%d:" % (mode_name, k, j, B, seeded, joint, Sc,
                                  int((nv > 0).sum()))
        for c in body.CLUSTER_SIZES:
            line += " c=%d ms=%.4f recompute_ms=%.4f (issue_floor_ms=%.5f)" \
                % (c, ms[c], ms_fused[c], rec["floor_ms"][c])
        print("%s; chosen c=%d: %.4f ms, %.3fx of c=1, within 5%% of c=1: "
              "%s; with the recompute %.4f ms; the plain pair %.4f ms" % (
                  line, chosen, ms[chosen], ms[chosen] / ms[1],
                  ms[chosen] <= 1.05 * ms[1], ms_fused[chosen], plain_ms))
        args = (*fresh(), *rest)
        if (mode_name, k, j, B, seeded, joint) == SWEEP[0] or B == 32:
            for c in body.CLUSTER_SIZES:
                sms, shared = placement(dev, args, B, c)
                print("body placement B=%d c=%d: %d CTAs on %d SMs, two "
                      "CTAs of a cluster shared an SM: %s" % (
                          B, c, B * c, sms, shared))
                rec["placement_c%d" % c] = (sms, shared)
        if (mode_name, k, j, B, seeded, joint) == SWEEP[0]:
            if chosen < 2 or rec["placement_c%d" % chosen][0] < 2:
                raise AssertionError("the solo (32, 10) body runs on one SM")
            st = fresh()
            rec["host_us"] = host_us(lambda: body.encode_body(*st, *rest))
            rec["host_us_recompute"] = host_us(
                lambda: body.encode_body(*st, *rest, sub=sub))
            print("body DHGR k=32 j=10 B=1 host us per launch: %s; with the "
                  "recompute: %s" % (json.dumps(rec["host_us"]),
                                     json.dumps(rec["host_us_recompute"])))
        sweep.append(rec)


# (mode name, k, j, B, seeded, colour model) of the recomputing steps
# `recompute_steps` times: the solo headline both ways, the batch, HGR's
# 8-step body alone and batched, and yiq solo and batched
STEPS = (("DHGR", 32, 10, 1, True, "window"),
         ("DHGR", 32, 10, 1, False, "window"),
         ("DHGR", 16, 4, 32, True, "window"), ("HGR", 16, 4, 1, True, "window"),
         ("HGR", 16, 4, 32, True, "window"), ("DHGR", 16, 4, 1, True, "yiq"),
         ("DHGR", 16, 4, 32, True, "yiq"))


def recompute_steps(dev):
    """One recomputing body of each STEPS setting (the sweep's seeded
    inputs, the NTSC basis of the model, the window store-cost table), as
    the encoder issues it: device ms per body (`cuda_ms`, fresh state every
    call) beside the body launched without the recompute (`body_ms`), and
    host us per body (`enqueue_us`).  In a tree whose chunk start is a
    kernel of its own (before it became the body kernel's prologue) that
    is the chunk-start launch and then the body launch, so this file run
    from such a tree's root times the pair.  One JSON line a setting."""
    import numpy as np
    import torch

    from iivision_tpu_torch.ops import body, chunk_start, distance
    from iivision_tpu_torch.ops import random as trandom
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    pair = hasattr(chunk_start, "chunk_start")
    for mode_name, k, j, B, seeded, model in STEPS:
        mode = VideoMode[mode_name]
        plan, b0, state, lanes, bytes_tgt, table, nvalid, ops = body_inputs(
            dev, mode, k, j, B, 77)
        Sc = plan.chunk_steps
        frame, bank = int(plan.step_frame[b0]), int(plan.step_bank[b0])
        keys = trandom.key_words(range(B), dev) if seeded else None
        sub = torch.as_tensor(distance.sub_for(mode, Palette.NTSC, model)
                              .astype(np.int32), device=dev)
        rest = (lanes, bytes_tgt, frame, bank, table, keys, nvalid, b0, Sc,
                ops, mode)

        def step(u, d, b):
            if pair:
                chunk_start.chunk_start(b, lanes, frame, bank, sub, u, d,
                                        mode)
                body.encode_body(u, d, b, *rest)
            else:
                body.encode_body(u, d, b, *rest, sub=sub)

        def fresh():
            return tuple(x.clone() for x in state)

        ms = cuda_ms(step, 100, setup=fresh)
        body_ms = cuda_ms(lambda u, d, b: body.encode_body(u, d, b, *rest),
                          100, setup=fresh)
        st = fresh()
        us = enqueue_us(lambda: step(*st))
        print(json.dumps(dict(
            step="%s k=%d j=%d B=%d seeded=%s %s" % (
                mode_name, k, j, B, seeded, model),
            launches=2 if pair else 1, ms=ms, body_ms=body_ms, host_us=us)))


# Variants of the recompute prologue in csrc/body.cu, each (this tree's
# text, the variant's): the design choices `prologue_variants` times
PROLOGUE_VARIANTS = {
    # each code from the dots by lane_code, not from the code before it
    "lane_code": ("""      diag_dp_step(d_m2[x], d[x], ap[x], bp[x],
                   lane_code_next(ap[x], xa[x], k, phase),
                   lane_code_next(bp[x], xb[x], k, phase), sub);""",
                  """      diag_dp_step(d_m2[x], d[x], ap[x], bp[x],
                   lane_code(da[x], k, phase), lane_code(db[x], k, phase),
                   sub);"""),
    "chains2": ("constexpr int kChains = 4;", "constexpr int kChains = 2;"),
    "chains8": ("constexpr int kChains = 4;", "constexpr int kChains = 8;"),
    # the DP left out (wrong distances): what the rest of the prologue
    # costs
    "no_dp": ("        diag_dp_chains(da, db, phase, dhgr ? 10 : 18, sub_s, "
              "d + i0);",
              "        for (int x = 0; x < kChains; ++x)\n"
              "          d[i0 + x] = sub_s[(da[x] ^ db[x]) & 255];"),
    # yiq's windows unrolled: every load of a thread in flight at once
    "yiq_unrolled": ("""  for (int w = 0; w < L; ++w) {
#pragma unroll
    for (int x = 0; x < N; ++x)""", """#pragma unroll 15
  for (int w = 0; w < L; ++w) {
#pragma unroll
    for (int x = 0; x < N; ++x)"""),
}


def prologue_variants(root):
    """Time the recompute prologue's design choices: this tree and each of
    PROLOGUE_VARIANTS as a copy of the package and this file in a
    temporary directory with csrc/body.cu patched, all built at once,
    then `--steps` run in each copy in turn, twice.  Prints each copy's
    ptxas register and spill lines and its `--steps` lines."""
    import shutil

    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for name in ("this tree",) + tuple(PROLOGUE_VARIANTS):
            d = os.path.join(tmp, name.replace(" ", "_"))
            shutil.copytree(os.path.join(root, "iivision_tpu_torch"),
                            os.path.join(d, "iivision_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(root, "chip_smoke.py"), d)
            # the shipped tables, read by path
            os.makedirs(os.path.join(d, "iivision_tpu"))
            os.symlink(os.path.join(root, "iivision_tpu", "data"),
                       os.path.join(d, "iivision_tpu", "data"))
            if name in PROLOGUE_VARIANTS:
                old, new = PROLOGUE_VARIANTS[name]
                src = os.path.join(d, "iivision_tpu_torch", "csrc", "body.cu")
                with open(src) as f:
                    text = f.read()
                if text.count(old) != 1:
                    raise AssertionError("variant %s: its text is not in "
                                         "body.cu once" % name)
                with open(src, "w") as f:
                    f.write(text.replace(old, new))
            dirs[name] = d
        build = ("import sys; sys.path.insert(0, '.'); "
                 "from iivision_tpu_torch import _build; _build.build()")
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d)
                 for d in dirs.values()]
        if any(p.wait() for p in procs):
            raise AssertionError("a prologue variant failed to build")
        for rnd in range(2):
            for name, d in dirs.items():
                out = subprocess.run(
                    [sys.executable, "chip_smoke.py", "--steps"], cwd=d,
                    capture_output=True, text=True, check=True).stdout
                for line in out.splitlines():
                    if line.startswith("{") or "registers" in line \
                            or "spill" in line:
                        print("prologue variant %s, round %d: %s"
                              % (name, rnd, line.strip()), flush=True)


# Dependent cycles of one kernel C sub-op, from its instruction sequence,
# at 4 cycles per dependent ALU operation and 24 per shuffle (assumed; the
# card host has no profiler that could measure them).  One argmax: the
# lane's 8-deep scan, a compare and a select each (8 x 8 = 64), then five
# exchanges of a shuffle and a three-operation compare-and-select
# (5 x 36 = 180): 244.  A sub-op is four argmaxes one after another, the
# primary's product and sum ahead of its scan (8, on the updated
# priority), the eligibility select behind it (12), each companion round's
# drop-out (3 x 10) and the gated update (8): 4 x 244 + 58 = 1034.
SUBOP_CHAIN_CYCLES = 1034
SM_CLOCK_HZ = 1.98e9


def check_kernel_c(dev, report):
    """Kernel C against the plain loop, final up/dw/by bit-equal, at the
    microbenchmark's 512 rows and at 509 (the last block holds one row),
    T = 0, 1 and 100, on its seeded inputs with three crafted rows (the
    last three, so at 509 rows they span the partial block): offset 0 the
    only companion (the later rounds come back to offset 0, which must stay
    stored), every priority and score equal (only the nonce and the
    first-index rule break the ties), and all zero (no real sub-op).
    Timed at T = 100, 400 and 1000 with the slope; the T = 100 time stands
    beside its bound and beside the design's dependent-chain floor."""
    import numpy as np
    import torch

    from iivision_tpu_torch import bench_subop
    from iivision_tpu_torch.ops import subop_bench

    worst = 0.0
    for R in (32 * 16, 509):
        args = bench_subop.fresh(R, 999, dev)
        up, dw, by, _ = args
        for a in (up, dw, by):
            a[R - 3:] = 0.0
        up[R - 3, 10], up[R - 3, 0] = 1000.0, 500.0
        dw[R - 3, 10], dw[R - 3, 0] = 900.0, 800.0
        up[R - 2], dw[R - 2] = 50.0, 40.0
        after = {}
        for T in (0, 1, 100):
            got = subop_bench.run_kernel(*args, T)
            want = after[T] = subop_bench.run_plain(*args, T)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, err)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError("kernel C disagrees with the plain loop "
                                     "at R=%d T=%d: max_abs_err=%g"
                                     % (R, T, err))
        # after one sub-op offset 0 holds its cost (by = 0: 1.0) and the
        # primary's content; the all-zero row never moves
        up1, _, by1 = after[1]
        if float(up1[R - 3, 0]) != 1.0 or by1[R - 3, 0] != args[3][R - 3, 10] \
                or float(after[100][0][R - 1].abs().max()) != 0.0:
            raise AssertionError("the crafted rows did not do their work")
        print("kernel C R=%d T=0,1,100: max_abs_err=%g (crafted rows: "
              "offset-0 companion after one sub-op up[0]=%g by[0]=%g, ties, "
              "all zero)" % (R, worst, up1[R - 3, 0], by1[R - 3, 0]))

    args = bench_subop.fresh(32 * 16, 999, dev)
    R = args[0].shape[0]
    ts = (100, 400, 1000)
    ms = [cuda_ms(lambda: subop_bench.run_kernel(*args, T), reps)
          for T, reps in zip(ts, (50, 20, 10))]
    slope_us = float(np.polyfit(ts, ms, 1)[0]) * 1e3
    plain_ms = cuda_ms(lambda: subop_bench.run_plain(*args, ts[0]), 2)
    # four (R, 256) float32 inputs read, three written; per offset and
    # sub-op 28 float32 operations: six of arithmetic (two products and a
    # sum for the score, a product and a sum for the cost row, a
    # difference), a compare and two selects for each of the four argmaxes
    # (12), the eligibility's two compares and select (3), one drop-out
    # select per companion round (3), four gated-update selects
    bnd = bound(7 * R * 256 * 4, 28.0 * ts[0] * R * 256)
    floor_ms = ts[0] * SUBOP_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3
    print("kernel C B=32 K=16: T=%d ms=%.4f, T=%d ms=%.4f, T=%d ms=%.4f, "
          "slope us_per_subop=%.4f; T=%d: plain_ms=%.4f bound_ms=%.5f (%s) "
          "chain_floor_ms=%.4f (%d cycles a sub-op at %.2f GHz)" % (
              ts[0], ms[0], ts[1], ms[1], ts[2], ms[2], slope_us, ts[0],
              plain_ms, bnd["bound_ms"], bnd["bound_by"], floor_ms,
              SUBOP_CHAIN_CYCLES, SM_CLOCK_HZ / 1e9))
    report["subop_bench"] = dict(
        max_abs_err=worst, ms=ms[0], ms_t400=ms[1], ms_t1000=ms[2],
        slope_us=slope_us, plain_ms=plain_ms, chain_floor_ms=floor_ms, **bnd)


# the ingest kernel's cases: source sizes, and (B, F) batches of each
INGEST_SOURCES = ((192, 280), (192, 140), (360, 640), (720, 1280))
INGEST_BATCHES = ((1, 1), (3, 300), (32, 150))
INGEST_RANDOM_SHARE = 1e-6  # targets a resize half-tie may move, at most
# the ingest kernel of each mode, as the profiler names it
INGEST_KERNELS = {"DHGR": "encode_ingest<((anonymous namespace)::Mode)0>",
                  "HGR": "encode_ingest<((anonymous namespace)::Mode)1>"}


def ingest_frames(dev, content: str, B: int, F: int, h: int, w: int,
                  seed: int):
    """Seeded (B, F, h, w, 3) uint8 frames on the card: uniform random
    ("random"), or the benchmark's synthetic clips ("synth",
    `bench.synth_movies_device`)."""
    import torch

    from iivision_tpu_torch import bench

    if content == "synth":
        return bench.synth_movies_device(B, F, seed, dev, h, w)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (B, F, h, w, 3), dtype=torch.uint8,
                         device=dev, generator=g)


def ingest_case(dev, mode, palette, h: int, w: int, B: int, F: int,
                content: str, seed: int) -> dict:
    """The ingest kernel against `mesh.ingest_batch_plain` (the torch
    chain) on the same card and frames: {"bad": lanes and bytes that
    differ, "n": their count, "share": bad / n, "max_abs_err": the
    largest |kernel - chain| over them}.  A case passes when no
    value differs on the benchmark's content, and when fewer than
    INGEST_RANDOM_SHARE do on random frames (a float64 resize sum that lies
    on a rounding half-tie may round the other way: the chain's einsums
    sum in cuBLAS's order, the kernel tap by tap)."""
    import torch

    from iivision_tpu_torch.ops import ingest
    from iivision_tpu_torch.parallel import mesh

    rgb = ingest_frames(dev, content, B, F, h, w, seed)
    got = ingest.ingest_batch(rgb, mode, palette)
    want = mesh.ingest_batch_plain(rgb, mode, palette)
    bad = n = err = 0
    for g, x in zip(got, want):
        if g.shape != x.shape or g.dtype != x.dtype:
            raise AssertionError("ingest kernel %s %s against plain %s %s"
                                 % (g.dtype, tuple(g.shape), x.dtype,
                                    tuple(x.shape)))
        bad += int((g != x).sum())
        n += g.numel()
        err = max(err, int((g.to(torch.int64) - x).abs().max()))
    share = bad / n
    ok = bad == 0 if content == "synth" else share < INGEST_RANDOM_SHARE
    return dict(bad=bad, n=n, share=share, max_abs_err=err, ok=ok)


def ingest_copies(dev, palette, rgb, modes=None, sessions: int = 3):
    """A second ingest_batch call on `rgb` of each of `modes` (default
    DHGR and HGR), all in one torch.profiler session, each under torch's
    sync debug mode "error" (a synchronising copy raises): {mode name:
    {"launches": the change of `ingest_batch.launches` over its call,
    "kernels": its mode's ingest kernels the profiler recorded}, "other":
    the session's other device activities (copies, sets, other kernels)
    by name}.  A session that recorded no device activity at all says
    nothing and is profiled again, up to `sessions` times; if none did,
    "kernels" and "other" are None (not measured)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from iivision_tpu_torch.ops import ingest
    from iivision_tpu_torch.video_mode import VideoMode

    modes = modes or (VideoMode.DHGR, VideoMode.HGR)
    for mode in modes:
        ingest.ingest_batch(rgb, mode, palette)
    torch.cuda.synchronize()
    out = {m.name: dict(launches=None, kernels=None) for m in modes}
    out["other"] = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for mode in modes:
                before = ingest.ingest_batch.launches
                torch.cuda.set_sync_debug_mode("error")
                try:
                    ingest.ingest_batch(rgb, mode, palette)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                out[mode.name]["launches"] = (ingest.ingest_batch.launches
                                              - before)
            torch.cuda.synchronize()
        acts = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if acts:
            for mode in modes:
                out[mode.name]["kernels"] = sum(
                    1 for a in acts if INGEST_KERNELS[mode.name] in a)
            out["other"] = dict(collections.Counter(
                a for a in acts
                if not any(k in a for k in INGEST_KERNELS.values())))
            break
    return out


def check_ingest(dev, report):
    """The ingest kernel (csrc/ingest.cu) against the torch chain on the
    card (`ingest_case`): DHGR and HGR, NTSC and IIGS, sources 192x280,
    192x140, 360x640 and 720x1280, (B, F) = (1, 1), (3, 300) and (32,
    150), random frames and the benchmark's synthetic clips.  Then a
    second call of each mode counts one launch, runs one kernel and makes
    no host<->device copy (`ingest_copies`), and the B = 32 10 s round of
    the batch cells (150 frames of 192x280) is timed, kernel and chain,
    beside its bound (`bound`): its bytes, and the float64 FMAs of its
    nonzero taps.  The kernels line's entry holds the DHGR round, the
    largest |kernel - chain| and share of targets that differ over every
    case, and the HGR round beside."""
    from iivision_tpu_torch.ops import ingest
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.parallel import mesh
    from iivision_tpu_torch.video_mode import VideoMode

    t0 = time.time()
    worst = worst_err = n_cases = 0
    seed = 17
    for mode in (VideoMode.DHGR, VideoMode.HGR):
        for palette in (Palette.NTSC, Palette.IIGS):
            for h, w in INGEST_SOURCES:
                for B, F in INGEST_BATCHES:
                    for content in ("random", "synth"):
                        seed += 1
                        n_cases += 1
                        c = ingest_case(dev, mode, palette, h, w, B, F,
                                        content, seed)
                        worst = max(worst, c["share"])
                        worst_err = max(worst_err, c["max_abs_err"])
                        if c["bad"] or not c["ok"]:
                            print("ingest %s %s %dx%d B=%d F=%d %s: %d of "
                                  "%d targets differ (share %.3g, largest "
                                  "|kernel - chain| %d)" % (
                                      mode.name, palette.name, h, w, B, F,
                                      content, c["bad"], c["n"],
                                      c["share"], c["max_abs_err"]))
                        if not c["ok"]:
                            raise AssertionError("ingest kernel differs "
                                                 "from the torch chain")
    print("ingest: %d cases against the torch chain, largest share of "
          "targets that differ %.3g, largest |kernel - chain| %d, %.1f s"
          % (n_cases, worst, worst_err, time.time() - t0))
    B, F, h, w = 32, 150, 192, 280
    copies = ingest_copies(dev, Palette.NTSC,
                           ingest_frames(dev, "synth", 4, 20, h, w, 3))
    if any(copies[m.name]["launches"] != 1
           for m in (VideoMode.DHGR, VideoMode.HGR)):
        raise AssertionError("a second ingest call counted %s" % copies)
    if copies["other"] is None:
        print("ingest: a second call of each mode counted one launch and "
              "made no synchronising copy; the profiler recorded no device "
              "activity in %s, so its kernels and copies were not measured"
              % copies)
    elif copies["other"] or any(copies[m.name]["kernels"] != 1
                                for m in (VideoMode.DHGR, VideoMode.HGR)):
        raise AssertionError("a second ingest call ran %s" % copies)
    rows = {}
    for mode in (VideoMode.DHGR, VideoMode.HGR):
        rgb = ingest_frames(dev, "synth", B, F, h, w, 5)
        lanes, bytes_ = ingest.ingest_batch(rgb, mode, Palette.NTSC)
        ms = cuda_ms(lambda: ingest.ingest_batch(rgb, mode, Palette.NTSC),
                     20)
        plain_ms = cuda_ms(lambda: mesh.ingest_batch_plain(
            rgb, mode, Palette.NTSC), 3)
        c = ingest.constants(mode, Palette.NTSC, h, w)
        fmas = B * F * (int((c["h_w"] != 0).sum()) * 3 * w
                        + int((c["w_w"] != 0).sum()) * 3 * 192)
        nbytes = rgb.numel() + 4 * (lanes.numel() + bytes_.numel())
        rows[mode.name] = dict(ms=ms, plain_ms=plain_ms,
                               **bound(nbytes, fp64_ops=2 * fmas))
        print("ingest %s B=%d F=%d %dx%d (a 10 s round): ms=%.4f plain_ms="
              "%.3f bound_ms=%.4f (%s: %.1f MB, %.2f G float64 FMAs) "
              "share=%.1f%% ms_per_movie_s=%.5f; second call %s, other "
              "device activities %s" % (
                  mode.name, B, F, h, w, ms, plain_ms,
                  rows[mode.name]["bound_ms"], rows[mode.name]["bound_by"],
                  nbytes / 1e6, fmas / 1e9,
                  100 * rows[mode.name]["bound_ms"] / ms,
                  ms / (B * 10.0), copies[mode.name], copies["other"]))
    report["ingest_batch"] = dict(
        max_abs_err=worst_err, **rows["DHGR"],
        beside=dict(max_bad_share=worst, hgr=rows["HGR"]))


def check_golden(dev):
    """The JAX package's pinned stream (tests/test_stream.py), encoded on
    the card through the body kernel, its chunk starts in its prologue."""
    import numpy as np

    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
    from iivision_tpu_torch.video_mode import VideoMode

    mode = VideoMode.DHGR
    dist = distance.ComputedDistance(mode, Palette.NTSC, device=dev)
    rng = np.random.RandomState(123)
    fmain = rng.randint(0, 0x80, size=(2, 32, 256)).astype(np.uint8)
    faux = rng.randint(0, 0x80, size=(2, 32, 256)).astype(np.uint8)
    plan, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=1200, input_frame_rate=12.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8)
    lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, mode, dev)
    ops, _, _ = encoder.encode_movie(dist, lanes, bytes_tgt, plan, mode,
                                     seed=None)
    flat = encoder.flatten_ops(ops.cpu().numpy(), plan)
    levels = ((np.arange(plan.n_ops) % 32) - 15).astype(np.int32)
    data = emit_stream_fast(flat, levels, mode)
    sha = hashlib.sha256(data).hexdigest()
    print("golden stream: len=%d sha256=%s" % (len(data), sha))
    if len(data) != 10240 or sha != GOLDEN_SHA:
        raise AssertionError("golden stream differs from the JAX package's")


def gradient_clip(frames: int = 300, h: int = 192, w: int = 140):
    """A moving RGB gradient, (frames, h, w, 3) uint8."""
    import numpy as np

    t = np.linspace(0, 1, frames)[:, None, None]
    yy = np.linspace(0, 1, h)[None, :, None]
    xx = np.linspace(0, 1, w)[None, None, :]
    shape = (frames, h, w)
    r = np.broadcast_to(255 * (0.5 + 0.5 * np.sin(6 * (xx + t))), shape)
    g = np.broadcast_to(255 * yy, shape)
    b = np.broadcast_to(255 * (1 - xx), shape)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def write_tone(path, seconds: int):
    """A 440 Hz tone at 44.1 kHz, int16, as a WAV file."""
    import numpy as np

    from scipy.io import wavfile

    n = 44100 * seconds
    tone = np.sin(2 * np.pi * 440 * np.arange(n) / 44100) * 12000
    wavfile.write(path, 44100, tone.astype(np.int16))


def run_movie(dev, dists, mode, k: int, j: int, seconds: int,
              colour_model: str = "window"):
    """A clip of `seconds` at 30 fps with a 44.1 kHz tone, every 2nd frame
    encoded, through Movie(...).transcode on the card (14,700 Hz output
    audio), then the player VM: its final screens must equal the encoder's
    model.  dists: {(mode, colour model): distance model}; the first clip
    of a pair builds its model and stores it there, later ones pass it to
    Movie(dist=...).  Returns the Movie."""
    import numpy as np
    import torch

    from iivision_tpu_torch.movie import Movie
    from iivision_tpu_torch.video_mode import VideoMode

    rgb = gradient_clip(30 * seconds)
    shared = dists.get((mode, colour_model))
    with tempfile.TemporaryDirectory() as tmp:
        # the clip's audio track: decoded, then resampled on the card
        wav = os.path.join(tmp, "clip.wav")
        write_tone(wav, seconds)
        m = Movie(wav, frames_source=rgb, frame_rate=30.0,
                  every_n_video_frames=2, k=k, j=j, seed=0, device=dev,
                  video_mode=mode, colour_model=colour_model, dist=shared,
                  dither_mode="mono" if colour_model == "mono"
                  else "ordered")
        if shared is not None and m.dist is not shared:
            raise AssertionError("Movie(dist=...) built another model")
        dists[(mode, colour_model)] = m.dist
        if m.audio._rate != 44100:
            raise AssertionError("audio track not decoded at 44.1 kHz")
        out = os.path.join(tmp, "clip.a2m")
        stats = m.transcode(out)
        with open(out, "rb") as f:
            data = f.read()
    torch.cuda.synchronize()
    finals = [("main", m.final_main)]
    if mode == VideoMode.DHGR:
        finals.append(("aux", m.final_aux))
    check_vm(data, m.plan.n_ops,
             np.asarray(m.audio.levels())[:m.plan.n_ops], finals,
             "%s %ds clip" % (mode.name, seconds))
    print("movie %s %ds %s k=%d j=%d dist=%s encoder=%s: n_ops=%d bytes=%d "
          "frames_s=%.3f audio_s=%.3f tables_s=%.3f encode_s=%.3f "
          "emit_s=%.3f total_s=%.3f realtime_x=%.3f" % (
              mode.name, seconds, colour_model, k, j,
              "built" if shared is None else "shared", m.encoder_used,
              stats["n_ops"], len(data), stats["frames_s"],
              stats["audio_s"], stats["tables_s"], stats["encode_s"],
              stats["emit_s"], stats["total_s"], stats["realtime_x"]))
    if m.encoder_used != "whole":
        raise AssertionError("a %d s clip took the %s encoder"
                             % (seconds, m.encoder_used))
    roofline_line("movie %s %ds" % (mode.name, seconds), dev, m.plan, mode,
                  1, stats["encode_s"], enc_launches(), model=colour_model)
    return m


def roofline_line(what, dev, plan, mode, batch: int, seconds: float,
                  launched, model: str = "window", joint: bool = False,
                  shards: int = 1, seeded: bool = True):
    """Print `roofline.report`'s line for one encode of `seconds` (seeded:
    its nonce draws counted) and fail unless its modelled chunk starts and
    bodies equal the counted launches, `launched` = (chunk starts, bodies)
    of every instantiation."""
    from iivision_tpu_torch import roofline

    rec = roofline.report(plan, mode, batch, seconds, dev, model, joint,
                          shards, seeded)
    print("%s (%s; counted %d chunk starts / %d bodies)"
          % (rec["line"], what, *launched))
    if tuple(launched) != (rec["chunk_starts"], rec["bodies"]):
        raise AssertionError("%s: %d chunk starts and %d bodies launched, "
                             "the roofline models %d and %d" % (
                                 what, *launched, rec["chunk_starts"],
                                 rec["bodies"]))
    return rec


def rows_vs_plain(table, mode, sub, seed: int) -> int:
    """Largest difference between 32 sampled target rows per lane of a
    store-cost table built on the card and the plain build of the same
    rows on the CPU (`store_cost_rows` on the cost basis `sub`)."""
    import numpy as np
    import torch

    from iivision_tpu_torch.ops import distance

    sub = torch.as_tensor(sub.astype(np.int32))
    rng = np.random.RandomState(seed)
    worst = 0
    for lane in range(table.shape[0]):
        t = torch.as_tensor(rng.randint(0, table.shape[1], 32))
        want = distance.store_cost_rows(mode, lane, t, sub)
        got = table[lane, t.to(table.device)].cpu().to(torch.int32)
        worst = max(worst, int((got - want).abs().max()))
    return worst


def run_mono(dev, dists, mode):
    """A 2 s mono clip (k=8, j=1).  No mono table is shipped, so its Movie
    builds one on the card (kernel A's lane distance, HGR) into the
    empty temporary cache; 64 sampled rows of the table the clip encoded
    with are then held against the plain build on the CPU."""
    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.palettes import Palette

    path = distance.store_cost_path(mode, Palette.NTSC, "mono",
                                    distance._user_cache_dir())
    if os.path.exists(path):
        raise AssertionError("mono table cached before the clip: %s" % path)
    m = run_movie(dev, dists, mode, 8, 1, 2, colour_model="mono")
    if not os.path.exists(path):
        raise AssertionError("the mono clip saved no store-cost table")
    table = m.dist.store_cost16
    worst = rows_vs_plain(table, mode, distance.sub16_mono(), 6)
    print("store cost %s NTSC mono: shape=%s built in tables_s=%.3f "
          "max=%d, 64 rows of the clip's table vs plain max_abs_err=%d" % (
              mode.name, tuple(table.shape), m.timings["tables_s"],
              int(table.max()), worst))
    if worst:
        raise AssertionError("mono store-cost rows disagree with plain")


def run_bench(dev, bench_subop, report):
    """The microbenchmark entry point: T in {100, 400, 1000}, best of 3,
    variants plain, kernel and plain_i16, with a slope fit each."""
    def emit(rec):
        if rec.get("fit"):
            print("bench_subop fit %s: us_per_subop_marginal=%.3f "
                  "intercept_ms=%.4f" % (rec["variant"],
                                         rec["us_per_subop_marginal"],
                                         rec["intercept_ms"]))
        else:
            print("bench_subop %s T=%d: best_s=%.6f digest=%.6f" % (
                rec["variant"], rec["T"], rec["best_s"], rec["digest"]))

    recs = bench_subop.run(dev, emit=emit)
    fits = {r["variant"]: r for r in recs if r.get("fit")}
    report["subop_bench"].update(
        us_per_subop=fits["kernel"]["us_per_subop_marginal"],
        plain_us_per_subop=fits["plain"]["us_per_subop_marginal"],
        intercept_ms=fits["kernel"]["intercept_ms"],
        plain_intercept_ms=fits["plain"]["intercept_ms"])


def synth_clips(B: int, seconds: float, every_n: int = 1):
    """B distinct synth_clip movies (280x192, 30 fps, phase 0.2*i), every
    `every_n`-th frame kept: (B, F, 192, 280, 3) uint8, made on 8 host
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    def one(i):
        return synth_clip(seconds=seconds, phase=0.2 * i)[::every_n]

    with ThreadPoolExecutor(8) as pool:
        return np.stack(list(pool.map(one, range(B))))


def tone_levels(dev, seconds: float):
    """The quality gates' audio: a 440 Hz sine at 14,700 Hz (no resample;
    `compute_row`'s and tests/test_quality_regression.py's float32 tone),
    as the port's Audio."""
    from iivision_tpu_torch import audio, bench

    return audio.Audio(data=bench.tone(seconds), rate=14700, bitrate=14700,
                       device=dev)


def check_vm(data, n_ops, levels, finals, what):
    """The player VM decodes a stream: n_ops ops, duty cycles from the
    audio levels, final screens equal to the encoder's model (except the
    padding op's cell).  finals: [(name, (32, 256) model bank)]."""
    import numpy as np

    from iivision_tpu_torch.sim import PlayerVM

    res = PlayerVM().decode(data)
    if not res.ok:
        raise AssertionError("%s: player VM rejects the stream: %s at %d"
                             % (what, res.error, res.error_pos))
    if res.n_ops != n_ops:
        raise AssertionError("%s: VM decoded %d ops, want %d"
                             % (what, res.n_ops, n_ops))
    if levels is not None and not np.array_equal(res.duty,
                                                 levels * 2 + 34):
        raise AssertionError("%s: duty cycles differ from audio levels"
                             % what)
    for name, model in finals:
        eq = getattr(res, name) == np.asarray(model).astype(np.uint8)
        eq[0, 0] = True  # the padding op's cell
        if not eq.all():
            raise AssertionError("%s: VM %s screen differs from the model "
                                 "at %s" % (what, name, np.argwhere(~eq)[:5]))


def run_batch_mesh(dev, base):
    """The bench's B=32 batch (`base` = its batch_dhgr_b32_10s_k16_j4
    record and last rep's output) again on the mesh (cuda:0, cuda:0): the
    same movies made anew on the card from the same seed, two shards of 16
    movies, each ingested, encoded (the same seeds in batch order) and
    fetched in a host thread of its own under a CUDA stream of its own,
    then emitted.  Every stream and final screen must equal the unsharded
    batch's; the wall time and `realtime_x` print beside its medians, and
    each shard launches its own chunk starts and bodies."""
    import torch

    from iivision_tpu_torch import bench
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.parallel import mesh

    rec, out = base
    bs, seed = out["setup"], out["seed"]
    B, plan, mode = bs.B, bs.plan, bench.DHGR
    two = mesh.as_mesh((dev, dev))
    src = bench.synth_movies_device(B, bs.F, seed, dev)
    torch.cuda.synchronize()
    t0 = time.time()
    lanes_s, bytes_s = mesh.ingest_movies_batch(src, mode, Palette.NTSC,
                                                mesh=two)
    torch.cuda.synchronize()
    t1 = time.time()
    before = enc_launches()
    ops_s, main_s, aux_s = mesh.encode_movies_batch(
        bs.dist, lanes_s, bytes_s, plan, mode,
        seeds=list(range(seed, seed + B)), mesh=two)
    torch.cuda.synchronize()
    t2 = time.time()
    launched = tuple(a - b for a, b in zip(enc_launches(), before))
    flat = mesh.fetch_ops_parallel(ops_s, plan)
    streams = bs.emit(flat, out["levels"])
    t3 = time.time()
    wall = t3 - t0
    realtime_x = bs.movie_seconds / wall
    if [len(x) for x in ops_s] != [B // 2, B // 2]:
        raise AssertionError("mesh shards of %s movies"
                             % [len(x) for x in ops_s])
    bad = [i for i in range(B) if streams[i] != out["streams"][i]]
    if bad:
        raise AssertionError("mesh batch movies %s differ from the unsharded "
                             "batch" % bad[:8])
    if not (torch.equal(torch.cat(main_s), out["main"])
            and torch.equal(torch.cat(aux_s), out["aux"])):
        raise AssertionError("mesh batch final screens differ from the "
                             "unsharded batch")
    med = {k: v["median"] for k, v in rec["timings"].items()}
    print("batch DHGR B=%d mesh=2 (cuda:0 twice) k=16 j=4: ingest_s=%.3f "
          "encode_s=%.3f fetch_emit_s=%.3f total_s=%.3f realtime_x=%.3f; "
          "unsharded (the bench's, synth apart) ingest_s=%.3f encode_s=%.3f "
          "fetch_emit_s=%.3f total_s=%.3f realtime_x=%.3f; %d streams and "
          "finals byte-equal to the unsharded batch" % (
              B, t1 - t0, t2 - t1, t3 - t2, wall, realtime_x,
              med["ingest_s"], med["encode_s"], med["fetch_emit_s"],
              med["total_s"] - med["synth_s"],
              bs.movie_seconds / (med["total_s"] - med["synth_s"]), B))
    roofline_line("mesh batch B=%d over 2 shards" % B, dev, plan, mode, B,
                  t2 - t1, launched, shards=2)


def run_cli_mixed(dev):
    """The CLI's batch mode (k=16 j=4, `--mesh auto`: every card, here
    one, so the group runs unsharded) on three .npz clips of 10, 6 and 3 s
    with no audio track: each stream plays in the VM at its own op count,
    and the 3 s one (seed 2) equals its solo encode padded to the batch's
    plan."""
    import numpy as np

    from iivision_tpu_torch import cli, encoder, frames
    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
    from iivision_tpu_torch.video_mode import VideoMode

    mode = VideoMode.DHGR
    lengths = (10.0, 6.0, 3.0)
    with tempfile.TemporaryDirectory() as tmp:
        clips = []
        for i, sec in enumerate(lengths):
            path = os.path.join(tmp, "clip%d.npz" % i)
            np.savez(path, frames=synth_clip(seconds=sec, phase=i),
                     frame_rate=30.0)
            clips.append(path)
        out_dir = os.path.join(tmp, "out")
        stats = os.path.join(tmp, "stats.json")
        t0 = time.time()
        cli.main(clips + ["--device", str(dev), "--output", out_dir,
                          "--k", "16", "--j", "4", "--stats_json", stats,
                          "--mesh", "auto"])
        wall = time.time() - t0
        with open(stats) as f:
            rows = json.load(f)
        datas = []
        for row in rows:
            with open(row["output"], "rb") as f:
                datas.append(f.read())
            check_vm(datas[-1], row["n_ops"], None, [], row["output"])
        fr = [frames.ingest(c, mode, Palette.NTSC, every_n_video_frames=2)
              for c in clips]
    ticks = [int(f.n_frames_total / f.input_frame_rate * 14700) + 1
             for f in fr]
    plan_max, n_enc = encoder.plan_movie(
        n_frames=max(f.n_frames_total for f in fr),
        n_audio_ticks=max(ticks), input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=2, mode=mode,
        k=16, j=4)

    def pad(t):
        reps = max(0, n_enc - len(t))
        return np.concatenate([t, np.repeat(t[-1:], reps, 0)])[:n_enc]

    dist = distance.ComputedDistance(mode, Palette.NTSC, device=dev)
    lanes, bytes_ = encoder.prepare_targets(
        pad(fr[2].targets_main), pad(fr[2].targets_aux), mode, dev)
    ops, _, _ = encoder.encode_movie(dist, lanes, bytes_, plan_max, mode,
                                     seed=2)
    solo = encoder.flatten_ops(ops.cpu().numpy(), plan_max)[:rows[2]["n_ops"]]
    if emit_stream_fast(solo, np.zeros(len(solo), np.int32), mode) \
            != datas[2]:
        raise AssertionError("the 3 s clip differs from its padded solo "
                             "encode")
    print("cli batch 10/6/3 s k=16 j=4: n_ops=%s batch_encode_s=%.3f "
          "cli_wall_s=%.3f; streams VM-valid, the 3 s one equals its "
          "padded solo encode" % ([r["n_ops"] for r in rows],
                                  rows[0]["batch_encode_s"], wall))


def run_quality(dev, dists, k: int, j: int):
    """tests/test_quality_regression.py on the card: the pinned 5 s clip
    through the port's Movie at (k, j) (seed 0), default and joint
    content, replayed and scored by the port's quality module.  Each mean
    error is held to its committed baseline row (<= 1.01x; final error
    <= 1.02x + 0.05), and joint must beat the default rule's baseline at
    the same (k, j)."""
    from iivision_tpu_torch import encoder, quality, render
    from iivision_tpu_torch.movie import Movie
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    rows = baseline_rows("quality_baseline.json")
    rgb = synth_clip(seconds=5.0)
    means = {}
    default = "dhgr_ntsc_k%d_j%d_seed0" % (k, j)
    for joint in (False, True):
        m = Movie(frames_source=rgb, audio_source=tone_levels(dev, 5.0),
                  every_n_video_frames=2, k=k, j=j, seed=0, device=dev,
                  video_mode=VideoMode.DHGR, joint_content=joint,
                  dist=dists[(VideoMode.DHGR, "window")])
        flat, _ = m.encode_ops()
        lanes, _ = encoder.prepare_targets(
            m.frames.targets_main, m.frames.targets_aux, VideoMode.DHGR,
            dev)
        rep = quality.replay_frame_errors(flat, m.plan, lanes,
                                          VideoMode.DHGR, m.dist)
        name = default + ("_joint" if joint else "")
        row = rows[name]
        last = int(m.plan.step_frame.max())
        psnr = quality.stream_psnr(
            m.final_main, m.final_aux,
            render.screen_to_rgb(m.frames.targets_main[last],
                                 m.frames.targets_aux[last], VideoMode.DHGR,
                                 Palette.NTSC),
            VideoMode.DHGR, Palette.NTSC)
        print("quality %s: mean_error=%.6f (baseline %.4f) final_error=%.6f "
              "(baseline %.4f) stream_psnr_db=%.2f tables_s=%.3f "
              "encode_s=%.3f" % (
                  name, rep.mean_error, row["mean_error"], rep.final_error,
                  row["final_error"], psnr, m.timings["tables_s"],
                  m.timings["encode_s"]))
        if not psnr > 10.0:
            raise AssertionError("%s: final screen far from its target "
                                 "(%.2f dB)" % (name, psnr))
        if rep.mean_error > row["mean_error"] * 1.01:
            raise AssertionError("%s mean error regressed" % name)
        if rep.final_error > row["final_error"] * 1.02 + 0.05:
            raise AssertionError("%s final error regressed" % name)
        means[joint] = rep.mean_error
    if not means[True] < rows[default]["mean_error"]:
        raise AssertionError("joint content no longer beats the default "
                             "rule at k=%d j=%d" % (k, j))


def baseline_rows(name):
    """The rows of tests/data/`name`, a committed quality baseline."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", name)) as f:
        return json.load(f)["rows"]


# The quality matrix of tests/quality_matrix_common.py (which imports the
# JAX package, so the smoke keeps its own copy; tests/
# test_torch_palette_matrix.py holds the two equal): two pinned 2 s clips
# over DHGR and HGR x NTSC and IIGS in the window model, plus yiq for DHGR
# NTSC and HGR IIGS, each encoded at MATRIX_SETTING with the tone of its
# `compute_row` and held to tests/data/quality_matrix_baseline.json.
MATRIX_SECONDS = 2.0
MATRIX_SETTING = dict(every_n_video_frames=2, k=16, j=4, seed=0)
MATRIX_ROWS = tuple(  # (row key, clip, mode, palette, colour model)
    row for clip in ("sweep", "blocks") for row in (
        *(("%s_%s_%s_window" % (clip, mode.lower(), pal.lower()), clip,
           mode, pal, "window")
          for mode in ("DHGR", "HGR") for pal in ("NTSC", "IIGS")),
        ("%s_dhgr_ntsc_yiq" % clip, clip, "DHGR", "NTSC", "yiq"),
        ("%s_hgr_iigs_yiq" % clip, clip, "HGR", "IIGS", "yiq")))


def clip_blocks():
    """The matrix's clip B (quality_matrix_common.clip_blocks): hard-edged
    moving blocks over static detail, (60, 192, 280, 3) uint8."""
    import numpy as np

    F = int(MATRIX_SECONDS * 30)
    h, w = 192, 280
    rng = np.random.RandomState(7)
    base = rng.randint(0, 8, size=(12, 18), dtype=np.int32)
    palette = np.array(
        [[0, 0, 0], [220, 30, 30], [30, 200, 40], [40, 60, 220],
         [230, 220, 40], [200, 40, 200], [40, 210, 210], [255, 255, 255]],
        np.uint8)
    frames = np.zeros((F, h, w, 3), np.uint8)
    bg = np.kron(palette[base], np.ones((16, 16, 1), np.uint8))[:h, :w]
    for t in range(F):
        f = bg.copy()
        x = (t * 9) % (w - 60)
        y = (t * 5) % (h - 40)
        f[y:y + 40, x:x + 60] = [255, 160, 0]
        x2 = w - 80 - (t * 7) % (w - 80)
        f[20:50, x2:x2 + 50] = [0, 0, 0] if t % 2 else [255, 255, 255]
        frames[t] = f
    return frames


def matrix_clips():
    """{clip name: RGB frames} of the matrix: clip A is the bench's sweep."""
    return {"sweep": synth_clip(seconds=MATRIX_SECONDS),
            "blocks": clip_blocks()}


def run_quality_matrix(dev):
    """tests/test_quality_matrix.py on the card: each of MATRIX_ROWS'
    twelve rows through the port's Movie at MATRIX_SETTING with the 2 s
    tone, replayed and scored by `quality.replay_frame_errors`, held to
    its committed row with the JAX test's gate (mean <= 1.01x + 1e-6,
    final <= 1.02x + 0.05).  One distance model per (mode, palette,
    colour model), shared by the two clips.  No HGR IIGS yiq table is
    shipped: the first such row builds it on the card into the empty
    temporary cache, and 64 sampled rows of it are held against the plain
    build on the CPU."""
    from iivision_tpu_torch import encoder, quality
    from iivision_tpu_torch.movie import Movie
    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    rows = baseline_rows("quality_matrix_baseline.json")
    clips = matrix_clips()
    built = distance.store_cost_path(VideoMode.HGR, Palette.IIGS, "yiq",
                                     distance._user_cache_dir())
    if os.path.exists(built):
        raise AssertionError("HGR IIGS yiq table cached before the matrix: "
                             "%s" % built)
    dists, tables_s = {}, {}
    for key, clip, mode_name, pal_name, model in MATRIX_ROWS:
        mode, pal = VideoMode[mode_name], Palette[pal_name]
        shared = dists.get((mode, pal, model))
        m = Movie(frames_source=clips[clip],
                  audio_source=tone_levels(dev, MATRIX_SECONDS), device=dev,
                  video_mode=mode, palette=pal, colour_model=model,
                  dist=shared, **MATRIX_SETTING)
        dists[(mode, pal, model)] = m.dist
        tables_s.setdefault((mode, pal, model), m.timings["tables_s"])
        flat, _ = m.encode_ops()
        lanes, _ = encoder.prepare_targets(
            m.frames.targets_main, m.frames.targets_aux, mode, dev)
        rep = quality.replay_frame_errors(flat, m.plan, lanes, mode, m.dist)
        row = rows[key]
        print("quality_matrix %s: mean_error=%.6f (baseline %.4f) "
              "final_error=%.6f (baseline %.4f) n_ops=%d tables_s=%.3f "
              "encode_s=%.3f encoder=%s" % (
                  key, rep.mean_error, row["mean_error"], rep.final_error,
                  row["final_error"], m.plan.n_ops, m.timings["tables_s"],
                  m.timings["encode_s"], m.encoder_used))
        if not rep.mean_error <= row["mean_error"] * 1.01 + 1e-6:
            raise AssertionError("%s mean error regressed" % key)
        if not rep.final_error <= row["final_error"] * 1.02 + 0.05:
            raise AssertionError("%s final error regressed" % key)
    if not os.path.exists(built):
        raise AssertionError("the HGR IIGS yiq rows saved no table")
    table = dists[(VideoMode.HGR, Palette.IIGS, "yiq")].store_cost16
    worst = rows_vs_plain(table, VideoMode.HGR, distance.sub_for(
        VideoMode.HGR, Palette.IIGS, "yiq"), 11)
    print("store cost HGR IIGS yiq: shape=%s built on the card in "
          "tables_s=%.3f, max=%d, 64 rows vs the plain build on the CPU "
          "max_abs_err=%d" % (
              tuple(table.shape),
              tables_s[(VideoMode.HGR, Palette.IIGS, "yiq")],
              int(table.max()), worst))
    if worst:
        raise AssertionError("HGR IIGS yiq store-cost rows disagree with "
                             "plain")


def enc_launches():
    """(chunk starts, bodies) counted so far, every instantiation of
    each: a chunk start is a body launch that recomputes."""
    return (launch_count("chunk_start") + launch_count("chunk_start_yiq"),
            launch_count("encode_body") + launch_count("encode_body_joint"))


def timed_transcode(dev, dist, rgb, wav, mode, k: int, j: int, tmp, *,
                    stream_min: int, stream_chunk_frames: int = 64):
    """One Movie(...).transcode of an in-memory clip with
    `movie.STREAM_MIN_FRAMES` set to `stream_min` for the call: above the
    clip's encoded frames it runs the whole-movie encode, below them the
    streaming one.  Returns (movie, stream bytes, stats, (device memory
    high-water mark of the call, device memory held when it started) in
    bytes, (chunk-start, body) launches)."""
    import torch

    from iivision_tpu_torch import movie as movie_mod

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = enc_launches()
    kept = movie_mod.STREAM_MIN_FRAMES
    movie_mod.STREAM_MIN_FRAMES = stream_min
    try:
        m = movie_mod.Movie(
            wav, frames_source=rgb, frame_rate=30.0, every_n_video_frames=2,
            k=k, j=j, seed=0, device=dev, video_mode=mode,
            dist=dist, stream_chunk_frames=stream_chunk_frames)
        out = os.path.join(tmp, "clip.a2m")
        stats = m.transcode(out)
    finally:
        movie_mod.STREAM_MIN_FRAMES = kept
    torch.cuda.synchronize()
    with open(out, "rb") as f:
        data = f.read()
    launched = tuple(a - b for a, b in zip(enc_launches(), before))
    if launched[1] != stats["body_launches"]:
        raise AssertionError(
            "the counters saw %d body launches, the encode's timings %d"
            % (launched[1], stats["body_launches"]))
    return (m, data, stats, (torch.cuda.max_memory_allocated(), held),
            launched)


def print_transcode(what, m, stats, peak, launched):
    print("%s encoder=%s: frames_s=%.3f tables_s=%.3f encode_s=%.3f "
          "total_s=%.3f realtime_x=%.3f peak_device_MB=%.1f (%.1f over "
          "what the process held before the call) chunk_starts=%d "
          "bodies=%d" % (
              what, m.encoder_used, stats["frames_s"], stats["tables_s"],
              stats["encode_s"], stats["total_s"], stats["realtime_x"],
              peak[0] / 1e6, (peak[0] - peak[1]) / 1e6, launched[0],
              launched[1]))


def run_long_stream(dev, dists, seconds: int = 60):
    """A 60 s 280x192 clip (900 encoded frames, a 44.1 kHz tone) at k=8
    j=1 through Movie, left to its own choice: it must take the streaming
    encoder, launch the body kernel with and without the recompute, play
    on the player VM to the encoder's final screens, and equal the
    whole-movie encode of the same clip with the same distance model.  Run whole, streaming,
    streaming, whole; every run prints its line."""
    import numpy as np

    from iivision_tpu_torch import movie as movie_mod
    from iivision_tpu_torch.video_mode import VideoMode

    mode = VideoMode.DHGR
    t0 = time.time()
    rgb = synth_clip(seconds=float(seconds))
    synth_s = time.time() - t0
    ref = None
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        write_tone(wav, seconds)
        for stream_min in (1 << 30, movie_mod.STREAM_MIN_FRAMES,
                           movie_mod.STREAM_MIN_FRAMES, 1 << 30):
            m, data, stats, peak, launched = timed_transcode(
                dev, dists[(mode, "window")], rgb, wav, mode, 8, 1, tmp,
                stream_min=stream_min)
            want = "whole" if stream_min == 1 << 30 else "streaming"
            if m.encoder_used != want:
                raise AssertionError("the %d s clip took the %s encoder, "
                                     "want %s" % (seconds, m.encoder_used,
                                                  want))
            if min(launched) == 0:
                raise AssertionError("the %s run launched %s chunk starts "
                                     "and bodies" % (want, launched))
            print_transcode("movie DHGR %ds k=8 j=1 n_enc=%d"
                            % (seconds, len(rgb[::2])), m, stats, peak,
                            launched)
            if ref is None:
                ref = data
            elif data != ref:
                raise AssertionError("the streaming encode of the %d s clip "
                                     "differs from its whole-movie encode"
                                     % seconds)
            if want == "streaming":
                check_vm(data, m.plan.n_ops,
                         np.asarray(m.audio.levels())[:m.plan.n_ops],
                         [("main", m.final_main), ("aux", m.final_aux)],
                         "streamed %d s clip" % seconds)
    print("long stream: synth_s=%.1f; streaming == whole-movie, %d bytes, "
          "VM-valid" % (synth_s, len(ref)))
    stream_split(dev, dists[(mode, "window")], rgb, m.plan, mode)


class TimedBatches:
    """An iterator over `gen` that adds up the time its consumer spends
    waiting in next()."""

    def __init__(self, gen):
        self.gen, self.blocked_s = gen, 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.time()
        try:
            return next(self.gen)
        finally:
            self.blocked_s += time.time() - t0


def stream_split(dev, dist, rgb, plan, mode):
    """What the streaming encode of a clip is made of, one run each:
    ingest alone (the 4-thread generator, drained), the whole-movie
    encode and the streaming encode on targets that are ready, and the
    streaming encode on the live generator with the time its loop waits
    for a batch."""
    import numpy as np
    import torch

    from iivision_tpu_torch import encoder, frames
    from iivision_tpu_torch.palettes import Palette

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    def ingest():
        return list(frames.ingest_stream_array(rgb, mode, Palette.NTSC, 2))

    def whole():
        n = int(plan.step_frame.max()) + 1
        lanes, bytes_tgt = encoder.prepare_targets(
            np.concatenate([m for m, _ in parts])[:n],
            np.concatenate([a for _, a in parts])[:n], mode, dev)
        return encoder.encode_movie(dist, lanes, bytes_tgt, plan, mode,
                                    seed=0)[0].cpu().numpy()

    def stream(batches):
        return encoder.encode_movie_streaming(dist, batches, plan, mode,
                                              seed=0, chunk_frames=64)[0]

    parts, ingest_s = wall(ingest)
    ops, whole_s = wall(whole)
    ops_r, ready_s = wall(lambda: stream(iter(parts)))
    live = TimedBatches(frames.ingest_stream_array(rgb, mode, Palette.NTSC,
                                                   2))
    ops_l, live_s = wall(lambda: stream(live))
    if not (np.array_equal(ops, ops_r) and np.array_equal(ops, ops_l)):
        raise AssertionError("stream split: records differ")
    print("stream split %s k=%d j=%d, %d frames: ingest_alone_s=%.3f "
          "whole_on_ready_targets_s=%.3f streaming_on_ready_batches_s=%.3f "
          "streaming_on_live_ingest_s=%.3f of which waiting_for_a_batch_s="
          "%.3f" % (mode.name, plan.k, plan.j, len(rgb[::2]), ingest_s,
                    whole_s, ready_s, live_s, live.blocked_s))


def run_forced_stream(dev, dists):
    """Where streaming pays on this card: the 10 s k=16 j=4 clip of
    `run_movie` (150 encoded frames, under STREAM_MIN_FRAMES) as the
    whole-movie run and forced through the streaming encoder at segments
    of 16 and 64 frames, twice round; all byte-equal."""
    from iivision_tpu_torch.video_mode import VideoMode

    rgb = gradient_clip(300)
    ref = None
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        write_tone(wav, 10)
        for stream_min, chunk in ((1 << 30, 64), (0, 16), (0, 64), (0, 64),
                                  (0, 16), (1 << 30, 64)):
            m, data, stats, peak, launched = timed_transcode(
                dev, dists[(VideoMode.DHGR, "window")], rgb, wav,
                VideoMode.DHGR, 16, 4, tmp, stream_min=stream_min,
                stream_chunk_frames=chunk)
            want = "streaming" if stream_min == 0 else "whole"
            if m.encoder_used != want:
                raise AssertionError("forced run took the %s encoder"
                                     % m.encoder_used)
            print_transcode("movie DHGR 10s k=16 j=4 segment=%s" % (
                chunk if stream_min == 0 else "none"), m, stats, peak,
                launched)
            if ref is None:
                ref = data
            elif data != ref:
                raise AssertionError("forced streaming (segments of %d) "
                                     "differs from the whole-movie encode"
                                     % chunk)


def run_cli_chunked(dev):
    """`cli.main` on one 10 s .npz clip at k=16 j=4 with `--chunk_frames
    32`, byte-equal to the same call without the flag, and VM-valid."""
    import numpy as np

    from iivision_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.npz")
        np.savez(clip, frames=synth_clip(seconds=10.0), frame_rate=30.0)
        datas, rows = [], []
        for extra in ([], ["--chunk_frames", "32"]):
            for name in os.listdir(tmp):
                if ".iiv_" in name:  # the first call's target cache
                    os.unlink(os.path.join(tmp, name))
            out = os.path.join(tmp, "out%d.a2m" % len(datas))
            stats = os.path.join(tmp, "stats%d.json" % len(datas))
            before = enc_launches()
            cli.main([clip, "--device", str(dev), "--output", out, "--k",
                      "16", "--j", "4", "--stats_json", stats] + extra)
            if min(a - b for a, b in zip(enc_launches(), before)) == 0:
                raise AssertionError("cli %s launched no kernel" % extra)
            with open(out, "rb") as f:
                datas.append(f.read())
            with open(stats) as f:
                rows.append(json.load(f)[0])
    check_vm(datas[1], rows[1]["n_ops"], None, [], "cli --chunk_frames 32")
    if datas[0] != datas[1]:
        raise AssertionError("cli --chunk_frames 32 differs from the "
                             "unchunked call")
    print("cli 10 s k=16 j=4: whole encode_s=%.3f total_s=%.3f; "
          "--chunk_frames 32 encode_s=%.3f total_s=%.3f; %d bytes equal, "
          "VM-valid" % (rows[0]["encode_s"], rows[0]["total_s"],
                        rows[1]["encode_s"], rows[1]["total_s"],
                        len(datas[0])))


def run_stream_direct(dev, dists, mode, k: int, j: int, joint: bool):
    """`encoder.encode_movie_streaming` called directly with segments of
    16 frames and ragged batch sizes, against `encoder.encode_movie` on
    the same targets: records, final screens and handed-back targets.
    HGR: a 20 s gradient clip; joint: the 5 s quality clip (DHGR)."""
    import numpy as np
    import torch

    from iivision_tpu_torch import encoder, frames
    from iivision_tpu_torch.palettes import Palette

    seconds = 5.0 if joint else 20.0
    rgb = synth_clip(seconds=seconds) if joint \
        else gradient_clip(int(30 * seconds))
    fr = frames.ingest(rgb, mode, Palette.NTSC, every_n_video_frames=2,
                       frame_rate=30.0)
    plan, n_enc = encoder.plan_movie(
        n_frames=len(rgb), n_audio_ticks=int(seconds * 14700),
        input_frame_rate=30.0, ticks_per_second=14700.0,
        every_n_video_frames=2, mode=mode, k=k, j=j)
    dist = dists[(mode, "window")]

    def batches():
        pos, i, sizes = 0, 0, (7, 1, 33, 16, 5)
        while pos < len(fr.targets_main):
            b = sizes[i % len(sizes)]
            yield (fr.targets_main[pos:pos + b],
                   None if fr.targets_aux is None
                   else fr.targets_aux[pos:pos + b])
            pos, i = pos + b, i + 1

    torch.cuda.synchronize()
    t0 = time.time()
    ops_s, main_s, aux_s, tm, ta = encoder.encode_movie_streaming(
        dist, batches(), plan, mode, seed=3, chunk_frames=16, joint=joint)
    t1 = time.time()
    lanes, bytes_tgt = encoder.prepare_targets(
        fr.targets_main[:n_enc],
        None if fr.targets_aux is None else fr.targets_aux[:n_enc], mode,
        dev)
    ops, main, aux = encoder.encode_movie(dist, lanes, bytes_tgt, plan, mode,
                                          seed=3, joint=joint)
    ops, main, aux = (t.cpu().numpy() for t in (ops, main, aux))
    t2 = time.time()
    for name, got, want in (("ops", ops_s, ops), ("main", main_s, main),
                            ("aux", aux_s, aux),
                            ("targets", tm, fr.targets_main[:len(tm)])):
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError("streaming %s differ from the whole-movie "
                                 "encode (%s)" % (name, mode.name))
    if (ta is None) != (fr.targets_aux is None):
        raise AssertionError("streaming aux targets")
    print("stream direct %s %gs k=%d j=%d joint=%s segment=16: steps=%d "
          "n_enc=%d streaming_s=%.3f whole_s=%.3f; records and final "
          "screens equal" % (mode.name, seconds, k, j, joint,
                             len(plan.step_frame), n_enc, t1 - t0, t2 - t1))


def build_machine():
    """The delivery paths' one-off host costs, timed apart from the paths:
    the g++ build of `sim/csrc/apple2_vm.cpp` and the assembly of the
    vendored player (every label held against the shipped .dbg)."""
    from iivision_tpu_torch.sim import asm65, machine65

    t0 = time.time()
    lib = machine65._build_library()
    build_s = time.time() - t0
    t0 = time.time()
    asm = asm65.assemble_player()
    labels = asm65.validate_against_dbg(asm)
    print("build: %s g++ seconds=%.2f; player assembled in %.2f s, %d labels "
          "equal to iivision.dbg" % (os.path.relpath(lib), build_s,
                                     time.time() - t0, len(labels)))


def fetch(handler) -> bytes:
    """Serve one connection on 127.0.0.1, port 0, in a thread, and return
    what a real socket reads until the server closes it."""
    import socket
    import socketserver
    import threading

    srv = socketserver.TCPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        chunks = []
        with socket.create_connection(srv.server_address, timeout=30) as s:
            while True:
                buf = s.recv(1 << 16)
                if not buf:
                    break
                chunks.append(buf)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    return b"".join(chunks)


def split_slow_path_pairs(duty_pairs, n_ops: int):
    """The machine's speaker tick pairs without the slow path's: one pair
    for the first recv, then 291 data ops, then per 2 KB frame two ACK
    pairs and 292 data ops.  Returns the data ops' pairs."""
    import numpy as np

    from iivision_tpu_torch.stream import opcodes

    data, i, remaining = [], 1, n_ops
    per_frame = opcodes.OPS_FIRST_FRAME
    while remaining > 0:
        take = min(per_frame, remaining)
        data.append(duty_pairs[i:i + take])
        i += take + 2
        remaining -= take
        per_frame = opcodes.OPS_PER_FRAME
    return np.concatenate(data)


def expected_hardware_duty(duties):
    """Nominal duty -> the duty the player's code gives: of the 32 tick
    variants, op_tick_22 ticks 21 cycles apart and op_tick_40 39 (each
    still takes 73 cycles)."""
    import numpy as np

    d = np.asarray(duties).copy()
    d[d == 22] = 21
    d[d == 40] = 39
    return d


def tail_store_model(data: bytes, from_byte: int):
    """What the tick opcodes at or after `from_byte` store, bank by bank:
    (model, mask) of shape (2, 32, 256).  Where the tail stored, full
    playback's final memory holds the model (the last store wins)."""
    import numpy as np

    from iivision_tpu_torch.stream import retarget

    pos, cell = [], []
    bank = 0
    for p, kind, key in retarget.walk(data):
        if kind == "ack":
            bank = int(key)
        elif kind == "tick" and p >= from_byte:
            pos.append(p)
            cell.append((bank * 32 + key[1] - 32) * 256)
    raw = np.frombuffer(data, np.uint8)
    pos = np.asarray(pos, np.int64)
    idx = (np.asarray(cell, np.int64)[:, None]
           + raw[pos[:, None] + np.arange(3, 7)]).ravel()
    model = np.zeros(2 * 32 * 256, np.uint8)
    mask = np.zeros(2 * 32 * 256, bool)
    model[idx] = np.repeat(raw[pos + 2], 4)  # in order: the last store wins
    mask[idx] = True
    return model.reshape(2, 32, 256), mask.reshape(2, 32, 256)


def write_dbg(addrs, path):
    """A cc65-style .dbg with the opcode labels of an address map (what
    `server.build_retargeter` reads for a player build)."""
    names = [("op_header", addrs.header), ("op_ack", addrs.ack),
             ("op_terminate", addrs.terminate), ("op_nop", addrs.nop)]
    names += [("op_tick_%d_page_%d" % k, v)
              for k, v in sorted(addrs.tick.items())]
    with open(path, "w") as f:
        for i, (name, val) in enumerate(names):
            f.write('sym\tid=%d,name="%s",addrsize=absolute,scope=0,'
                    'def=1,val=0x%X,type=lab\n' % (i, name, val))


def cli_transcode(dev, tmp, mode, k: int, j: int, seconds: int,
                  extra=()):
    """One clip (280x192, 30 fps, every 2nd frame) transcoded on the card
    through `cli.main` into `tmp`, with the CLI flags `extra`.  An .npz
    clip carries no audio track, so the Movie the CLI makes is given a
    440 Hz tone's (decoded from a WAV and resampled on the card), and is
    kept for its final screens and audio levels.  Returns (that Movie,
    its --stats_json row, the .a2m path, its bytes, the CLI's wall
    seconds)."""
    import numpy as np
    import torch

    from iivision_tpu_torch import audio, cli
    from iivision_tpu_torch import movie as movie_mod

    clip = os.path.join(tmp, "clip.npz")
    np.savez(clip, frames=synth_clip(seconds=float(seconds)), frame_rate=30.0)
    wav = os.path.join(tmp, "clip.wav")
    write_tone(wav, seconds)
    made = []

    class RecordedMovie(movie_mod.Movie):
        def __init__(self, filename=None, **kw):
            kw["audio_source"] = audio.Audio(wav, bitrate=14700,
                                             device=kw["device"])
            super().__init__(filename, **kw)
            made.append(self)

    a2m = os.path.join(tmp, "clip.a2m")
    stats_path = os.path.join(tmp, "stats.json")
    original = movie_mod.Movie
    movie_mod.Movie = RecordedMovie
    t0 = time.time()
    try:
        cli.main([clip, "--device", str(dev), "--output", a2m,
                  "--video_mode", mode.name, "--k", str(k), "--j", str(j),
                  "--stats_json", stats_path, *extra])
    finally:
        movie_mod.Movie = original
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    m, = made
    if m.device.type != "cuda":
        raise AssertionError("the CLI's movie ran on %s" % m.device)
    with open(stats_path) as f:
        stats = json.load(f)[0]
    with open(a2m, "rb") as f:
        data = f.read()
    return m, stats, a2m, data, cli_s


def run_cli_palette(dev, mode, palette, k: int, j: int, seconds: int):
    """A clip through `cli.main --palette P --device cuda`
    (`cli_transcode`), then the player VM: duty cycles from the audio
    levels and final screens equal to the encoder's; then a
    `roofline[...]` line whose modelled chunk starts and bodies must equal
    the launches counted on the path."""
    import numpy as np

    from iivision_tpu_torch.video_mode import VideoMode

    what = "cli %s %s %ds k=%d j=%d" % (mode.name, palette.name, seconds, k, j)
    with tempfile.TemporaryDirectory() as tmp:
        m, stats, _, data, cli_s = cli_transcode(
            dev, tmp, mode, k, j, seconds, ("--palette", palette.name))
    if m.palette != palette or m.encoder_used != "whole":
        raise AssertionError("%s: the CLI's movie ran %s with the %s encoder"
                             % (what, m.palette, m.encoder_used))
    finals = [("main", m.final_main)]
    if mode == VideoMode.DHGR:
        finals.append(("aux", m.final_aux))
    check_vm(data, m.plan.n_ops,
             np.asarray(m.audio.levels())[:m.plan.n_ops], finals, what)
    print("%s: n_ops=%d bytes=%d frames_s=%.3f tables_s=%.3f encode_s=%.3f "
          "total_s=%.3f realtime_x=%.3f cli_s=%.3f; the VM plays it to the "
          "encoder's finals" % (
              what, m.plan.n_ops, len(data), stats["frames_s"],
              stats["tables_s"], stats["encode_s"], stats["total_s"],
              stats["realtime_x"], cli_s))
    roofline_line(what, dev, m.plan, mode, 1, stats["encode_s"],
                  enc_launches())


def run_lut_iigs(dev, n_rows: int = 1024):
    """The IIGS palette's LUTs (`make_tables --what luts` builds NTSC and
    IIGS): the whole DHGR LUT through `editdist.build_tables` (the IIGS
    cost matrix is symmetric, so kernel A's symmetric path runs), held by
    `bench.lut_checks` (a zero diagonal, sampled blocks symmetric, sampled
    rows against plain, cells against the scalar Damerau-Levenshtein),
    then the first `n_rows` rows of each HGR lane (the general tile), held
    by its row and cell checks."""
    import torch

    from iivision_tpu_torch import bench
    from iivision_tpu_torch.ops import editdist
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    for mode, rows in ((VideoMode.DHGR, None), (VideoMode.HGR, n_rows)):
        torch.cuda.synchronize()
        t0 = time.time()
        tables = editdist.build_tables(mode, Palette.IIGS, dev, n_rows=rows)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        checks = bench.lut_checks(tables, mode, Palette.IIGS, rows)
        print("LUT %s IIGS%s: shape=%s tablegen_s=%.4f checks=%s" % (
            mode.name, "" if rows is None else " first %d rows" % rows,
            tuple(tables.shape), build_s, json.dumps(checks)))
        bad = [name for name, ok in checks.items() if ok is False]
        if bad:
            raise AssertionError("LUT %s IIGS fails %s" % (mode.name, bad))


def run_delivery(dev, mode, k: int, j: int, seconds: int, boot: bool):
    """The delivery half on one clip (280x192, 30 fps, every 2nd frame, a
    440 Hz tone): transcode on the card through `cli.main`, then verify
    on the 6502 machine, serve (plain, seek, retarget), boot the disk
    (`boot`) and render, each step one `delivery:` line with its host
    seconds.  Any step that disagrees raises."""
    import numpy as np

    from iivision_tpu_torch import DATA_DIR, make_disk, quality
    from iivision_tpu_torch import render, render_stream, server
    from iivision_tpu_torch import verify_stream
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.sim import asm65, machine65
    from iivision_tpu_torch.stream import opcodes, retarget, seek
    from iivision_tpu_torch.video_mode import VideoMode

    what = "%s %ds k=%d j=%d" % (mode.name, seconds, k, j)
    dhgr = mode == VideoMode.DHGR

    def same_screens(got, want, name, pad_cell=False):
        """Both banks of two results (HGR: the aux bank untouched);
        pad_cell: `want` is the encoder's model, which the padding op's
        cell (0, 0) is not part of."""
        for bank in ("main", "aux") if dhgr else ("main",):
            eq = getattr(got, bank) == np.asarray(
                getattr(want, bank)).astype(np.uint8)
            if pad_cell:
                eq[0, 0] = True
            if not eq.all():
                raise AssertionError(
                    "delivery %s: %s %s bank differs at %s"
                    % (what, name, bank, np.argwhere(~eq)[:5]))
        if not dhgr and got.aux.any():
            raise AssertionError("delivery %s: %s touched the aux bank"
                                 % (what, name))

    with tempfile.TemporaryDirectory() as tmp:
        # 1. transcode on the card, through the CLI
        m, stats, a2m, data, cli_s = cli_transcode(dev, tmp, mode, k, j,
                                                   seconds)
        n_ops = m.plan.n_ops
        levels = np.asarray(m.audio.levels())[:n_ops]
        print("delivery: %s transcode: n_ops=%d bytes=%d frames=%d "
              "encode_s=%.3f total_s=%.3f realtime_x=%.3f cli_s=%.3f" % (
                  what, n_ops, len(data), len(data) // 2048,
                  stats["encode_s"], stats["total_s"], stats["realtime_x"],
                  cli_s))

        # 2. verify: the VM, then the real player on the 6502 machine
        t0 = time.time()
        if verify_stream.main([a2m, "--machine"]) != 0:
            raise AssertionError("delivery %s: verify_stream --machine "
                                 "failed" % what)
        verify_s = time.time() - t0
        t0 = time.time()
        full = machine65.play_stream(data)
        machine_s = time.time() - t0
        if full.exit_reason != "TERMINATED":
            raise AssertionError("delivery %s: machine exit %s at $%04X"
                                 % (what, full.exit_reason, full.pc))
        finals = types.SimpleNamespace(main=m.final_main, aux=m.final_aux)
        same_screens(full, finals, "machine vs the encoder's finals",
                     pad_cell=True)
        duty = split_slow_path_pairs(full.duty_cycles, n_ops)
        if not np.array_equal(duty,
                              expected_hardware_duty(levels * 2 + 34)):
            raise AssertionError("delivery %s: speaker duties differ from "
                                 "the audio levels" % what)
        if len(np.unique(levels)) < 8:
            raise AssertionError("delivery %s: the tone gave %d audio "
                                 "levels" % (what, len(np.unique(levels))))
        print("delivery: %s verify: machine exit=%s cycles=%d n_recv=%d "
              "screens equal the encoder's finals, %d duties equal the "
              "audio levels (%d distinct); verify_stream_s=%.3f "
              "machine_s=%.3f (%.4f s per stream second)" % (
                  what, full.exit_reason, full.cycles, full.n_recv,
                  len(duty), len(np.unique(levels)), verify_s, machine_s,
                  machine_s / (n_ops / 14700.0)))

        # 3. serve: plain, from the middle, and onto a relocated player
        t0 = time.time()
        if fetch(server.build_handler(a2m)) != data:
            raise AssertionError("delivery %s: served bytes differ from "
                                 "the file" % what)
        plain_s = time.time() - t0

        t0 = time.time()
        at = seconds / 2.0
        got = fetch(server.build_handler(
            a2m, transform=server.build_seeker(at)))
        point = seek.frame_at(seek.seek_index(data), at)
        if got != seek.seek(data, point.frame) or point.frame < 2:
            raise AssertionError("delivery %s: served seek stream differs "
                                 "from seek.seek at frame %d"
                                 % (what, point.frame))
        part = machine65.play_stream(got)
        if part.exit_reason != "TERMINATED":
            raise AssertionError("delivery %s: seek stream exit %s"
                                 % (what, part.exit_reason))
        model, mask = tail_store_model(data, point.byte_offset)
        seek_mem = np.stack([part.main, part.aux])
        full_mem = np.stack([full.main, full.aux])
        if not (np.array_equal(seek_mem[mask], model[mask])
                and np.array_equal(seek_mem[mask], full_mem[mask])):
            raise AssertionError("delivery %s: bytes stored after the seek "
                                 "point differ from full playback" % what)
        seek_s = time.time() - t0

        t0 = time.time()
        with open(asm65.PLAYER_SOURCE) as f:
            moved_asm = asm65.Assembler(segments={
                "LOWCODE": 0x0800, "HGR": 0x2000,
                "CODE": 0x4100}).assemble(f.read())
        old = opcodes.default_addresses()
        new = opcodes.OpcodeAddresses.from_symbols(moved_asm.symbols)
        if new.tick[(34, 40)] != old.tick[(34, 40)] + 0x100:
            raise AssertionError("the relocated build did not move")
        new_dbg = os.path.join(tmp, "relocated.dbg")
        write_dbg(new, new_dbg)
        got = fetch(server.build_handler(a2m, transform=server.build_retargeter(
            new_dbg, [os.path.join(DATA_DIR, "iivision.dbg")])))
        if got != retarget.retarget(data, old, new) or got == data:
            raise AssertionError("delivery %s: served retargeted stream "
                                 "differs from retarget.retarget" % what)
        var = machine65.Apple2Player(assembly=moved_asm).run(got)
        if var.exit_reason != "TERMINATED" or var.cycles != full.cycles \
                or not np.array_equal(var.duty_cycles, full.duty_cycles):
            raise AssertionError("delivery %s: relocated player exit=%s "
                                 "cycles=%d (vendored %d)" % (
                                     what, var.exit_reason, var.cycles,
                                     full.cycles))
        same_screens(var, full, "relocated player vs vendored")
        print("delivery: %s serve: plain %d bytes equal (%.3f s); seek to "
              "%.1f s = frame %d, TERMINATED, %d stored bytes equal full "
              "playback (%.3f s); retarget onto CODE=$4100 equals offline, "
              "relocated player TERMINATED with equal screens, duties and "
              "cycles (%.3f s)" % (what, len(data), plain_s, at, point.frame,
                                   int(mask.sum()), seek_s,
                                   time.time() - t0))

        # 4. boot the disk
        if boot:
            t0 = time.time()
            with open(make_disk.TEMPLATE_DISK, "rb") as f:
                disk = make_disk.build_disk(template=f.read()).to_po()
            booted = machine65.boot_disk(disk, data)
            if booted.exit_reason != "TERMINATED":
                raise AssertionError("delivery %s: disk boot exit %s at "
                                     "$%04X" % (what, booted.exit_reason,
                                                booted.pc))
            same_screens(booted, full, "disk boot vs direct load")
            print("delivery: %s boot: %d-byte ProDOS image, loader and "
                  "player TERMINATED, cycles=%d, screens equal (%.3f s)" % (
                      what, len(disk), booted.cycles, time.time() - t0))

        # 5. render
        t0 = time.time()
        states, vmode = render_stream.stream_screens(data, 10.0)
        last = types.SimpleNamespace(main=states[-1, 0], aux=states[-1, 1])
        same_screens(last, full, "last snapshot vs machine")
        same_screens(last, finals, "last snapshot vs the encoder's finals",
                     pad_cell=True)
        frame = int(m.plan.step_frame.max())
        psnr = quality.stream_psnr(
            states[-1, 0], states[-1, 1] if dhgr else None,
            render.screen_to_rgb(
                m.frames.targets_main[frame],
                m.frames.targets_aux[frame] if dhgr else None, mode,
                Palette.NTSC), mode, Palette.NTSC)
        if vmode != mode.value or not np.isfinite(psnr):
            raise AssertionError("delivery %s: render mode %d psnr %.2f"
                                 % (what, vmode, psnr))
        print("delivery: %s render: %d snapshots at 10 fps, the last equals "
              "the encoder's finals, stream_psnr_db=%.2f (%.3f s)" % (
                  what, len(states), psnr, time.time() - t0))


def profiled_kernels(prof):
    """{kernel name (first 60 chars): (device launches, device us)} of a
    torch.profiler run, and the host's kernel-launch calls."""
    import torch

    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "device_time", None)
            t = e.cuda_time if t is None else t
            n, us = by_name.get(e.name[:60], (0, 0.0))
            by_name[e.name[:60]] = (n + 1, us + t)
    launches = sum(1 for e in prof.events() if e.name in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    return by_name, launches


def trace_encodes(dev, report, seconds: float = 1.0, B: int = 32):
    """torch.profiler over 1 s DHGR encodes on ingested targets - solo and
    a batch of B at k=16 j=4, solo at k=8 j=1, solo joint at k=16 j=4 -:
    device busy share (kernel time over encode wall), kernel launches per
    plan step, and the device kernels that launch most.  Then the
    profiler's per-launch device time of the body kernel beside the event
    timer's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.parallel import mesh
    from iivision_tpu_torch.video_mode import VideoMode

    mode = VideoMode.DHGR
    src = torch.as_tensor(synth_clips(B, seconds, every_n=2)).to(dev)
    lanes_b, bytes_b = mesh.ingest_movies_batch(src, mode, Palette.NTSC)
    dist = distance.ComputedDistance(mode, Palette.NTSC, device=dev)
    body_us = None
    for tag, nb, k, j in (("solo", 1, 16, 4), ("batch", B, 16, 4),
                          ("solo", 1, 8, 1), ("solo_joint", 1, 16, 4)):
        plan, _ = encoder.plan_movie(
            n_frames=int(seconds * 30), n_audio_ticks=int(seconds * 14700),
            input_frame_rate=30.0, ticks_per_second=14700.0,
            every_n_video_frames=2, mode=mode, k=k, j=j)
        S = len(plan.step_frame)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            encoder.encode_movies(dist, lanes_b[:nb], bytes_b[:nb], plan,
                                  mode, list(range(nb)),
                                  joint=tag == "solo_joint")
            torch.cuda.synchronize()
            wall = time.time() - t0
        by_name, launches = profiled_kernels(prof)
        dev_us = sum(us for _, us in by_name.values())
        kernels = sum(n for n, _ in by_name.values())
        print("trace %s B=%d %gs k=%d j=%d: plan_steps=%d bodies=%d "
              "encode_s=%.3f device_kernel_s=%.4f busy_share=%.4f "
              "device_kernels=%d launches=%d launches_per_step=%.2f" % (
                  tag, nb, seconds, k, j, S, S // plan.chunk_steps, wall,
                  dev_us / 1e6, dev_us / 1e6 / wall, kernels, launches,
                  launches / S))
        for name, (n, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            print("  %s kernel %s: per_step=%.2f device_ms=%.3f "
                  "us_per_launch=%.2f" % (tag, name, n / S, us / 1e3,
                                          us / n))
            if nb == 1 and k == 8 and "encode_body" in name:
                body_us = us / n
    trace_mesh(dist, lanes_b, bytes_b, mode, seconds)
    if body_us is not None:
        print("encode_body DHGR k=8 j=1 B=1: profiler us_per_launch=%.2f "
              "(a whole clip's bodies) against the event timer's %.2f us "
              "(one body, repeated)" % (body_us,
                                        report["encode_body"]["ms"] * 1e3))


def trace_mesh(dist, lanes_b, bytes_b, mode, seconds: float):
    """torch.profiler over the B-movie batch encode at k=16 j=4 sharded
    over (cuda:0, cuda:0): device busy share, and how far the two shards'
    kernels overlap on the card (1 - the union of the kernels' device
    intervals over their sum: 0 when they serialize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.parallel import mesh

    dev = lanes_b.device
    plan, _ = encoder.plan_movie(
        n_frames=int(seconds * 30), n_audio_ticks=int(seconds * 14700),
        input_frame_rate=30.0, ticks_per_second=14700.0,
        every_n_video_frames=2, mode=mode, k=16, j=4)
    two = mesh.as_mesh((dev, dev))
    shards = [mesh.shard_batch(x, two) for x in (lanes_b, bytes_b)]
    seeds = list(range(len(lanes_b)))
    mesh.encode_movies_batch(dist, *shards, plan, mode, seeds, mesh=two)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        mesh.encode_movies_batch(dist, *shards, plan, mode, seeds, mesh=two)
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total = sum(b - a for a, b in spans)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    _, launches = profiled_kernels(prof)
    print("trace mesh2 B=%d %gs k=16 j=4 (cuda:0 twice): encode_s=%.3f "
          "device_kernel_s=%.4f busy_share=%.4f device_kernels=%d "
          "launches=%d overlap_share=%.4f" % (
              len(seeds), seconds, wall, union / 1e6, union / 1e6 / wall,
              len(spans), launches, 1 - union / total if total else 0.0))


def run_lut_sharded(dev, lut, n_rows: int = 1024):
    """build_tables_sharded on DHGR NTSC over the mesh (cuda:0, cuda:0):
    the first `n_rows` rows of every lane in two row blocks, each kernel
    A's general tile against all 8192 codes.  Every lane must equal the
    same rows of the full LUT that `lut` = (the bench's lut_dhgr_ntsc
    record, its table) holds."""
    import torch

    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.parallel import mesh
    from iivision_tpu_torch.video_mode import VideoMode

    rec, tables = lut
    full_s = rec["timings"]["tablegen_s"]["median"]
    n = 8192
    build_s = []  # the first call in the process, then a second one
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        rows = mesh.build_tables_sharded(VideoMode.DHGR, Palette.NTSC,
                                         (dev, dev), n_rows=n_rows)
        torch.cuda.synchronize()
        build_s.append(time.time() - t0)
    if tuple(rows.shape) != (4, n_rows * n) or rows.dtype != torch.uint16:
        raise AssertionError("sharded LUT rows of shape %s %s"
                             % (tuple(rows.shape), rows.dtype))
    full = tables.view(torch.int16).view(4, n, n)
    got = rows.view(torch.int16).view(4, n_rows, n)
    for lane in range(4):
        if not torch.equal(got[lane], full[lane, :n_rows]):
            bad = (got[lane] != full[lane, :n_rows]).nonzero()[:4].tolist()
            raise AssertionError("sharded LUT lane %d differs from the full "
                                 "LUT at %s" % (lane, bad))
    print("LUT DHGR NTSC sharded over (cuda:0, cuda:0): %d rows x %d lanes "
          "build_s=%.4f, again %.4f (%.3g s per 1k rows; the full LUT's "
          "symmetric build %.4f s for %d rows, %.3g s per 1k rows); every "
          "row equals the full LUT's" % (
              n_rows, 4, build_s[0], build_s[1], build_s[1] * 1024 / n_rows,
              full_s, n, full_s * 1024 / n))


ORACLE_CASES = (  # (path, mode, palette, k, j, seconds, joint)
    ("host_oracle_dhgr_1s_k8_j1", "DHGR", "NTSC", 8, 1, 1.0, False),
    ("host_oracle_hgr_1s_k4_j3", "HGR", "NTSC", 4, 3, 1.0, False),
    ("host_oracle_dhgr_joint_k16_j4", "DHGR", "NTSC", 16, 4, 0.25, True),
    ("host_oracle_hgr_iigs_1s_k4_j3", "HGR", "IIGS", 4, 3, 1.0, False))


def run_host_oracle(dev, mode_name: str, palette_name: str, k: int, j: int,
                    seconds: float, joint: bool):
    """A deterministic (seed None) encode of a synthetic clip (30 fps,
    every 2nd frame, ingested and scored on `palette_name`'s tables)
    through encoder.encode_movie on the card, with the CUDA kernels,
    against the port's host oracle: its ops must equal
    encoder_host.encode_movie_host's op for op, and a HostEncoder replay's
    ops and final screens must equal the card's.  Prints the oracle's host
    seconds beside the card's encode."""
    import numpy as np
    import torch

    from iivision_tpu_torch import encoder, encoder_host
    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.parallel import mesh
    from iivision_tpu_torch.video_mode import VideoMode

    mode, palette = VideoMode[mode_name], Palette[palette_name]
    F = int(seconds * 30)
    src = torch.as_tensor(synth_clip(seconds=seconds, phase=1.3)[None, ::2])
    lanes_b, bytes_b = mesh.ingest_movies_batch(src.to(dev), mode, palette)
    plan, n_enc = encoder.plan_movie(
        n_frames=F, n_audio_ticks=int(seconds * 14700),
        input_frame_rate=30.0, ticks_per_second=14700.0,
        every_n_video_frames=2, mode=mode, k=k, j=j)
    dist = distance.ComputedDistance(mode, palette, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    ops, main, aux = encoder.encode_movie(dist, lanes_b[0, :n_enc],
                                          bytes_b[0, :n_enc], plan, mode,
                                          seed=None, joint=joint)
    flat = encoder.flatten_ops(ops.cpu().numpy(), plan).astype(np.int32)
    card_s = time.time() - t0
    lanes, bytes_ = lanes_b[0, :n_enc].cpu(), bytes_b[0, :n_enc].cpu()
    t0 = time.time()
    want = encoder_host.encode_movie_host(dist, lanes, bytes_, plan, mode,
                                          joint=joint)
    oracle_s = time.time() - t0
    t0 = time.time()
    henc = encoder_host.HostEncoder(mode, dist, k=k, j=j, joint=joint)
    replay = np.asarray(encoder_host.run_plan(henc, lanes, bytes_, plan),
                        np.int32)
    replay_s = time.time() - t0
    what = "%s %s k=%d j=%d%s" % (mode.name, palette.name, k, j,
                                  " joint" if joint else "")
    if not np.array_equal(flat, want):
        bad = np.argwhere((flat != want).any(axis=1))[:, 0]
        raise AssertionError("%s: the card's ops differ from the host oracle "
                             "at %d ops, first op %d: %s vs %s" % (
                                 what, len(bad), bad[0],
                                 flat[bad[0]].tolist(),
                                 want[bad[0]].tolist()))
    if not (np.array_equal(replay, want)
            and np.array_equal(main.cpu().numpy(), henc.banks[0])
            and np.array_equal(aux.cpu().numpy(), henc.banks[-1])):
        raise AssertionError("%s: the HostEncoder replay's ops or final "
                             "screens differ from the card's" % what)
    print("host oracle %s %gs seed=None: n_ops=%d, ops and final screens "
          "equal; card encode+fetch_s=%.3f oracle_s=%.3f replay_s=%.3f" % (
              what, seconds, plan.n_ops, card_s, oracle_s, replay_s))


def bench_paths():
    """(configuration, kernels it must launch) of every configuration of
    `python -m iivision_tpu_torch.bench`, in its order: the encodes launch
    the body kernel with the chunk start in its prologue, the yiq one its
    yiq recompute; those scored by replay launch the lane distance, the
    LUT builds kernel A's tile."""
    from iivision_tpu_torch import bench

    enc = ("chunk_start", "encode_body")
    scored = enc + ("lane_dist",)
    special = {
        "dhgr_ntsc_yiq": ("chunk_start_yiq", "encode_body", "lane_dist"),
        "lut_dhgr_ntsc": ("editdist_tile",),
        "hgr_tablegen": ("editdist_tile",),
        "batch10_plus_tablegen": enc + ("editdist_tile",),
    }
    for name, entry in bench.all_configs().items():
        if name in special:
            yield name, special[name]
        elif (entry.group == "k_sweep" or name.startswith(("hgr_ntsc",
                                                           "dhgr_ntsc",
                                                           "dhgr_iigs"))):
            yield name, scored
        else:
            yield name, enc


def run_bench_config(name, ctx):
    """`python -m iivision_tpu_torch.bench --reps 1 --only NAME` in this
    process, on the smoke's shared bench Context: prints one summary line
    and fails unless the record passed.  Returns (the record, the last
    timed rep's output)."""
    from iivision_tpu_torch import bench

    keep = {}
    rec = bench.run_case(name, bench.all_configs()[name], ctx, 1, keep=keep)
    timings = rec.get("timings", {})
    rate = [k for k in timings if timings[k]["unit"] == "x_realtime"]
    trace = rec.get("trace")
    print("bench: %s ok=%s wall_s=%s %s busy_share=%s checks=%s%s" % (
        rec["name"], rec["ok"],
        "%.4f" % timings["wall_s"]["median"] if timings else "-",
        " ".join("%s=%.3f" % (k, timings[k]["median"]) for k in rate),
        trace.get("busy_share") if isinstance(trace, dict) else trace,
        json.dumps({k: v for k, v in rec.get("checks", {}).items()
                    if not isinstance(v, (list, dict))}),
        " error=" + rec["error"] if "error" in rec else ""))
    if not rec["ok"]:
        raise AssertionError("bench configuration %s failed" % name)
    return rec, keep["out"]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
