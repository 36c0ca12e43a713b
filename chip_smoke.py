"""Smoke run of iivision_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc and checks each against
its plain torch version on the card: kernel A (all pairs, and elementwise
at L = 10 and 18), kernel B (solo DHGR at both encoder settings, solo HGR
with its 256 contents, a case where offset 0 is the only companion, and
batches: 32 DHGR movies at k=16 j=4 and 8 HGR movies at k=8 j=1), kernel
B's joint variant (DHGR and HGR at k=16 j=4, and a crafted page where a
non-target content wins) and kernel C (the sub-op microbenchmark at B=32,
K=16, T=100).
It reproduces the JAX package's golden stream, then drives each entry
point of the port with the launch counts set to 0 before it and read
after it:

- 10 s DHGR clips at (k=8, j=1) and (k=16, j=4), and a 10 s HGR clip at
  (k=8, j=1), through Movie.transcode and the player VM;
- the full DHGR NTSC LUT (make_tables' path);
- the sub-op microbenchmark's T sweep (bench_subop.run);
- 2 s clips in the yiq (DHGR) and mono (HGR) colour models; the mono clip
  builds its store-cost table on the card, and sampled rows of that table
  are held against the plain build;
- the batch transcode: 32 distinct 10 s clips (`bench.synth_clip`, one
  phase each) through ingest_movies_batch, encode_movies_batch at k=16
  j=4, fetch_ops_compact and emit; every stream through the player VM, and
  movies 0 and 31 byte-equal to their solo encodes;
- the CLI's batch mode on three .npz clips of 10, 6 and 3 s: every stream
  plays at its own length, and the shortest equals its padded solo encode;
- the 5 s quality clip of tests/test_quality_regression.py at k=16 j=4,
  with and without joint content, replayed and scored on the card: each
  mean error within 1.01x of tests/data/quality_baseline.json, and joint
  below the default rule's baseline.

A last, uncounted phase traces 1 s clips at k=16 j=4, solo and as a batch
of 32, with torch.profiler: device busy share, kernel launches per plan
step and the kernels that launch most.

Every phase prints one line of numbers; any failure raises, giving a
non-zero exit.  The last two lines are the kernel report and the device
line, both JSON.  Needs one CUDA card; without one it exits non-zero
before printing any result.  Imports nothing of JAX.  Store-cost tables
it builds go to a temporary cache directory that is removed at exit.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

GOLDEN_SHA = "57fdd52adf53d75101ed121d28d8a5389465c09f99d960ba6c47c20dbdb30fbc"

# kernel -> (wrapper module, wrapper name, source, the TPU or JAX function
# it replaces)
KERNELS = {
    "editdist_tile": ("editdist", "pair_distance",
                      "iivision_tpu_torch/csrc/editdist.cu",
                      "iivision_tpu/ops/editdist.py:232"),
    "dist_pairs": ("editdist", "dist_pairs_elementwise",
                   "iivision_tpu_torch/csrc/editdist.cu",
                   "iivision_tpu/ops/editdist.py:232"),
    "subop_chain": ("subop", "sub_op_chain",
                    "iivision_tpu_torch/csrc/subop.cu",
                    "iivision_tpu/encoder.py:567"),
    "subop_chain_joint": ("subop", "sub_op_chain_joint",
                          "iivision_tpu_torch/csrc/subop.cu",
                          "iivision_tpu/encoder.py:583"),
    "subop_bench": ("subop_bench", "run_kernel",
                    "iivision_tpu_torch/csrc/subop.cu",
                    "tools/bench_subop_pallas.py:183"),
}


def wrapper(name):
    import importlib

    mod, fn = KERNELS[name][:2]
    return getattr(importlib.import_module("iivision_tpu_torch.ops." + mod),
                   fn)


def counted(path, want, fn, *args, **kw):
    """Run one path with every launch count at 0; fail unless each kernel
    in `want` launched.  Returns (fn's result, {kernel: launches})."""
    for name in KERNELS:
        wrapper(name).launches = 0
    t0 = time.time()
    out = fn(*args, **kw)
    launches = {name: wrapper(name).launches for name in KERNELS}
    print("launches %s: %s path_s=%.1f" % (path, json.dumps(launches),
                                            time.time() - t0))
    for name in want:
        if launches[name] == 0:
            raise AssertionError("kernel %s never launched on path %s"
                                 % (name, path))
    return out, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch import _build, bench_subop

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # -- 1. build --------------------------------------------------------
    b = _build.build()
    print("build: %s seconds=%.2f built=%s" % (
        os.path.relpath(b["path"]), b["seconds"], b["built"]))
    for line in b["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.library()

    # -- 2. each kernel against its plain version -------------------------
    report = {}
    check_kernel_a(dev, report)
    check_kernel_b(dev, report)
    check_kernel_b_joint(dev, report)
    check_kernel_c(dev, report)
    check_golden(dev)
    print("kernel checks done at %.1f s" % (time.time() - t_start))

    # -- 3. the port's paths, each counted --------------------------------
    dhgr, hgr = VideoMode.DHGR, VideoMode.HGR
    totals = {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory() as cache:
        os.environ["XDG_CACHE_HOME"] = cache
        for path, want, fn, args, kw in (
                ("dhgr_10s_k8_j1", ("dist_pairs", "subop_chain"), run_movie,
                 (dev, dhgr, 8, 1, 10), {}),
                ("dhgr_10s_k16_j4", ("dist_pairs", "subop_chain"),
                 run_movie, (dev, dhgr, 16, 4, 10), {}),
                ("hgr_10s_k8_j1", ("dist_pairs", "subop_chain"), run_movie,
                 (dev, hgr, 8, 1, 10), {}),
                ("lut_dhgr_ntsc", ("editdist_tile",), build_and_check_lut,
                 (dev,), {}),
                ("bench_subop", ("subop_bench",), run_bench,
                 (dev, bench_subop, report), {}),
                ("dhgr_2s_yiq", ("subop_chain",), run_movie,
                 (dev, dhgr, 8, 1, 2), dict(colour_model="yiq")),
                ("hgr_2s_mono", ("dist_pairs", "subop_chain"), run_mono,
                 (dev, hgr), {}),
                ("batch_dhgr_b32_10s_k16_j4", ("dist_pairs", "subop_chain"),
                 run_batch, (dev,), {}),
                ("batch_cli_mixed", ("dist_pairs", "subop_chain"),
                 run_cli_mixed, (dev,), {}),
                ("quality_dhgr_5s_k16_j4",
                 ("dist_pairs", "subop_chain", "subop_chain_joint"),
                 run_quality, (dev,), {})):
            _, launches = counted(path, want, fn, *args, **kw)
            for name, n in launches.items():
                totals[name] += n
        del os.environ["XDG_CACHE_HOME"]
    print("main path launches: %s" % json.dumps(totals))
    t0 = time.time()
    trace_encodes(dev)
    print("trace_s=%.1f" % (time.time() - t0))

    kernels = [dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=totals[name], **report[name])
               for name, (_, _, src, replaces) in KERNELS.items()]
    print("wall_s=%.1f" % (time.time() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def as_i32(t):
    """uint16 tensor -> int32 values (through int16, whose CUDA ops torch
    implements in full)."""
    import torch

    return t.view(torch.int16).to(torch.int32) & 0xFFFF


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device milliseconds of fn() over reps (after one warm-up),
    timed with CUDA events; setup() runs outside the timed region."""
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
    """Kernel A against its plain version: all pairs on DHGR and HGR
    blocks, elementwise on 8192 random pairs; exact equality."""
    import numpy as np
    import torch

    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch.ops import distance, editdist

    sub = editdist.cost_matrix(Palette.NTSC, dev)
    errs = []
    for mode, na, nb in ((VideoMode.DHGR, 1024, 8192),
                         (VideoMode.HGR, 512, 2048)):
        codes = editdist.lane_codes(mode, 0, dev)
        a, bb = codes[:na].contiguous(), codes[:nb].contiguous()
        got = as_i32(editdist.pair_distance(a, bb, sub))
        want = editdist.dp_distance_tile(a, bb, sub)
        if int(want.max()) >= 1 << 16:
            raise AssertionError("%s distances overflow uint16" % mode.name)
        err = int((got - want).abs().max())
        print("kernel A all-pairs %s %dx%d L=%d: max_abs_err=%d" % (
            mode.name, na, nb, codes.shape[1], err))
        if err:
            raise AssertionError("kernel A all-pairs disagrees with plain")
        errs.append(err)
    # full DHGR lane, the LUT entry point's shape
    codes = editdist.lane_codes(VideoMode.DHGR, 0, dev)
    ms = cuda_ms(lambda: editdist.pair_distance(codes, codes, sub), 5)
    plain_ms = cuda_ms(lambda: editdist.dp_distance_tile(codes, codes, sub), 2)
    print("kernel A all-pairs 8192x8192 lane: ms=%.3f plain_ms=%.3f" % (
        ms, plain_ms))
    report["editdist_tile"] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms)

    # the encoder's chunk-start diff shapes: both lanes of a bank, L = 10
    # (DHGR) and L = 18 (HGR), under the NTSC window basis
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
        print("kernel A elementwise 8192 pairs L=%d: max_abs_err=%d "
              "ms=%.4f plain_ms=%.4f" % (L, err, ms, plain_ms))
        if err:
            raise AssertionError("kernel A elementwise (L=%d) disagrees "
                                 "with plain" % L)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms" + tag] = ms
        entry["plain_ms" + tag] = plain_ms


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


def subop_inputs(dev, mode, k: int, j: int, seed: int, B: int = 1):
    """Seeded kernel B inputs for B movies at the encoder's shapes for
    `mode`: page rows, table rows on the main bank's lanes, the real NTSC
    window store-cost table (DHGR: 4 x 8192 x 128, HGR: 2 x 16384 x 256),
    and per-movie nonces, pages and padding bytes."""
    import numpy as np
    import torch

    from iivision_tpu.palettes import Palette
    from iivision_tpu.screen import spec_for_mode
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch.ops import distance

    rng = np.random.RandomState(seed)
    table16 = torch.as_tensor(
        distance.store_cost_table(mode, Palette.NTSC), device=dev)
    R, C = table16.shape[1], table16.shape[2]
    up = rng.randint(0, 3000, (B, k, 256)) * (rng.rand(B, k, 256) < 0.6)
    up[:, 0] = 0  # one idle page per movie: its sub-ops are padding
    dw = rng.randint(0, 900, (B, k, 256))
    # screen bytes: 7 bits in DHGR, 8 (palette bit included) in HGR
    by = rng.randint(0, 128 if mode == VideoMode.DHGR else 256, (B, k, 256))
    tb = rng.randint(0, 256, (B, k, 256))
    rows = torch.as_tensor(np.stack([up, dw, by, tb], axis=2),
                           dtype=torch.float32, device=dev)
    le, lo = spec_for_mode(mode).bank_lanes(False)
    lane = np.where(np.arange(256) % 2 == 0, le, lo)
    sc_rows = torch.as_tensor(lane * R + rng.randint(0, R, (B, k, 256)),
                              dtype=torch.int32, device=dev)
    nonce = torch.as_tensor(rng.rand(B, j, k, 256), dtype=torch.float32,
                            device=dev)
    pages = torch.as_tensor(np.stack([rng.permutation(32)[:k]
                                      for _ in range(B)]),
                            dtype=torch.int64, device=dev)
    pad = torch.as_tensor(rng.randint(0, 256, B), dtype=torch.int32,
                          device=dev)
    return rows, sc_rows, table16.reshape(-1, C), nonce, pages, pad


def hold_chain(dev, entry, tag, joint, rows, sc_rows, table, nonce, pages,
               nvalid, pad, reps=200):
    """One kernel B call against the plain chain on the same inputs (rows
    and records bit-equal), then both timed; records ms and plain_ms
    under `tag` in `entry`."""
    import torch

    from iivision_tpu_torch.ops import subop

    chain = subop.sub_op_chain_joint if joint else subop.sub_op_chain
    B, k = rows.shape[:2]
    j = 1 if nonce is None else nonce.shape[1]
    out_k = torch.empty((B, j, k, 6), dtype=torch.uint8, device=dev)
    out_p = torch.empty_like(out_k)
    rows_k, rows_p = rows.clone(), rows.clone()
    chain(rows_k, sc_rows, table, nonce, pages, nvalid, pad, out_k)
    subop.sub_op_chain_plain(rows_p, sc_rows, table, nonce, pages, nvalid,
                             pad, out_p, joint)
    torch.cuda.synchronize()
    err = max(float((rows_k - rows_p).abs().max()),
              float((out_k.int() - out_p.int()).abs().max()))
    if not (torch.equal(rows_k, rows_p) and torch.equal(out_k, out_p)):
        raise AssertionError("kernel B%s (%s) disagrees with plain"
                             % (" joint" if joint else "", tag or "default"))
    ms = cuda_ms(lambda r: chain(r, sc_rows, table, nonce, pages, nvalid,
                                 pad, out_k), reps,
                 setup=lambda: (rows.clone(),))
    plain_ms = cuda_ms(lambda r: subop.sub_op_chain_plain(
        r, sc_rows, table, nonce, pages, nvalid, pad, out_p, joint),
        max(3, reps // 20), setup=lambda: (rows.clone(),))
    print("kernel B%s B=%d C=%d k=%d j=%d: max_abs_err=%g ms=%.4f "
          "plain_ms=%.4f" % (" joint" if joint else "", B, table.shape[1],
                             k, j, err, ms, plain_ms))
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["ms" + tag] = ms
    entry["plain_ms" + tag] = plain_ms
    return rows_k, out_k


def check_kernel_b(dev, report):
    """Kernel B against its plain version, rows and records bit-equal:
    solo (B = 1) on DHGR at (k=8, j=1) and (k=16, j=4) and on HGR (C = 256)
    at (k=8, j=1); batches of 32 DHGR movies at (16, 4) and 8 HGR movies at
    (8, 1), each movie with its own pages, nonces and padding byte."""
    import torch

    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch.ops import subop

    # the solo DHGR CLI default (k=8, j=1) gives ms / plain_ms; the other
    # settings are reported beside it
    entry = report["subop_chain"] = dict(max_abs_err=0.0)
    for mode, B, k, j, seed, tag in (
            (VideoMode.DHGR, 1, 8, 1, 19, ""),
            (VideoMode.DHGR, 1, 16, 4, 27, "_k16_j4"),
            (VideoMode.HGR, 1, 8, 1, 31, "_hgr"),
            (VideoMode.DHGR, 32, 16, 4, 37, "_b32_k16_j4"),
            (VideoMode.HGR, 8, 8, 1, 41, "_hgr_b8")):
        rows, sc_rows, table, nonce, pages, pad = subop_inputs(
            dev, mode, k, j, seed, B)
        hold_chain(dev, entry, tag, False, rows, sc_rows, table, nonce,
                   pages, k * j - 3, pad)

    # offset 0 is each page's only companion: the later rounds find nothing
    # and come back to offset 0, which must stay stored
    k = 2
    rows = torch.zeros((1, k, 4, 256), dtype=torch.float32, device=dev)
    rows[0, :, 0, 10], rows[0, :, 0, 0] = 1000.0, 500.0
    rows[0, :, 1, 10], rows[0, :, 1, 0] = 900.0, 800.0
    rows[0, :, 3, 10] = 5.0
    args = (torch.zeros((1, k, 256), dtype=torch.int32, device=dev),
            torch.zeros((1, 128), dtype=torch.int16, device=dev), None,
            torch.tensor([[3, 7]], dtype=torch.int64, device=dev), k,
            torch.zeros(1, dtype=torch.int32, device=dev))
    outs = [torch.empty((1, 1, k, 6), dtype=torch.uint8, device=dev)
            for _ in range(2)]
    got, want = rows.clone(), rows.clone()
    subop.sub_op_chain(got, *args, outs[0])
    subop.sub_op_chain_plain(want, *args, outs[1])
    torch.cuda.synchronize()
    print("kernel B offset-0 companion: up[0]=%g by[0]=%g (plain %g, %g)" % (
        got[0, 0, 0, 0], got[0, 0, 2, 0], want[0, 0, 0, 0],
        want[0, 0, 2, 0]))
    if not (torch.equal(got, want) and torch.equal(*outs)):
        raise AssertionError("kernel B drops an offset-0 companion")


def check_kernel_b_joint(dev, report):
    """Kernel B's joint variant against the plain joint chain, bit-equal:
    DHGR (C = 128) and HGR (C = 256) at (k=16, j=4), seeded, and a crafted
    page where content 7 beats the target byte 5, so the primary keeps its
    residual (up = dw = 100 at offset 10)."""
    import numpy as np
    import torch

    from iivision_tpu.video_mode import VideoMode

    entry = report["subop_chain_joint"] = dict(max_abs_err=0.0)
    for mode, seed, tag in ((VideoMode.DHGR, 43, ""),
                            (VideoMode.HGR, 47, "_hgr")):
        inputs = subop_inputs(dev, mode, 16, 4, seed)
        hold_chain(dev, entry, tag, True, *inputs[:5], 16 * 4 - 3,
                   inputs[5], reps=50)

    up = np.zeros(256)
    dw = np.zeros(256)
    tb = np.zeros(256)
    up[10], dw[10], tb[10] = 1000, 900, 5
    table = np.full((256, 128), 1000)
    table[10, 5], table[10, 7] = 0, 100
    for t in (20, 30, 40):
        up[t], dw[t] = 100, 800
        table[t, 5], table[t, 7] = 800, 0
    rows = torch.as_tensor(np.stack([up, dw, np.zeros(256), tb])[None, None],
                           dtype=torch.float32, device=dev)
    rows_k, out_k = hold_chain(
        dev, dict(max_abs_err=0.0), "", True, rows,
        torch.arange(256, dtype=torch.int32, device=dev)[None, None].clone(),
        torch.as_tensor(table, dtype=torch.int16, device=dev), None,
        torch.tensor([[3]], dtype=torch.int64, device=dev), 1,
        torch.zeros(1, dtype=torch.int32, device=dev), reps=5)
    rec = out_k[0, 0, 0].tolist()
    print("kernel B joint crafted page: record %s, up[10]=%g dw[10]=%g" % (
        rec, rows_k[0, 0, 0, 10], rows_k[0, 0, 1, 10]))
    if rec != [35, 7, 10, 20, 30, 40] or rows_k[0, 0, 0, 10] != 100 \
            or rows_k[0, 0, 1, 10] != 100:
        raise AssertionError("joint content on the crafted page: %s" % rec)


def check_kernel_c(dev, report):
    """Kernel C against the plain loop at the microbenchmark's shape
    (B*K = 512 rows, T = 100), on its seeded inputs with one crafted row
    whose only companion is offset 0: final up/dw/by bit-equal."""
    import torch

    from iivision_tpu_torch import bench_subop
    from iivision_tpu_torch.ops import subop_bench

    T = 100
    args = bench_subop.fresh(32 * 16, 999, dev)
    for a in args[:3]:
        a[0] = 0.0
    args[0][0, 10], args[0][0, 0] = 1000.0, 500.0
    args[1][0, 10], args[1][0, 0] = 900.0, 800.0
    got = subop_bench.run_kernel(*args, T)
    want = subop_bench.run_plain(*args, T)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("kernel C disagrees with the plain loop")
    ms = cuda_ms(lambda: subop_bench.run_kernel(*args, T), 50)
    plain_ms = cuda_ms(lambda: subop_bench.run_plain(*args, T), 3)
    print("kernel C B=32 K=16 T=%d: max_abs_err=%g ms=%.4f plain_ms=%.4f"
          % (T, err, ms, plain_ms))
    report["subop_bench"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_golden(dev):
    """The JAX package's pinned stream (tests/test_stream.py), encoded on
    the card through both kernels."""
    import numpy as np

    from iivision_tpu.palettes import Palette
    from iivision_tpu.stream.emit_fast import emit_stream_fast
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import distance

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


def build_lut(dev):
    """The LUT entry point: the full DHGR NTSC 4 x 8192^2 uint16 table
    through kernel A."""
    import torch

    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch.ops import editdist

    torch.cuda.synchronize()
    t0 = time.time()
    tables = editdist.build_tables(VideoMode.DHGR, Palette.NTSC, dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    print("LUT DHGR NTSC: shape=%s dtype=%s MB=%d build_s=%.3f" % (
        tuple(tables.shape), tables.dtype,
        tables.numel() * 2 // (1 << 20), build_s))
    codes = [editdist.lane_codes(VideoMode.DHGR, lane, dev)
             for lane in range(4)]
    return tables, codes, editdist.cost_matrix(Palette.NTSC, dev)


def run_movie(dev, mode, k: int, j: int, seconds: int,
              colour_model: str = "window"):
    """A clip of `seconds` at 30 fps with a 44.1 kHz tone, every 2nd frame
    encoded, through Movie(...).transcode on the card (14,700 Hz output
    audio), then the player VM: its final screens must equal the encoder's
    model.  Returns the Movie."""
    import numpy as np
    import torch

    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch.movie import Movie

    from scipy.io import wavfile

    rgb = gradient_clip(30 * seconds)
    n = 44100 * seconds
    tone = np.sin(2 * np.pi * 440 * np.arange(n) / 44100) * 12000
    with tempfile.TemporaryDirectory() as tmp:
        # the clip's audio track: decoded, then resampled on the card
        wav = os.path.join(tmp, "clip.wav")
        wavfile.write(wav, 44100, tone.astype(np.int16))
        m = Movie(wav, frames_source=rgb, frame_rate=30.0,
                  every_n_video_frames=2, k=k, j=j, seed=0, device=dev,
                  video_mode=mode, colour_model=colour_model,
                  dither_mode="mono" if colour_model == "mono"
                  else "ordered")
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
    print("movie %s %ds %s k=%d j=%d: n_ops=%d bytes=%d frames_s=%.3f "
          "audio_s=%.3f tables_s=%.3f encode_s=%.3f emit_s=%.3f "
          "total_s=%.3f realtime_x=%.3f" % (
              mode.name, seconds, colour_model, k, j, stats["n_ops"],
              len(data), stats["frames_s"], stats["audio_s"],
              stats["tables_s"], stats["encode_s"], stats["emit_s"],
              stats["total_s"], stats["realtime_x"]))
    return m


def run_mono(dev, mode):
    """A 2 s mono clip (k=8, j=1).  No mono table is shipped, so its Movie
    builds one on the card (kernel A elementwise, L = 18 for HGR) into the
    empty temporary cache; 64 sampled rows of the table the clip encoded
    with are then held against the plain build on the CPU."""
    import numpy as np
    import torch

    from iivision_tpu.palettes import Palette
    from iivision_tpu_torch.ops import distance

    path = distance.store_cost_path(mode, Palette.NTSC, "mono",
                                    distance._user_cache_dir())
    if os.path.exists(path):
        raise AssertionError("mono table cached before the clip: %s" % path)
    m = run_movie(dev, mode, 8, 1, 2, colour_model="mono")
    if not os.path.exists(path):
        raise AssertionError("the mono clip saved no store-cost table")
    table = m.dist.store_cost16
    sub = torch.as_tensor(distance.sub16_mono().astype(np.int32))
    rng = np.random.RandomState(6)
    n = table.shape[1]
    worst = 0
    for lane in range(table.shape[0]):
        t = torch.as_tensor(rng.randint(0, n, 32))
        want = distance.store_cost_rows(mode, lane, t, sub)
        got = table[lane, t.to(dev)].cpu().to(torch.int32)
        worst = max(worst, int((got - want).abs().max()))
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
    """B distinct bench.synth_clip movies (280x192, 30 fps, phase 0.2*i),
    every `every_n`-th frame kept: (B, F, 192, 280, 3) uint8, made on 8
    host threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    import bench

    def one(i):
        return bench.synth_clip(seconds=seconds, phase=0.2 * i)[::every_n]

    with ThreadPoolExecutor(8) as pool:
        return np.stack(list(pool.map(one, range(B))))


def tone_levels(dev, seconds: float):
    """The quality gate's audio: a 440 Hz sine at 14,700 Hz (no resample),
    as the port's Audio."""
    import numpy as np

    from iivision_tpu_torch import audio

    n = int(seconds * 14700)
    tone = (np.sin(2 * np.pi * 440 * np.arange(n) / 14700)
            * 16000).astype(np.float32)
    return audio.Audio(data=tone, rate=14700, bitrate=14700, device=dev)


def check_vm(data, n_ops, levels, finals, what):
    """The player VM decodes a stream: n_ops ops, duty cycles from the
    audio levels, final screens equal to the encoder's model (except the
    padding op's cell).  finals: [(name, (32, 256) model bank)]."""
    import numpy as np

    from iivision_tpu.sim import PlayerVM

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


def run_batch(dev, B: int = 32, seconds: float = 10.0):
    """The batch transcode at the JAX benchmark's headline setting: B
    distinct synthetic 280x192 clips (every 2nd frame), device ingest,
    one lockstep encode at k=16 j=4 with seeds 0..B-1, compact fetch and
    emit.  Every stream plays in the player VM; movies 0 and B-1 equal
    their solo encodes byte for byte."""
    import numpy as np
    import torch

    from iivision_tpu.palettes import Palette
    from iivision_tpu.stream.emit_fast import emit_stream_fast
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import distance, editdist, subop
    from iivision_tpu_torch.parallel import mesh

    mode = VideoMode.DHGR
    t0 = time.time()
    src = synth_clips(B, seconds, every_n=2)
    synth_s = time.time() - t0
    aud = tone_levels(dev, seconds)
    levels = np.asarray(aud.levels())
    plan, n_enc = encoder.plan_movie(
        n_frames=int(seconds * 30), n_audio_ticks=len(levels),
        input_frame_rate=30.0, ticks_per_second=14700.0,
        every_n_video_frames=2, mode=mode, k=16, j=4)
    dist = distance.ComputedDistance(mode, Palette.NTSC, device=dev)
    levels = levels[:plan.n_ops]
    S = len(plan.step_frame)

    torch.cuda.synchronize()
    t0 = time.time()
    lanes_b, bytes_b = mesh.ingest_movies_batch(
        torch.as_tensor(src[:, :n_enc]).to(dev), mode, Palette.NTSC)
    torch.cuda.synchronize()
    t1 = time.time()
    launched = (editdist.dist_pairs_elementwise.launches
                + subop.sub_op_chain.launches)
    ops_b, main_b, aux_b = mesh.encode_movies_batch(
        dist, lanes_b, bytes_b, plan, mode, seeds=list(range(B)))
    torch.cuda.synchronize()
    t2 = time.time()
    launched = (editdist.dist_pairs_elementwise.launches
                + subop.sub_op_chain.launches) - launched
    flat_b = mesh.fetch_ops_compact(ops_b, plan)
    streams = [emit_stream_fast(flat_b[i], levels, mode) for i in range(B)]
    t3 = time.time()
    wall = t3 - t0
    movie_s = plan.n_ops / 14700.0
    main_np, aux_np = main_b.cpu().numpy(), aux_b.cpu().numpy()
    for i, data in enumerate(streams):
        check_vm(data, plan.n_ops, levels,
                 [("main", main_np[i]), ("aux", aux_np[i])],
                 "batch movie %d" % i)
    t4 = time.time()
    for i in (0, B - 1):
        solo, _, _ = encoder.encode_movie(dist, lanes_b[i], bytes_b[i],
                                          plan, mode, seed=i)
        solo = encoder.flatten_ops(solo.cpu().numpy(), plan)
        if not np.array_equal(solo, flat_b[i]):
            raise AssertionError("batch movie %d differs from its solo "
                                 "encode" % i)
    print("batch DHGR B=%d %gs k=16 j=4: n_ops=%d plan_steps=%d "
          "synth_s=%.3f ingest_s=%.3f encode_s=%.3f fetch_emit_s=%.3f "
          "total_s=%.3f realtime_x=%.3f counted_launches_per_step=%.3f "
          "vm_check_s=%.3f solo_check_s=%.3f; %d streams VM-valid, movies "
          "0 and %d equal their solo encodes"
          % (B, seconds, plan.n_ops, S, synth_s, t1 - t0, t2 - t1, t3 - t2,
             wall, B * movie_s / wall, launched / S, t4 - t3,
             time.time() - t4, B, B - 1))


def run_cli_mixed(dev):
    """The CLI's batch mode (k=16 j=4) on three .npz clips of 10, 6 and
    3 s with no audio track: each stream plays in the VM at its own op
    count, and the 3 s one (seed 2) equals its solo encode padded to the
    batch's plan."""
    import numpy as np

    from iivision_tpu import frames
    from iivision_tpu.palettes import Palette
    from iivision_tpu.stream.emit_fast import emit_stream_fast
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch import cli, encoder
    from iivision_tpu_torch.ops import distance

    import bench

    mode = VideoMode.DHGR
    lengths = (10.0, 6.0, 3.0)
    with tempfile.TemporaryDirectory() as tmp:
        clips = []
        for i, sec in enumerate(lengths):
            path = os.path.join(tmp, "clip%d.npz" % i)
            np.savez(path, frames=bench.synth_clip(seconds=sec, phase=i),
                     frame_rate=30.0)
            clips.append(path)
        out_dir = os.path.join(tmp, "out")
        stats = os.path.join(tmp, "stats.json")
        t0 = time.time()
        cli.main(clips + ["--device", str(dev), "--output", out_dir,
                          "--k", "16", "--j", "4", "--stats_json", stats])
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


def run_quality(dev):
    """tests/test_quality_regression.py on the card: the pinned 5 s clip
    through the port's Movie at k=16 j=4 (seed 0), default and joint
    content, replayed and scored by the port's quality module.  Each mean
    error is held to its committed baseline row (<= 1.01x; final error
    <= 1.02x + 0.05), and joint must beat the default rule's baseline."""
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch import encoder, quality
    from iivision_tpu_torch.movie import Movie

    import bench

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "quality_baseline.json")) as f:
        rows = json.load(f)["rows"]
    rgb = bench.synth_clip(seconds=5.0)
    means = {}
    for joint in (False, True):
        m = Movie(frames_source=rgb, audio_source=tone_levels(dev, 5.0),
                  every_n_video_frames=2, k=16, j=4, seed=0, device=dev,
                  video_mode=VideoMode.DHGR, joint_content=joint)
        flat, _ = m.encode_ops()
        lanes, _ = encoder.prepare_targets(
            m.frames.targets_main, m.frames.targets_aux, VideoMode.DHGR,
            dev)
        rep = quality.replay_frame_errors(flat, m.plan, lanes,
                                          VideoMode.DHGR, m.dist)
        name = "dhgr_ntsc_k16_j4_seed0" + ("_joint" if joint else "")
        row = rows[name]
        print("quality %s: mean_error=%.4f (baseline %.4f) final_error=%.4f "
              "(baseline %.4f) encode_s=%.3f" % (
                  name, rep.mean_error, row["mean_error"], rep.final_error,
                  row["final_error"], m.timings["encode_s"]))
        if rep.mean_error > row["mean_error"] * 1.01:
            raise AssertionError("%s mean error regressed" % name)
        if rep.final_error > row["final_error"] * 1.02 + 0.05:
            raise AssertionError("%s final error regressed" % name)
        means[joint] = rep.mean_error
    if not means[True] < rows["dhgr_ntsc_k16_j4_seed0"]["mean_error"]:
        raise AssertionError("joint content no longer beats the default "
                             "rule")


def trace_encodes(dev, seconds: float = 1.0, B: int = 32):
    """torch.profiler over two 1 s DHGR encodes at k=16 j=4, solo and a
    batch of B, on ingested targets: device busy share (kernel time over
    encode wall), kernel launches per plan step, and the device kernels
    that launch most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.parallel import mesh

    mode = VideoMode.DHGR
    src = torch.as_tensor(synth_clips(B, seconds, every_n=2)).to(dev)
    lanes_b, bytes_b = mesh.ingest_movies_batch(src, mode, Palette.NTSC)
    plan, _ = encoder.plan_movie(
        n_frames=int(seconds * 30), n_audio_ticks=int(seconds * 14700),
        input_frame_rate=30.0, ticks_per_second=14700.0,
        every_n_video_frames=2, mode=mode, k=16, j=4)
    dist = distance.ComputedDistance(mode, Palette.NTSC, device=dev)
    S = len(plan.step_frame)
    for tag, nb in (("solo", 1), ("batch", B)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            encoder.encode_movies(dist, lanes_b[:nb], bytes_b[:nb], plan,
                                  mode, list(range(nb)))
            torch.cuda.synchronize()
            wall = time.time() - t0
        dev_us, kernels, by_name = 0.0, 0, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(e, "device_time", None)
                t = e.cuda_time if t is None else t
                dev_us += t
                kernels += 1
                n, us = by_name.get(e.name[:60], (0, 0.0))
                by_name[e.name[:60]] = (n + 1, us + t)
        launches = sum(1 for e in prof.events() if e.name in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        print("trace %s B=%d %gs k=16 j=4: plan_steps=%d encode_s=%.3f "
              "device_kernel_s=%.4f busy_share=%.4f device_kernels=%d "
              "launches=%d launches_per_step=%.2f" % (
                  tag, nb, seconds, S, wall, dev_us / 1e6,
                  dev_us / 1e6 / wall, kernels, launches, launches / S))
        for name, (n, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
            print("  %s kernel %s: per_step=%.2f device_ms=%.3f" % (
                tag, name, n / S, us / 1e3))


def build_and_check_lut(dev):
    """The LUT entry point: the full DHGR NTSC 4 x 8192^2 uint16 table
    through kernel A, then its checks."""
    tables, codes, sub = build_lut(dev)
    check_lut(dev, tables, codes, sub)


def check_lut(dev, tables, codes, sub):
    """Symmetry on sampled blocks, zero diagonal, 64 sampled rows against
    plain on the card, 20 cells against the scalar Damerau-Levenshtein."""
    import numpy as np
    import torch

    from iivision_tpu_torch.ops import editdist

    n = codes[0].shape[0]
    full = tables.view(torch.int16).view(len(codes), n, n)
    rng = np.random.RandomState(5)
    diag = torch.arange(n, device=dev)
    for lane in range(len(codes)):
        t = full[lane]
        if int(t[diag, diag].abs().max()) != 0:
            raise AssertionError("lane %d: non-zero diagonal" % lane)
        for _ in range(4):
            r0, c0 = rng.randint(0, n - 256, 2)
            blk = t[r0:r0 + 256, c0:c0 + 256]
            tr = t[c0:c0 + 256, r0:r0 + 256].T
            if not torch.equal(blk, tr):
                raise AssertionError("lane %d: not symmetric" % lane)
    rows = torch.as_tensor(rng.randint(0, n, 64), device=dev)
    worst = 0
    for lane in range(len(codes)):
        want = editdist.dp_distance_tile(codes[lane][rows[lane::4]],
                                         codes[lane], sub)
        if int(want.max()) >= 1 << 16:
            raise AssertionError("distances overflow uint16")
        got = full[lane][rows[lane::4]].to(torch.int32) & 0xFFFF
        worst = max(worst, int((got - want).abs().max()))
    sub_np = sub.cpu().numpy()
    for _ in range(20):
        lane, i, jx = rng.randint(0, len(codes)), *rng.randint(0, n, 2)
        cn = codes[lane].cpu().numpy()
        want = editdist.dam_lev_scalar(list(cn[i]), list(cn[jx]), sub_np)
        got = int(full[lane, i, jx]) & 0xFFFF
        if want != got:
            raise AssertionError("cell (%d, %d, %d): %d vs scalar %s" % (
                lane, i, jx, got, want))
    print("LUT checks: symmetric, zero diagonal, 64 rows vs plain "
          "max_abs_err=%d, 20 cells vs dam_lev_scalar equal" % worst)
    if worst:
        raise AssertionError("LUT rows disagree with plain")


if __name__ == "__main__":
    sys.exit(main())
