"""Smoke run of iivision_tpu_torch on one CUDA card.

    python3 chip_smoke.py

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
- the chunk-start kernel: DHGR (both banks) and HGR, window, mono and yiq
  bases, B = 1 and 32;
- the body kernel's threefry (B = 32 keys, steps up to 2^20, four
  sub-ops);
- the body kernel, default and joint content, on real plan bodies with
  padded steps and a partial step (DHGR k=8 j=1 and k=16 j=4, HGR k=8 j=1
  with its 256 contents, B = 1 and 32, seeded and deterministic), on
  tie-heavy bodies whose every page and offset choice falls to the nonces,
  and for joint content on bodies whose contents tie (dw all zero, or one
  cost for every content);
- kernel B (solo DHGR at both encoder settings, solo HGR, a case where
  offset 0 is the only companion, batches of 32 DHGR and 8 HGR movies),
  kernel B's joint variant (DHGR and HGR at k=16 j=4, and a crafted page
  where a non-target content wins) - the card-side per-step reference,
  which no path launches - and kernel C (the sub-op microbenchmark at
  512 and 509 rows, T = 0, 1 and 100, with crafted rows).
Each kernel's device time is the mean of many back-to-back launches
between one event pair, queued behind a sleep so that the host's wrapper
time stays outside the pair.
It reproduces the JAX package's golden stream, then drives each entry
point of the port with the launch counts set to 0 before it and read
after it:

- 10 s DHGR clips at (k=8, j=1) and (k=16, j=4), and a 10 s HGR clip at
  (k=8, j=1), through Movie.transcode and the player VM;
- the full DHGR NTSC LUT (make_tables' path);
- the sub-op microbenchmark's T sweep (bench_subop.run);
- 2 s clips in the yiq colour model (DHGR and HGR: the chunk-start
  kernel's yiq instantiation) and the mono model (HGR); the mono clip
  builds its store-cost table on the card, and sampled rows of that table
  are held against the plain build;
- the batch transcode: 32 distinct 10 s clips (`synth_clip`, one phase
  each) through ingest_movies_batch, encode_movies_batch at k=16 j=4,
  fetch_ops_compact and emit; every stream through the player VM, and
  movies 0 and 31 byte-equal to their solo encodes;
- the CLI's batch mode on three .npz clips of 10, 6 and 3 s: every stream
  plays at its own length, and the shortest equals its padded solo encode;
- the 5 s quality clip of tests/test_quality_regression.py at k=16 j=4,
  with and without joint content (the body kernel's joint
  instantiation), replayed and scored on the card: each mean error within
  1.01x of tests/data/quality_baseline.json, and joint below the default
  rule's baseline.
Kernel B launching on any path fails the run.

A last, uncounted phase traces 1 s clips with torch.profiler (solo and a
batch of 32 at k=16 j=4, solo at k=8 j=1, solo joint at k=16 j=4): device
busy share, kernel launches per plan step and the kernels that launch
most, and holds kernel B's and the body kernel's timer figures against
the profiler's.

Every phase prints one line of numbers; any failure raises, giving a
non-zero exit.  The last two lines are the kernel report and the device
line, both JSON.  Needs one CUDA card; without one it exits non-zero
before printing any result.  Imports nothing of JAX nor of the JAX
package.  Store-cost tables it builds go to a temporary cache directory
that is removed at exit.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

GOLDEN_SHA = "57fdd52adf53d75101ed121d28d8a5389465c09f99d960ba6c47c20dbdb30fbc"

# H100 SXM peaks: HBM bytes/s and float32 outside the tensor cores (NVIDIA's
# data sheet), and int32 for the integer kernels (the chunk-start diff):
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# kernel -> (wrapper module, wrapper name, the wrapper's launch counter,
# source, the TPU or JAX function it replaces)
KERNELS = {
    "chunk_start": ("chunk_start", "chunk_start", "launches",
                    "iivision_tpu_torch/csrc/chunk_start.cu",
                    "iivision_tpu/encoder.py:540"),
    "chunk_start_yiq": ("chunk_start", "chunk_start", "yiq_launches",
                        "iivision_tpu_torch/csrc/chunk_start.cu",
                        "iivision_tpu/encoder.py:374"),
    "encode_body": ("body", "encode_body", "launches",
                    "iivision_tpu_torch/csrc/body.cu",
                    "iivision_tpu/encoder.py:567"),
    "encode_body_joint": ("body", "encode_body", "joint_launches",
                          "iivision_tpu_torch/csrc/body.cu",
                          "iivision_tpu/encoder.py:583"),
    "threefry_uniform": ("body", "threefry_uniform", "launches",
                         "iivision_tpu_torch/csrc/body.cu",
                         "iivision_tpu/encoder.py:695"),
    "editdist_tile": ("editdist", "pair_distance", "launches",
                      "iivision_tpu_torch/csrc/editdist.cu",
                      "iivision_tpu/ops/editdist.py:232"),
    "lane_dist": ("editdist", "lane_distance", "launches",
                  "iivision_tpu_torch/csrc/editdist.cu",
                  "iivision_tpu/ops/distance.py:150"),
    "dist_pairs": ("editdist", "dist_pairs_elementwise", "launches",
                   "iivision_tpu_torch/csrc/editdist.cu",
                   "iivision_tpu/ops/distance.py:72"),
    "subop_chain": ("subop", "sub_op_chain", "launches",
                    "iivision_tpu_torch/csrc/subop.cu",
                    "iivision_tpu/encoder.py:567"),
    "subop_chain_joint": ("subop", "sub_op_chain_joint", "launches",
                          "iivision_tpu_torch/csrc/subop.cu",
                          "iivision_tpu/encoder.py:583"),
    "subop_bench": ("subop_bench", "run_kernel", "launches",
                    "iivision_tpu_torch/csrc/subop_bench.cu",
                    "tools/bench_subop_pallas.py:183"),
}
# kernel B: the card-side per-step reference; no path may launch it
REFERENCE_ONLY = ("subop_chain", "subop_chain_joint")


def wrapper(name):
    import importlib

    mod, fn = KERNELS[name][:2]
    return getattr(importlib.import_module("iivision_tpu_torch.ops." + mod),
                   fn)


def launch_count(name) -> int:
    return getattr(wrapper(name), KERNELS[name][2])


def counted(path, want, fn, *args, **kw):
    """Run one path with every launch count at 0; fail unless each kernel
    in `want` launched, and if kernel B did.  Returns (fn's result,
    {kernel: launches})."""
    for name in KERNELS:
        setattr(wrapper(name), KERNELS[name][2], 0)
    t0 = time.time()
    out = fn(*args, **kw)
    launches = {name: launch_count(name) for name in KERNELS}
    print("launches %s: %s path_s=%.1f" % (path, json.dumps(launches),
                                            time.time() - t0))
    for name in want:
        if launches[name] == 0:
            raise AssertionError("kernel %s never launched on path %s"
                                 % (name, path))
    for name in REFERENCE_ONLY:
        if launches[name]:
            raise AssertionError("kernel %s launched on path %s"
                                 % (name, path))
    return out, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from iivision_tpu_torch import _build, bench_subop
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
    check_kernel_a(dev, report)
    check_lane_dist(dev, report)
    check_chunk_start(dev, report)
    check_threefry(dev, report)
    check_body(dev, report)
    check_body(dev, report, joint=True)
    check_kernel_b(dev, report)
    check_kernel_b_joint(dev, report)
    check_kernel_c(dev, report)
    check_golden(dev)
    print("kernel checks done at %.1f s" % (time.time() - t_start))

    # -- 3. the port's paths, each counted --------------------------------
    dhgr, hgr = VideoMode.DHGR, VideoMode.HGR
    enc = ("chunk_start", "encode_body")
    yiq = ("chunk_start_yiq", "encode_body")
    totals = {name: 0 for name in KERNELS}
    with tempfile.TemporaryDirectory() as cache:
        os.environ["XDG_CACHE_HOME"] = cache
        for path, want, fn, args, kw in (
                ("dhgr_10s_k8_j1", enc, run_movie, (dev, dhgr, 8, 1, 10), {}),
                ("dhgr_10s_k16_j4", enc, run_movie, (dev, dhgr, 16, 4, 10),
                 {}),
                ("hgr_10s_k8_j1", enc, run_movie, (dev, hgr, 8, 1, 10), {}),
                ("lut_dhgr_ntsc", ("editdist_tile",), build_and_check_lut,
                 (dev,), {}),
                ("bench_subop", ("subop_bench",), run_bench,
                 (dev, bench_subop, report), {}),
                ("dhgr_2s_yiq", yiq, run_movie, (dev, dhgr, 8, 1, 2),
                 dict(colour_model="yiq")),
                ("hgr_2s_yiq", yiq, run_movie, (dev, hgr, 8, 1, 2),
                 dict(colour_model="yiq")),
                ("hgr_2s_mono", enc + ("lane_dist",), run_mono, (dev, hgr),
                 {}),
                ("batch_dhgr_b32_10s_k16_j4", enc, run_batch, (dev,), {}),
                ("batch_cli_mixed", enc, run_cli_mixed, (dev,), {}),
                ("quality_dhgr_5s_k16_j4",
                 enc + ("lane_dist", "encode_body_joint"), run_quality,
                 (dev,), {})):
            _, launches = counted(path, want, fn, *args, **kw)
            for name, n in launches.items():
                totals[name] += n
        del os.environ["XDG_CACHE_HOME"]
    print("main path launches: %s" % json.dumps(totals))
    t0 = time.time()
    trace_encodes(dev, report)
    print("trace_s=%.1f" % (time.time() - t0))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = []
    for name, (_, _, _, src, replaces) in KERNELS.items():
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=totals[name])
        entry.update((k, report[name][k]) for k in keys)
        # no single PyTorch call computes any of these functions
        entry["library_ms"] = None
        kernels.append(entry)
    print("wall_s=%.1f" % (time.time() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bound(nbytes: float, ops: float = 0.0, int_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the card's rate for their type
    (`ops` float32 outside the tensor cores, `int_ops` int32)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S + int_ops / INT32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def synth_clip(seconds=10.0, fps=30, w=280, h=192, phase=0.0):
    """A moving RGB pattern, (seconds * fps, h, w, 3) uint8 (the JAX
    benchmark's bench.synth_clip)."""
    import numpy as np

    F = int(seconds * fps)
    t = np.linspace(0, 1, F, dtype=np.float32)[:, None, None]
    yy = np.linspace(0, 1, h, dtype=np.float32)[None, :, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, None, :]
    shape = (F, h, w)
    r = np.broadcast_to(127.5 + 127.5 * np.sin(7 * (xx + 2 * t) + phase),
                        shape)
    g = np.broadcast_to(255 * np.abs(np.sin(3 * (yy + t) + phase)), shape)
    b = np.broadcast_to(127.5 + 127.5 * np.cos(5 * (xx + yy + t) + phase),
                        shape)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


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


def check_chunk_start(dev, report):
    """The chunk-start kernel against chunk_start_plain, bit-equal up and
    dw: DHGR (both banks) and HGR, window and mono bases, B = 1 and 32, and
    the yiq instantiation (its own entry): DHGR banks 0 and 1 and HGR, B = 1
    and 32; on seeded random banks (8-bit bytes), targets and state."""
    import numpy as np
    import torch

    from iivision_tpu_torch.ops import chunk_start, distance
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.screen import spec_for_mode
    from iivision_tpu_torch.video_mode import VideoMode

    D, H = VideoMode.DHGR, VideoMode.HGR
    report["chunk_start"] = dict(max_abs_err=0)
    report["chunk_start_yiq"] = dict(max_abs_err=0)
    for i, (mode, model, B, bank, tag) in enumerate((
            (D, "window", 1, 0, ""), (D, "window", 1, 1, "_aux"),
            (D, "mono", 32, 1, "_mono_b32"), (D, "window", 32, 0, "_b32"),
            (H, "window", 1, 0, "_hgr"), (H, "mono", 32, 0, "_hgr_mono_b32"),
            (D, "yiq", 1, 0, ""), (D, "yiq", 1, 1, "_aux"),
            (D, "yiq", 32, 1, "_aux_b32"), (D, "yiq", 32, 0, "_b32"),
            (H, "yiq", 1, 0, "_hgr"), (H, "yiq", 32, 0, "_hgr_b32"))):
        entry = report["chunk_start_yiq" if model == "yiq" else "chunk_start"]
        rng = np.random.RandomState(i + 11)
        nb = chunk_start.n_banks(mode)
        F, frame = 3, 1
        banks = random_state(dev, rng, (B, nb, 32, 256), 256)
        tgt = random_state(dev, rng, (B * F, nb, 32, 256), 256)
        lanes = chunk_start.masked_lanes(tgt, mode).reshape(
            (B, F, 32, 128, -1)).contiguous()
        up0 = random_state(dev, rng, (B, nb, 32, 256), 5000)
        dw0 = random_state(dev, rng, (B, nb, 32, 256), 900)
        sub = torch.as_tensor(distance.sub_for(mode, Palette.NTSC, model)
                              .astype(np.int32), device=dev)
        got = [up0.clone(), dw0.clone()]
        want = [up0.clone(), dw0.clone()]
        chunk_start.chunk_start(banks, lanes, frame, bank, sub, *got, mode)
        chunk_start.chunk_start_plain(banks, lanes, frame, bank, sub, *want,
                                      mode)
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("chunk-start kernel (%s %s) disagrees with "
                                 "plain" % (model, tag or "DHGR"))
        state = [up0.clone(), dw0.clone()]
        ms = cuda_ms(lambda: chunk_start.chunk_start(
            banks, lanes, frame, bank, sub, *state, mode), 200)
        plain_ms = cuda_ms(lambda: chunk_start.chunk_start_plain(
            banks, lanes, frame, bank, sub, *state, mode), 3)
        # bytes: every bank row, the bank's two target lanes, up read and
        # written, dw written, the cost basis (for yiq the window costs the
        # offsets index, at most one int32 per offset and window)
        nbytes = B * (nb * 8192 * 4 + 8192 * 4 + 3 * 8192 * 4)
        nbytes += (min(sub.numel(), B * 8192 * sub.shape[1]) * 4
                   if model == "yiq" else 1024)
        # int32 operations at the 240 offsets of a page that are not
        # holes: one add per yiq window, or an add, two compares and a min
        # per DP step
        int_ops = B * 32 * 240 * (sub.shape[1] if model == "yiq"
                                  else 4 * spec_for_mode(mode).MASKED_DOTS)
        bnd = bound(nbytes, int_ops=int_ops)
        print("chunk_start %s %s B=%d bank=%d: max_abs_err=%d ms=%.4f "
              "plain_ms=%.4f bound_ms=%.5f (%s)" % (
                  mode.name, model, B, bank, err, ms, plain_ms,
                  bnd["bound_ms"], bnd["bound_by"]))
        entry["ms" + tag] = ms
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
    0) and a partial one (0 < nvalid < k * j)."""
    Sc, full = plan.chunk_steps, plan.k * plan.j
    for b0 in range(0, len(plan.step_nvalid), Sc):
        nv = plan.step_nvalid[b0:b0 + Sc]
        if (nv == 0).any() and ((nv > 0) & (nv < full)).any():
            return b0
    raise AssertionError("no body with padded and partial steps")


def body_inputs(dev, mode, k: int, j: int, B: int, seed: int,
                tie: bool = False):
    """A real plan's body (1 s at 30 fps, every 2nd frame) with seeded
    random targets and state for B movies.  tie: every up equal, so each
    page and offset choice falls to the nonces."""
    import numpy as np
    import torch

    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import chunk_start, distance
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
    dist = distance.ComputedDistance(mode, Palette.NTSC, device=dev)
    table = dist.store_cost16.reshape(-1, dist.n_contents)
    S = len(plan.step_frame)
    ops = torch.full((S, B, j, k, 6), 7, dtype=torch.uint8, device=dev)
    nvalid = torch.tensor(plan.step_nvalid, dtype=torch.int32, device=dev)
    return plan, b0, state, lanes, bytes_tgt, table, nvalid, ops


def check_body(dev, report, joint: bool = False):
    """The body kernel against encode_body_plain (the per-step torch loop
    with the plain sub-op chain and step_nonces), state and records
    bit-equal, on real plan bodies that hold padded and partial steps:
    DHGR k=8 j=1 and k=16 j=4, HGR k=8 j=1 (256 contents), B = 1 and 32,
    seeded and deterministic, and tie-heavy bodies (every up equal).
    joint: the kernel's joint instantiation (its own entry), timed at DHGR
    k=16 j=4 (the quality clip's setting) B = 1 and 32 and on HGR, plus
    bodies whose contents tie: dw all zero (no companion gain: the
    cheapest contents at the primary tie) and one cost for every content
    (every content ties)."""
    import torch

    from iivision_tpu_torch.ops import body
    from iivision_tpu_torch.ops import random as trandom
    from iivision_tpu_torch.video_mode import VideoMode

    D, H = VideoMode.DHGR, VideoMode.HGR
    name = "encode_body_joint" if joint else "encode_body"
    entry = report[name] = dict(max_abs_err=0)
    cases = ((D, 16, 4, 1, True, None, ""),
             (D, 16, 4, 1, False, None, "_det"),
             (D, 16, 4, 32, True, None, "_b32"),
             (D, 8, 1, 1, True, None, "_k8_j1"),
             (D, 8, 1, 32, False, None, "_k8_j1_b32_det"),
             (H, 8, 1, 1, True, None, "_hgr"),
             (H, 8, 1, 32, True, None, "_hgr_b32"),
             (D, 16, 4, 32, True, "tie", "_tie_b32"),
             (D, 16, 4, 1, True, "zero_dw", "_zero_dw"),
             (H, 8, 1, 1, False, "one_cost", "_one_cost_hgr")) if joint else (
        (D, 8, 1, 1, True, None, ""),
        (D, 8, 1, 1, False, None, "_det"),
        (D, 16, 4, 1, True, None, "_k16_j4"),
        (D, 16, 4, 32, True, None, "_b32_k16_j4"),
        (D, 16, 4, 32, False, None, "_b32_k16_j4_det"),
        (H, 8, 1, 1, True, None, "_hgr"),
        (H, 8, 1, 32, True, None, "_hgr_b32"),
        (D, 8, 1, 32, True, "tie", "_tie_b32"),
        (D, 16, 4, 32, True, "tie", "_tie_b32_k16_j4"),
        (H, 8, 1, 1, False, "tie", "_tie_hgr_det"))
    for mode, k, j, B, seeded, kind, tag in cases:
        plan, b0, state, lanes, bytes_tgt, table, nvalid, ops = body_inputs(
            dev, mode, k, j, B, 50 + len(entry) + 100 * joint, kind == "tie")
        if kind == "zero_dw":
            state[1].zero_()
        elif kind == "one_cost":
            table = torch.full_like(table, 100)
        Sc = plan.chunk_steps
        frame, bank = int(plan.step_frame[b0]), int(plan.step_bank[b0])
        keys = trandom.key_words(range(B), dev) if seeded else None
        got = [x.clone() for x in state] + [ops.clone()]
        want = [x.clone() for x in state] + [ops.clone()]
        body.encode_body(*got[:3], lanes, bytes_tgt, frame, bank, table,
                         keys, nvalid, b0, Sc, got[3], mode, joint)
        body.encode_body_plain(*want[:3], lanes, bytes_tgt, frame, bank,
                               table, keys, nvalid, b0, Sc, want[3], mode,
                               joint)
        torch.cuda.synchronize()
        err = max(int((g.int() - w.int()).abs().max())
                  for g, w in zip(got, want))
        if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if not torch.equal(g, w)]
            raise AssertionError("%s kernel (%s) disagrees with plain in %s "
                                 "(up, dw, banks, ops)" % (
                                     name, tag or mode.name, bad))
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
        run = int((nv > 0).sum())
        C = table.shape[1]
        # bytes per movie: up, dw and the bank bytes read and written, the
        # target bytes and the bank's two target lanes, one table read per
        # offset per sub-op run, the body's records; joint content adds the
        # bank's table rows (each read once) and, per offset and content of
        # every sub-op run, a float subtract and compare
        nbytes = B * (3 * 2 * 8192 * 4 + 2 * 8192 * 4
                      + run * k * j * 256 * 2 + Sc * k * j * 6)
        ops_f = 0.0
        if joint:
            nbytes += B * 8192 * C * 2
            ops_f = 2.0 * B * run * k * j * 256 * C
        bnd = bound(nbytes, ops_f)
        print("%s %s k=%d j=%d B=%d seeded=%s %s steps=%d nvalid=%s: "
              "max_abs_err=%d ms=%.4f plain_ms=%.4f bound_ms=%.5f (%s)" % (
                  name, mode.name, k, j, B, seeded, kind or "", Sc,
                  nv.tolist(), err, ms, plain_ms, bnd["bound_ms"],
                  bnd["bound_by"]))
        entry["ms" + tag] = ms
        entry["plain_ms" + tag] = plain_ms
        if not tag:
            entry.update(bnd)


def subop_inputs(dev, mode, k: int, j: int, seed: int, B: int = 1):
    """Seeded kernel B inputs for B movies at the encoder's shapes for
    `mode`: page rows, table rows on the main bank's lanes, the real NTSC
    window store-cost table (DHGR: 4 x 8192 x 128, HGR: 2 x 16384 x 256),
    and per-movie nonces, pages and padding bytes."""
    import numpy as np
    import torch

    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.screen import spec_for_mode
    from iivision_tpu_torch.video_mode import VideoMode

    rng = np.random.RandomState(seed)
    table16 = torch.as_tensor(
        distance.store_cost_table(mode, Palette.NTSC, "window", dev),
        device=dev)
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
    and records bit-equal), then both timed; records ms, plain_ms and
    wrapper_ms (wrapper + launch, the smoke's earlier timer) under `tag` in
    `entry`, and the bound of the untagged shape."""
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
    w_ms = wrapper_ms(lambda r: chain(r, sc_rows, table, nonce, pages,
                                      nvalid, pad, out_k), reps,
                      setup=lambda: (rows.clone(),))
    plain_ms = cuda_ms(lambda r: subop.sub_op_chain_plain(
        r, sc_rows, table, nonce, pages, nvalid, pad, out_p, joint),
        3, setup=lambda: (rows.clone(),))
    C = table.shape[1]
    # rows read (4) and written (3), table rows, one table read per offset
    # per sub-op (and every content for joint), nonces, records
    nbytes = B * k * (7 * 256 * 4 + 256 * 4 + j * 256 * 2 * (
        C + 1 if joint else 1) + j * 6 + 8) + B * 4
    if nonce is not None:
        nbytes += nonce.numel() * 4
    print("kernel B%s B=%d C=%d k=%d j=%d: max_abs_err=%g ms=%.4f "
          "wrapper_ms=%.4f plain_ms=%.4f bound_ms=%.5f" % (
              " joint" if joint else "", B, C, k, j, err, ms, w_ms, plain_ms,
              bound(nbytes)["bound_ms"]))
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["ms" + tag] = ms
    entry["wrapper_ms" + tag] = w_ms
    entry["plain_ms" + tag] = plain_ms
    if not tag:
        entry.update(bound(nbytes))
    return rows_k, out_k


def check_kernel_b(dev, report):
    """Kernel B against its plain version, rows and records bit-equal:
    solo (B = 1) on DHGR at (k=8, j=1) and (k=16, j=4) and on HGR (C = 256)
    at (k=8, j=1); batches of 32 DHGR movies at (16, 4) and 8 HGR movies at
    (8, 1), each movie with its own pages, nonces and padding byte."""
    import torch

    from iivision_tpu_torch.ops import subop
    from iivision_tpu_torch.video_mode import VideoMode

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

    from iivision_tpu_torch.video_mode import VideoMode

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


def check_golden(dev):
    """The JAX package's pinned stream (tests/test_stream.py), encoded on
    the card through the chunk-start and body kernels."""
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


def build_lut(dev):
    """The LUT entry point: the full DHGR NTSC 4 x 8192^2 uint16 table
    through kernel A."""
    import torch

    from iivision_tpu_torch.ops import editdist
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

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

    from scipy.io import wavfile

    from iivision_tpu_torch.movie import Movie
    from iivision_tpu_torch.video_mode import VideoMode

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
    builds one on the card (kernel A's lane distance, HGR) into the
    empty temporary cache; 64 sampled rows of the table the clip encoded
    with are then held against the plain build on the CPU."""
    import numpy as np
    import torch

    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.palettes import Palette

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


def run_batch(dev, B: int = 32, seconds: float = 10.0):
    """The batch transcode at the JAX benchmark's headline setting: B
    distinct synthetic 280x192 clips (every 2nd frame), device ingest,
    one lockstep encode at k=16 j=4 with seeds 0..B-1, compact fetch and
    emit.  Every stream plays in the player VM; movies 0 and B-1 equal
    their solo encodes byte for byte."""
    import numpy as np
    import torch

    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import body, chunk_start, distance
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.parallel import mesh
    from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
    from iivision_tpu_torch.video_mode import VideoMode

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
    launched = chunk_start.chunk_start.launches + body.encode_body.launches
    ops_b, main_b, aux_b = mesh.encode_movies_batch(
        dist, lanes_b, bytes_b, plan, mode, seeds=list(range(B)))
    torch.cuda.synchronize()
    t2 = time.time()
    launched = (chunk_start.chunk_start.launches
                + body.encode_body.launches) - launched
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
    from iivision_tpu_torch import encoder, quality
    from iivision_tpu_torch.movie import Movie
    from iivision_tpu_torch.video_mode import VideoMode

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "quality_baseline.json")) as f:
        rows = json.load(f)["rows"]
    rgb = synth_clip(seconds=5.0)
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
    profiler's per-launch device time of the body kernel and of kernel B
    (50 launches at the DHGR k=8 j=1 shape) beside the event timer's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from iivision_tpu_torch import encoder
    from iivision_tpu_torch.ops import distance, subop
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
    if body_us is not None:
        print("encode_body DHGR k=8 j=1 B=1: profiler us_per_launch=%.2f "
              "(a whole clip's bodies) against the event timer's %.2f us "
              "(one body, repeated)" % (body_us,
                                        report["encode_body"]["ms"] * 1e3))

    rows, sc_rows, table, nonce, pages, pad = subop_inputs(
        dev, mode, 8, 1, 19)
    out = torch.empty((1, 1, 8, 6), dtype=torch.uint8, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            subop.sub_op_chain(rows, sc_rows, table, nonce, pages, 5, pad,
                               out)
        torch.cuda.synchronize()
    by_name, _ = profiled_kernels(prof)
    n, us = sum(v[0] for k_, v in by_name.items() if "subop_chain" in k_), \
        sum(v[1] for k_, v in by_name.items() if "subop_chain" in k_)
    entry = report["subop_chain"]
    entry["profiler_ms"] = us / max(n, 1) / 1e3
    print("kernel B DHGR k=8 j=1 B=1: profiler device_ms=%.4f (%d launches) "
          "event timer ms=%.4f wrapper_ms=%.4f" % (
              entry["profiler_ms"], n, entry["ms"], entry["wrapper_ms"]))


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
