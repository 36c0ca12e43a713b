"""Smoke run of iivision_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc and checks each against
its plain torch version on the card: kernel A (all pairs, and elementwise
at L = 10 and 18), kernel B (DHGR at both encoder settings, HGR with its
256 contents, and a case where offset 0 is the only companion) and
kernel C (the sub-op microbenchmark at B=32, K=16, T=100).
It reproduces the JAX package's golden stream, then drives each entry
point of the port with the launch counts set to 0 before it and read
after it:

- 10 s DHGR clips at (k=8, j=1) and (k=16, j=4), and a 10 s HGR clip at
  (k=8, j=1), through Movie.transcode and the player VM;
- the full DHGR NTSC LUT (make_tables' path);
- the sub-op microbenchmark's T sweep (bench_subop.run);
- 2 s clips in the yiq (DHGR) and mono (HGR) colour models; the mono clip
  builds its store-cost table on the card, and sampled rows of that table
  are held against the plain build.

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
    out = fn(*args, **kw)
    launches = {name: wrapper(name).launches for name in KERNELS}
    print("launches %s: %s" % (path, json.dumps(launches)))
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
    check_kernel_c(dev, report)
    check_golden(dev)

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
                 (dev, hgr), {})):
            _, launches = counted(path, want, fn, *args, **kw)
            for name, n in launches.items():
                totals[name] += n
        del os.environ["XDG_CACHE_HOME"]
    print("main path launches: %s" % json.dumps(totals))

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


def subop_inputs(dev, mode, k: int, j: int, seed: int):
    """Seeded kernel B inputs at the encoder's shapes for `mode`: page
    rows, table rows on the main bank's lanes, the real NTSC window
    store-cost table (DHGR: 4 x 8192 x 128, HGR: 2 x 16384 x 256), nonces
    and pages."""
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
    up = rng.randint(0, 3000, (k, 256)) * (rng.rand(k, 256) < 0.6)
    up[0] = 0  # one idle page: its sub-ops are padding
    dw = rng.randint(0, 900, (k, 256))
    # screen bytes: 7 bits in DHGR, 8 (palette bit included) in HGR
    by = rng.randint(0, 128 if mode == VideoMode.DHGR else 256, (k, 256))
    tb = rng.randint(0, 256, (k, 256))
    rows = torch.as_tensor(np.stack([up, dw, by, tb], axis=1),
                           dtype=torch.float32, device=dev)
    le, lo = spec_for_mode(mode).bank_lanes(False)
    lane = np.where(np.arange(256) % 2 == 0, le, lo)[None, :]
    sc_rows = torch.as_tensor(lane * R + rng.randint(0, R, (k, 256)),
                              dtype=torch.int32, device=dev)
    nonce = torch.as_tensor(rng.rand(j, k, 256), dtype=torch.float32,
                            device=dev)
    pages = torch.as_tensor(rng.permutation(32)[:k], dtype=torch.int64,
                            device=dev)
    return rows, sc_rows, table16.reshape(-1, C), nonce, pages


def check_kernel_b(dev, report):
    """Kernel B against its plain version on DHGR at (k=8, j=1) and
    (k=16, j=4), and on HGR (C = 256) at (k=8, j=1): rows and records
    bit-equal."""
    import torch

    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch.ops import subop

    # the DHGR CLI default (k=8, j=1) gives ms / plain_ms; the other
    # settings are reported beside it
    entry = report["subop_chain"] = dict(max_abs_err=0.0)
    for mode, k, j, seed, tag in ((VideoMode.DHGR, 8, 1, 19, ""),
                                  (VideoMode.DHGR, 16, 4, 27, "_k16_j4"),
                                  (VideoMode.HGR, 8, 1, 31, "_hgr")):
        rows, sc_rows, table, nonce, pages = subop_inputs(dev, mode, k, j,
                                                          seed)
        nvalid = k * j - 3
        out_k = torch.empty((j, k, 6), dtype=torch.uint8, device=dev)
        out_p = torch.empty_like(out_k)
        rows_k, rows_p = rows.clone(), rows.clone()
        subop.sub_op_chain(rows_k, sc_rows, table, nonce, pages, nvalid, 17,
                           out_k)
        subop.sub_op_chain_plain(rows_p, sc_rows, table, nonce, pages,
                                 nvalid, 17, out_p)
        torch.cuda.synchronize()
        err = max(float((rows_k - rows_p).abs().max()),
                  float((out_k.int() - out_p.int()).abs().max()))
        if not (torch.equal(rows_k, rows_p) and torch.equal(out_k, out_p)):
            raise AssertionError("kernel B (%s, k=%d, j=%d) disagrees with "
                                 "plain" % (mode.name, k, j))
        ms = cuda_ms(lambda r: subop.sub_op_chain(
            r, sc_rows, table, nonce, pages, nvalid, 17, out_k), 200,
            setup=lambda: (rows.clone(),))
        plain_ms = cuda_ms(lambda r: subop.sub_op_chain_plain(
            r, sc_rows, table, nonce, pages, nvalid, 17, out_p), 50,
            setup=lambda: (rows.clone(),))
        print("kernel B %s C=%d k=%d j=%d: max_abs_err=%g ms=%.4f "
              "plain_ms=%.4f" % (mode.name, table.shape[1], k, j, err, ms,
                                 plain_ms))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms" + tag] = ms
        entry["plain_ms" + tag] = plain_ms

    # offset 0 is each page's only companion: the later rounds find nothing
    # and come back to offset 0, which must stay stored
    k = 2
    rows = torch.zeros((k, 4, 256), dtype=torch.float32, device=dev)
    rows[:, 0, 10], rows[:, 0, 0] = 1000.0, 500.0
    rows[:, 1, 10], rows[:, 1, 0] = 900.0, 800.0
    rows[:, 3, 10] = 5.0
    args = (torch.zeros((k, 256), dtype=torch.int32, device=dev),
            torch.zeros((1, 128), dtype=torch.int16, device=dev), None,
            torch.tensor([3, 7], dtype=torch.int64, device=dev), k, 0)
    outs = [torch.empty((1, k, 6), dtype=torch.uint8, device=dev)
            for _ in range(2)]
    got, want = rows.clone(), rows.clone()
    subop.sub_op_chain(got, *args, outs[0])
    subop.sub_op_chain_plain(want, *args, outs[1])
    torch.cuda.synchronize()
    print("kernel B offset-0 companion: up[0]=%g by[0]=%g (plain %g, %g)" % (
        got[0, 0, 0], got[0, 2, 0], want[0, 0, 0], want[0, 2, 0]))
    if not (torch.equal(got, want) and torch.equal(*outs)):
        raise AssertionError("kernel B drops an offset-0 companion")


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

    from iivision_tpu.sim import PlayerVM
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
    res = PlayerVM().decode(data)
    if not res.ok:
        raise AssertionError("player VM rejects the stream: %s at %d"
                             % (res.error, res.error_pos))
    if res.n_ops != m.plan.n_ops:
        raise AssertionError("VM decoded %d ops, plan has %d"
                             % (res.n_ops, m.plan.n_ops))
    levels = np.asarray(m.audio.levels())[:m.plan.n_ops]
    if not np.array_equal(res.duty, levels * 2 + 34):
        raise AssertionError("speaker duty cycles differ from audio levels")
    banks = [("main", res.main, m.final_main)]
    if mode == VideoMode.DHGR:
        banks.append(("aux", res.aux, m.final_aux))
    for name, vm, model in banks:
        eq = vm == model.astype(np.uint8)
        eq[0, 0] = True  # the padding op's cell
        if not eq.all():
            raise AssertionError("VM %s screen differs from the encoder's "
                                 "model at %s" % (name, np.argwhere(~eq)[:5]))
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
