"""Smoke run of iivision_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc, checks each against
its plain torch version on the card, reproduces the JAX package's golden
stream, transcodes a 10 s DHGR clip at (k=8, j=1) and (k=16, j=4) with the
player-VM check, and builds the full DHGR NTSC LUT.  Every phase prints
one line of numbers; any failure raises, giving a non-zero exit.  The last
two lines are the kernel report and the device line, both JSON.

Needs one CUDA card; without one it exits non-zero before printing any
result.  Imports nothing of JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

GOLDEN_SHA = "57fdd52adf53d75101ed121d28d8a5389465c09f99d960ba6c47c20dbdb30fbc"


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from iivision_tpu_torch import _build
    from iivision_tpu_torch.ops import editdist, subop

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    report = {}
    check_kernel_a(dev, report)
    check_kernel_b(dev, report)
    check_golden(dev)

    # -- the slice's main path: both entry points, counted ----------------
    for fn in (editdist.pair_distance, editdist.dist_pairs_elementwise,
               subop.sub_op_chain):
        fn.launches = 0
    for k, j in ((8, 1), (16, 4)):
        run_movie(dev, k, j)
    tables, codes, sub = build_lut(dev)
    launches = {"editdist_tile": editdist.pair_distance.launches,
                "dist_pairs": editdist.dist_pairs_elementwise.launches,
                "subop_chain": subop.sub_op_chain.launches}
    print("main path launches: %s" % json.dumps(launches))
    check_lut(dev, tables, codes, sub)
    del tables

    kernels = []
    for name, src, replaces in (
            ("editdist_tile", "iivision_tpu_torch/csrc/editdist.cu",
             "iivision_tpu/ops/editdist.py:232"),
            ("dist_pairs", "iivision_tpu_torch/csrc/editdist.cu",
             "iivision_tpu/ops/editdist.py:232"),
            ("subop_chain", "iivision_tpu_torch/csrc/subop.cu",
             "tools/bench_subop_pallas.py:183")):
        if launches[name] == 0:
            raise AssertionError("kernel %s never launched on the main path"
                                 % name)
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            **report[name]))
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

    rng = np.random.RandomState(7)
    pa = torch.as_tensor(rng.randint(0, 16, (2, 32, 128, 10)),
                         dtype=torch.int32, device=dev)
    pb = torch.as_tensor(rng.randint(0, 16, (2, 32, 128, 10)),
                         dtype=torch.int32, device=dev)
    got = editdist.dist_pairs_elementwise(pa, pb, sub)
    want = distance.dist_pixel_pairs_plain(pa, pb, sub)
    err = int((got - want).abs().max())
    ms = cuda_ms(lambda: editdist.dist_pairs_elementwise(pa, pb, sub), 200)
    plain_ms = cuda_ms(lambda: distance.dist_pixel_pairs_plain(pa, pb, sub),
                       50)
    print("kernel A elementwise 8192 pairs: max_abs_err=%d ms=%.4f "
          "plain_ms=%.4f" % (err, ms, plain_ms))
    if err:
        raise AssertionError("kernel A elementwise disagrees with plain")
    report["dist_pairs"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def subop_inputs(dev, k: int, j: int, seed: int):
    """Seeded kernel B inputs at encoder shapes: page rows, table rows,
    the real DHGR NTSC store-cost table, nonces and pages."""
    import numpy as np
    import torch

    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode
    from iivision_tpu_torch.ops import distance

    rng = np.random.RandomState(seed)
    table16 = torch.as_tensor(
        distance.store_cost_table(VideoMode.DHGR, Palette.NTSC), device=dev)
    R, C = table16.shape[1], table16.shape[2]
    up = rng.randint(0, 3000, (k, 256)) * (rng.rand(k, 256) < 0.6)
    up[0] = 0  # one idle page: its sub-ops are padding
    dw = rng.randint(0, 900, (k, 256))
    by = rng.randint(0, 128, (k, 256))
    tb = rng.randint(0, 256, (k, 256))
    rows = torch.as_tensor(np.stack([up, dw, by, tb], axis=1),
                           dtype=torch.float32, device=dev)
    lane = np.where(np.arange(256) % 2 == 0, 1, 3)[None, :]
    sc_rows = torch.as_tensor(lane * R + rng.randint(0, R, (k, 256)),
                              dtype=torch.int32, device=dev)
    nonce = torch.as_tensor(rng.rand(j, k, 256), dtype=torch.float32,
                            device=dev)
    pages = torch.as_tensor(rng.permutation(32)[:k], dtype=torch.int64,
                            device=dev)
    return rows, sc_rows, table16.reshape(-1, C), nonce, pages


def check_kernel_b(dev, report):
    """Kernel B against its plain version at (k=8, j=1) and (k=16, j=4):
    rows and records bit-equal."""
    import torch

    from iivision_tpu_torch.ops import subop

    # the CLI default (k=8, j=1) gives ms / plain_ms; the headline setting
    # is reported beside it
    entry = report["subop_chain"] = dict(max_abs_err=0.0)
    for k, j, tag in ((8, 1, ""), (16, 4, "_k16_j4")):
        rows, sc_rows, table, nonce, pages = subop_inputs(dev, k, j, 11 + k)
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
            raise AssertionError("kernel B (k=%d, j=%d) disagrees with plain"
                                 % (k, j))
        ms = cuda_ms(lambda r: subop.sub_op_chain(
            r, sc_rows, table, nonce, pages, nvalid, 17, out_k), 200,
            setup=lambda: (rows.clone(),))
        plain_ms = cuda_ms(lambda r: subop.sub_op_chain_plain(
            r, sc_rows, table, nonce, pages, nvalid, 17, out_p), 50,
            setup=lambda: (rows.clone(),))
        print("kernel B k=%d j=%d: max_abs_err=%g ms=%.4f plain_ms=%.4f" % (
            k, j, err, ms, plain_ms))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms" + tag] = ms
        entry["plain_ms" + tag] = plain_ms


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


def run_movie(dev, k: int, j: int):
    """10 s DHGR clip (300 frames at 30 fps, 44.1 kHz tone) through
    Movie(...).transcode on the card, then the player VM."""
    import numpy as np
    import torch

    from iivision_tpu.sim import PlayerVM
    from iivision_tpu_torch.movie import Movie

    from scipy.io import wavfile

    rgb = gradient_clip(300)
    n = 441000
    tone = np.sin(2 * np.pi * 440 * np.arange(n) / 44100) * 12000
    with tempfile.TemporaryDirectory() as tmp:
        # the clip's audio track: decoded, then resampled on the card
        wav = os.path.join(tmp, "clip.wav")
        wavfile.write(wav, 44100, tone.astype(np.int16))
        m = Movie(wav, frames_source=rgb, frame_rate=30.0,
                  every_n_video_frames=2, k=k, j=j, seed=0, device=dev)
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
    for name, vm, model in (("main", res.main, m.final_main),
                            ("aux", res.aux, m.final_aux)):
        eq = vm == model.astype(np.uint8)
        eq[0, 0] = True  # the padding op's cell
        if not eq.all():
            raise AssertionError("VM %s screen differs from the encoder's "
                                 "model at %s" % (name, np.argwhere(~eq)[:5]))
    print("main path k=%d j=%d: n_ops=%d bytes=%d frames_s=%.3f audio_s=%.3f "
          "encode_s=%.3f emit_s=%.3f total_s=%.3f realtime_x=%.3f" % (
              k, j, stats["n_ops"], len(data), stats["frames_s"],
              stats["audio_s"], stats["encode_s"], stats["emit_s"],
              stats["total_s"], stats["realtime_x"]))


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
