"""iivision_tpu_torch needs neither JAX nor the JAX package: its entry
points import, and tiny DHGR and HGR yiq encodes, the host oracle, the
reference-order greedy, the roofline, a B=2 batch encode with joint
content (unsharded and over a CPU mesh of 2, with the parallel fetch and
its future), a batch ingest, the sharded LUT build, compare_quantizers on
the parity fixture, a replay score, a host-ingest Movie through
the player VM (whole-movie and with `chunk_frames`), a streaming encode,
the renderer, the CLI (with `--chunk_frames`), the sub-op microbenchmark,
the measuring programs (`bench`, `bench_configs`, `bench_solo_floor`: a
tiny B=2 batch configuration) and the delivery half (framing, retarget,
seek, the server over a loopback socket, `verify_stream --machine` on the
assembled 6502 player, the disk boot and `render_stream`) run, in a process
where importing `jax`, `iivision_tpu` or the JAX benchmarks `bench`,
`bench_configs` and `bench_solo_floor` fails.
chip_smoke.py imports there too.  No port source (nor chip_smoke.py)
imports any of them."""

import ast

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys


BLOCKED = ("jax", "jaxlib", "iivision_tpu", "bench", "bench_configs",
           "bench_solo_floor")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("%s is blocked in this process" % name)
        return None


sys.meta_path.insert(0, Block())

import os
import tempfile

import numpy as np

import chip_smoke
import iivision_tpu_torch
import iivision_tpu_torch.cli
import iivision_tpu_torch.make_tables
from iivision_tpu_torch import audio, bench_subop, encoder, frames, quality
from iivision_tpu_torch import compare_quantizers, encoder_host
from iivision_tpu_torch import encoder_parity, render, roofline
from iivision_tpu_torch.movie import Movie
from iivision_tpu_torch.ops import distance, dither, resize, yiq
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.parallel import mesh
from iivision_tpu_torch.sim import PlayerVM
from iivision_tpu_torch.video_mode import VideoMode
import torch

mode = VideoMode.DHGR
dist = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
rng = np.random.RandomState(0)
fmain = rng.randint(0, 0x80, (1, 32, 256)).astype(np.uint8)
faux = rng.randint(0, 0x80, (1, 32, 256)).astype(np.uint8)
plan, _ = encoder.plan_movie(
    n_frames=1, n_audio_ticks=300, input_frame_rate=30.0,
    ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8)
lanes, bytes_tgt = encoder.prepare_targets(fmain, faux, mode, "cpu")
ops, main, aux = encoder.encode_movie(dist, lanes, bytes_tgt, plan, mode,
                                      seed=0)
flat = encoder.flatten_ops(ops.numpy(), plan)
assert flat.shape == (plan.n_ops, 6) and plan.n_ops > 0
det, _, _ = encoder.encode_movie(dist, lanes, bytes_tgt, plan, mode,
                                 seed=None)
assert np.array_equal(encoder.flatten_ops(det.numpy(), plan),
                      encoder_host.encode_movie_host(dist, lanes, bytes_tgt,
                                                     plan, mode))
plan1, _ = encoder.plan_movie(
    n_frames=1, n_audio_ticks=300, input_frame_rate=30.0,
    ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=1)
assert encoder_parity.encode_movie_reference_order(
    dist, lanes, bytes_tgt, plan1, mode).shape == (plan1.n_ops, 6)
cost = roofline.encode_cost(plan, mode, batch=2, shards=2)
assert cost.chunk_starts == 2 * roofline.encode_cost(plan, mode).chunk_starts
assert "bound" in roofline.report(plan, mode, 2, 0.01,
                                  "NVIDIA H100 80GB HBM3")

hgr = VideoMode.HGR
dist = distance.ComputedDistance(hgr, Palette.NTSC, "yiq", device="cpu")
plan, _ = encoder.plan_movie(
    n_frames=1, n_audio_ticks=300, input_frame_rate=30.0,
    ticks_per_second=14700.0, every_n_video_frames=1, mode=hgr, k=8)
lanes, bytes_tgt = encoder.prepare_targets(fmain, None, hgr, "cpu")
ops, main, aux = encoder.encode_movie(dist, lanes, bytes_tgt, plan, hgr,
                                      seed=0)
assert yiq.lane_windows(lanes[0, ..., 1], hgr, 1).shape == (32, 128, 15)

clip = torch.as_tensor(np.stack([chip_smoke.synth_clip(seconds=0.1, phase=p)
                                 for p in (0.0, 1.0)]))
lanes_b, bytes_b = mesh.ingest_movies_batch(clip, mode, Palette.NTSC)
assert lanes_b.shape == (2, 3, 32, 128, 4)
dist = distance.ComputedDistance(mode, Palette.NTSC, device="cpu")
plan, _ = encoder.plan_movie(
    n_frames=3, n_audio_ticks=400, input_frame_rate=30.0,
    ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=4)
ops_b, _, _ = mesh.encode_movies_batch(dist, lanes_b, bytes_b, plan, mode,
                                       seeds=[0, 1], joint=True)
flat_b = mesh.fetch_ops_compact(ops_b, plan)
assert flat_b.shape == (2, plan.n_ops, 6)
two = mesh.make_mesh(2, "cpu")
s_lanes, s_bytes = mesh.ingest_movies_batch(clip, mode, Palette.NTSC,
                                            mesh=two)
s_ops, _, _ = mesh.encode_movies_batch(dist, s_lanes, s_bytes, plan, mode,
                                       seeds=[0, 1], joint=True)
assert np.array_equal(mesh.fetch_ops_parallel(s_ops, plan), flat_b)
assert np.array_equal(mesh.fetch_ops_parallel_future(s_ops, plan).result(),
                      flat_b)
rows = mesh.build_tables_sharded(hgr, Palette.NTSC, two, n_rows=2)
assert rows.shape == (2, 2 * 16384)
cq_rows = compare_quantizers.compare("tests/fixtures/parity_frames.npz", hgr,
                                     Palette.NTSC, n_frames=1, device="cpu")
assert [name for name, _ in cq_rows] == ["ordered"]
rep = quality.replay_frame_errors(flat_b[0], plan, lanes_b[0], mode, dist)
assert rep.mean_error > 0
recs = bench_subop.run("cpu", B=1, K=2, ts=(2,),
                       variants=("plain", "plain_i16"))
assert len(recs) == 2

# host ingest, the audio track and emission through Movie, then the VM
tone = (np.sin(np.arange(2940) / 5.0) * 9000).astype(np.float32)
m = Movie(frames_source=chip_smoke.synth_clip(seconds=0.2), device="cpu",
          audio_source=audio.Audio(data=tone, rate=14700, bitrate=14700,
                                   device="cpu"),
          every_n_video_frames=2, video_mode=VideoMode.HGR)
with tempfile.TemporaryDirectory() as tmp:
    out = os.path.join(tmp, "clip.a2m")
    stats = m.transcode(out)
    data = open(out, "rb").read()
    res = PlayerVM().decode(data)
    assert res.ok and res.n_ops == stats["n_ops"] > 0
    # the chunked encoder through Movie, the streaming one on the
    # ingest generator, and the renderer on the final screen
    mc = Movie(frames_source=chip_smoke.synth_clip(seconds=0.2), device="cpu",
               audio_source=m.audio, every_n_video_frames=2,
               video_mode=VideoMode.HGR, dist=m.dist, chunk_frames=1)
    mc.transcode(out)
    assert mc.encoder_used == "chunked" and open(out, "rb").read() == data
    gen = frames.ingest_stream_array(chip_smoke.synth_clip(seconds=0.2),
                                     VideoMode.HGR, Palette.NTSC, 2, batch=2)
    ops_s, main_s, _, tm, ta = encoder.encode_movie_streaming(
        m.dist, gen, m.plan, VideoMode.HGR, seed=0, chunk_frames=1)
    assert np.array_equal(main_s, m.final_main) and ta is None
    rgb = render.screen_to_rgb(main_s, None, VideoMode.HGR, Palette.NTSC)
    assert rgb.shape == (192, 140, 3)
    assert np.isfinite(quality.stream_psnr(
        main_s, None, render.screen_to_rgb_yiq(tm[-1], None, VideoMode.HGR,
                                               Palette.NTSC),
        VideoMode.HGR, Palette.NTSC))
    clip_path = os.path.join(tmp, "clip.npy")
    np.save(clip_path, chip_smoke.synth_clip(seconds=0.2))
    iivision_tpu_torch.cli.main([clip_path, "--device", "cpu",
                                 "--chunk_frames", "2"])
    assert os.path.exists(os.path.join(tmp, "clip.a2m"))

    # the delivery half, on the HGR clip's stream and on a framed DHGR one
    import socket
    import socketserver
    import threading

    from iivision_tpu_torch import make_disk, prodos, render_stream, server
    from iivision_tpu_torch import verify_stream
    from iivision_tpu_torch.sim import asm65, machine65
    from iivision_tpu_torch.stream import framing, opcodes, retarget, seek

    assert verify_stream.main([out, "--machine"]) == 0
    states, vmode = render_stream.stream_screens(data, 10.0)
    assert vmode == 0 and np.array_equal(states[-1, 0], res.main)
    framer = framing.StreamFramer(VideoMode.DHGR)
    tiny = b"".join(framer.emit_stream(iter(
        [opcodes.Header(VideoMode.DHGR)]
        + [opcodes.Tick(34, 32 + i % 32, i % 128, (0, 1, 2, 3))
           for i in range(900)])))
    assert len(seek.seek_index(tiny)) == len(tiny) // 2048 == 4
    relocated = asm65.Assembler(segments={
        "LOWCODE": 0x0800, "HGR": 0x2000, "CODE": 0x4100}).assemble(
            open(asm65.PLAYER_SOURCE).read())
    new = opcodes.OpcodeAddresses.from_symbols(relocated.symbols)
    moved = retarget.retarget(tiny, None, new)
    assert retarget.identify(moved, [("old", opcodes.default_addresses()),
                                     ("new", new)]) == "new"
    tiny_path = os.path.join(tmp, "tiny.a2m")
    with open(tiny_path, "wb") as f:
        f.write(tiny)
    srv = socketserver.TCPServer(
        ("127.0.0.1", 0),
        server.build_handler(tiny_path, transform=server.build_seeker(0.03)))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        got = b""
        with socket.create_connection(srv.server_address, timeout=10) as s:
            while True:
                buf = s.recv(65536)
                if not buf:
                    break
                got += buf
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
    assert got == seek.seek(tiny, 1)
    base = machine65.play_stream(tiny)
    assert machine65.play_stream(got).exit_reason == "TERMINATED"
    var = machine65.Apple2Player(assembly=relocated).run(moved)
    assert var.exit_reason == "TERMINATED" and var.cycles == base.cycles
    assert np.array_equal(var.main, base.main)
    with open(make_disk.TEMPLATE_DISK, "rb") as f:
        disk = make_disk.build_disk(template=f.read()).to_po()
    assert prodos.ProDOSVolume.from_bytes(disk).read_file("IIVISION") == \
        make_disk.player_binary()
    booted = machine65.boot_disk(disk, tiny)
    assert booted.exit_reason == "TERMINATED"
    assert np.array_equal(booted.aux, base.aux)
# the measuring programs, one configuration at a tiny size
from iivision_tpu_torch import bench, bench_configs, bench_solo_floor

assert "k_sweep_k32_j8" in bench_configs.CONFIGS
assert "solo_floor_dhgr_k32_j10" in bench_solo_floor.CONFIGS
assert bench.main(["--device", "cpu", "--tiny", "--reps", "1", "--only",
                   "batch_dhgr_b32_10s_k16_j4"]) == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("no-jax ok", plan.n_ops)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax ok" in proc.stdout


def imported_roots(path):
    """Top-level module names a Python file imports, anywhere in it."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_do_not_import_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "iivision_tpu_torch")):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    assert len(paths) > 20
    for path in paths:
        bad = imported_roots(path) & {"jax", "jaxlib", "iivision_tpu",
                                      "bench", "bench_configs",
                                      "bench_solo_floor"}
        assert not bad, (path, bad)
