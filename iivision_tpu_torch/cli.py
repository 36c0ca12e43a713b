"""Transcode CLI on a torch device (counterpart of iivision_tpu/cli.py):
one input video to one `.a2m` stream, or several inputs encoded together
as one batch.

    python -m iivision_tpu_torch.cli clip.mp4 --device cuda
    python -m iivision_tpu_torch.cli a.mp4 b.mp4 --device cuda [--joint_content]
    python -m iivision_tpu_torch.cli long.mp4 --device cuda --chunk_frames 512
    python -m iivision_tpu_torch.cli a.mp4 b.mp4 --device cuda --mesh auto

`--mesh N|auto` shards each batch group over N cards (`auto`: every card of
the `--device` kind, one for the CPU), clamped to the largest divisor of the
group's size; the streams are byte-equal to unsharded ones.  A solo input
ignores it.
"""

import argparse
import json
import os

from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode


def _default_out(path: str) -> str:
    """`<input sans extension>.a2m` (iivision_tpu/cli.py `_default_out`)."""
    base = path.rstrip("/")
    stem = base.rsplit(".", 1)[0] if "." in os.path.basename(base) else base
    return stem + ".a2m"


def _group_mesh(arg, batch_size: int, device: str = "cuda"):
    """The mesh for one batch group under `--mesh`, or None (unsharded):
    the requested count of `device`'s kind ('auto': every card, one for
    the CPU), clamped to the cards the host has and then to the largest
    divisor of the group's size, since the batch must split evenly
    (iivision_tpu/cli.py `_group_mesh`)."""
    if arg is None:
        return None
    import torch

    from iivision_tpu_torch.parallel import mesh as pmesh

    on_cards = torch.device(device).type == "cuda"
    have = torch.cuda.device_count() if on_cards else 1
    want = have if arg == "auto" else int(arg)
    if on_cards:
        want = max(1, min(want, have))
    n = max(d for d in range(1, min(want, batch_size) + 1)
            if batch_size % d == 0)
    return None if n <= 1 else pmesh.make_mesh(n, device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Transcode a video to ][-Vision format (PyTorch + CUDA).")
    p.add_argument("input", nargs="+",
                   help="Input video file(s); several inputs encode "
                        "together as one batch.")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode on (default: cuda).")
    p.add_argument("--frame_rate", type=float, default=None,
                   help="Override the probed input frame rate.")
    p.add_argument("--output", default=None,
                   help="Output .a2m path (one input) or directory "
                        "(several inputs).")
    p.add_argument("--max_output_mb", type=float, default=0,
                   help="Maximum MB to output (0 = unlimited).")
    p.add_argument("--audio_normalization", type=float, default=None,
                   help="Override auto-detected audio normalization.")
    p.add_argument("--audio_bitrate", type=int, default=14700,
                   help="Output audio bitrate (Hz); 22500 for //gs "
                        "2.8MHz mode.")
    p.add_argument("--every_n_video_frames", type=int, default=2,
                   help="Skip input frames to lower the output frame rate.")
    p.add_argument("--video_mode", type=str,
                   choices=[m.name for m in VideoMode],
                   default=VideoMode.DHGR.name)
    p.add_argument("--palette", type=str,
                   choices=[pl.name for pl in Palette if pl.value >= 0],
                   default=Palette.NTSC.name)
    p.add_argument("--dither", type=str, default=None,
                   choices=["ordered", "buckels", "floyd", "atkinson",
                            "jarvis", "mono"],
                   help="Frame quantization dither (host C++ / numpy); "
                        "default: mono for --colour_model mono, else "
                        "ordered.")
    p.add_argument("--k", type=int, default=8,
                   help="Pages selected per encoder step.")
    p.add_argument("--j", type=int, default=1,
                   help="Ops per selected page per step.")
    p.add_argument("--seed", type=int, default=0,
                   help="Tie-break RNG seed (reproducible streams).")
    p.add_argument("--joint_content", action="store_true",
                   help="Joint content selection: pick each op's byte to "
                        "maximize the total improvement over its 4 offsets, "
                        "searching all content codes.")
    p.add_argument("--colour_model", type=str, default="window",
                   choices=["window", "yiq", "mono"],
                   help="Perceptual basis: 'window' (the reference's "
                        "nominal colours), 'yiq' (NTSC composite) or "
                        "'mono' (dot-level Hamming).")
    p.add_argument("--chunk_frames", type=int, default=None,
                   help="Encode one input in segments of this many "
                        "encoded frames (bounded device memory for the "
                        "targets; same output); default: whole-movie up "
                        "to 1024 encoded frames, 512 past that.")
    p.add_argument("--mesh", default=None,
                   help="Shard each batch group over a device mesh: a "
                        "device count or 'auto' (every card), clamped to "
                        "the largest divisor of the group's size; streams "
                        "are byte-equal to unsharded ones.  A solo input "
                        "ignores it.")
    p.add_argument("--stats_json", default=None,
                   help="Write the transcode stats to this JSON file.")
    return p


def main(args=None):
    parser = build_parser()
    args = parser.parse_args(args)
    if args.dither is None:
        # the mono colour model pairs with the 1-bit mono quantizer
        args.dither = "mono" if args.colour_model == "mono" else "ordered"
    if len(args.input) > 1:
        if args.chunk_frames is not None:
            parser.error("--chunk_frames applies to one input: a batch "
                         "encodes whole movies in lockstep")
        return transcode_batch(args)
    from iivision_tpu_torch.movie import Movie

    path = args.input[0]
    out = args.output or _default_out(path)
    m = Movie(
        path,
        device=args.device,
        every_n_video_frames=args.every_n_video_frames,
        audio_bitrate=args.audio_bitrate,
        audio_normalization=args.audio_normalization,
        max_bytes_out=int(1024 * 1024 * args.max_output_mb) or None,
        video_mode=VideoMode[args.video_mode],
        palette=Palette[args.palette],
        dither_mode=args.dither,
        k=args.k,
        j=args.j,
        seed=args.seed,
        frame_rate=args.frame_rate,
        chunk_frames=args.chunk_frames,
        colour_model=args.colour_model,
        joint_content=args.joint_content,
    )
    print("Palette %s" % args.palette)
    print("Input frame rate = %f" % m.frames.input_frame_rate)
    stats = m.transcode(out)
    print("Wrote %s" % out)
    for key in ("n_ops", "movie_seconds", "encode_s", "total_s",
                "realtime_x"):
        print("%s = %s" % (key, stats[key]))
    _write_stats(args.stats_json, [{"input": path, "output": out,
                                    "device": str(m.device), **stats}])


def transcode_batch(args):
    """Several inputs -> as many .a2m files through one batch encode per
    frame rate (iivision_tpu/cli.py transcode_batch).

    Each input is ingested on the host and its audio decoded and
    resampled on the device; inputs are grouped by probed frame rate
    (movies in one batch share the opcode schedule's timing) and each group
    runs `parallel.mesh.encode_movies_mixed` with seeds args.seed + i,
    sharded over `_group_mesh(args.mesh, ...)`.
    Returns the output paths."""
    import numpy as np

    from iivision_tpu_torch import audio as audio_mod, frames, require_device
    from iivision_tpu_torch.ops import distance
    from iivision_tpu_torch.parallel import mesh as pmesh
    from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
    from iivision_tpu_torch.trace import span

    dev = require_device(args.device)
    mode = VideoMode[args.video_mode]
    palette = Palette[args.palette]
    dist = distance.ComputedDistance(mode, palette, args.colour_model,
                                     device=dev)
    max_bytes = int(1024 * 1024 * args.max_output_mb) or None

    if args.output:
        os.makedirs(args.output, exist_ok=True)
    ingested = []
    for path in args.input:
        fr = frames.ingest(path, mode, palette,
                           every_n_video_frames=args.every_n_video_frames,
                           dither_mode=args.dither,
                           frame_rate=args.frame_rate)
        try:
            aud = audio_mod.Audio(path, bitrate=args.audio_bitrate,
                                  normalization=args.audio_normalization,
                                  device=dev)
        except Exception:
            # no audio track: silent stream covering the whole video
            seconds = fr.n_frames_total / fr.input_frame_rate
            aud = audio_mod.Audio(
                data=np.zeros(int(seconds * args.audio_bitrate) + 1,
                              np.float32),
                rate=args.audio_bitrate, bitrate=args.audio_bitrate,
                normalization=1.0, device=dev)
        out = (os.path.join(args.output, os.path.basename(_default_out(path)))
               if args.output else _default_out(path))
        if any(out == m[3] for m in ingested):
            raise ValueError(
                "output collision: %r would be written by two inputs "
                "(distinct inputs share a basename) - rename an input or "
                "use separate --output dirs" % (out,))
        ingested.append((path, fr, aud, out))

    groups = {}
    for i, (_, fr, _, _) in enumerate(ingested):
        groups.setdefault(round(fr.input_frame_rate, 6), []).append(i)
    stats_rows = []
    for rate, idxs in sorted(groups.items()):
        movies = [(ingested[i][1].targets_main, ingested[i][1].targets_aux,
                   ingested[i][1].n_frames_total,
                   len(ingested[i][2].levels())) for i in idxs]
        timed = {}
        with span("encode", timed):
            flats, _, n_ops = pmesh.encode_movies_mixed(
                dist, movies, mode, rate, float(args.audio_bitrate),
                every_n_video_frames=args.every_n_video_frames,
                k=args.k, j=args.j, seeds=[args.seed + i for i in idxs],
                joint=args.joint_content,
                mesh=_group_mesh(args.mesh, len(movies), args.device))
        encode_s = timed["encode_s"]
        for flat, i in zip(flats, idxs):
            path, fr, aud, out = ingested[i]
            levels = np.asarray(aud.levels())[:len(flat)]
            data = emit_stream_fast(flat, levels, mode,
                                    max_bytes_out=max_bytes)
            with open(out, "wb") as f:
                f.write(data)
            print("Wrote %s (%d ops, %.1fs @ %.3f fps input)"
                  % (out, len(flat), len(flat) / args.audio_bitrate, rate))
            stats_rows.append({
                "input": path, "output": out, "device": str(dev),
                "n_ops": len(flat), "stream_bytes": len(data),
                "movie_seconds": len(flat) / args.audio_bitrate,
                "input_frame_rate": rate, "batch_size": len(idxs),
                "batch_encode_s": encode_s,
            })
    _write_stats(args.stats_json, stats_rows)
    return [m[3] for m in ingested]


def _write_stats(path, rows):
    if not path:
        return
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print("Stats written to %s" % path)


if __name__ == "__main__":
    main()
