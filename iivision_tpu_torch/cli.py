"""Transcode CLI on a torch device (counterpart of iivision_tpu/cli.py, solo
path): one input video to one `.a2m` stream.

    python -m iivision_tpu_torch.cli clip.mp4 --device cuda

Flags the port does not run yet are refused with the ROADMAP.md item that
will bring them; nothing falls back silently.
"""

import argparse
import json

from iivision_tpu.cli import _default_out
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode

# flag -> (test on the parsed args, ROADMAP.md item)
_NOT_PORTED = [
    ("several inputs", lambda a: len(a.input) > 1,
     "Queue 1: 'batch encode'"),
    ("--mesh", lambda a: a.mesh is not None, "Queue 1: 'batch encode'"),
    ("--chunk_frames", lambda a: a.chunk_frames is not None,
     "Queue 1: 'chunked and streaming long-movie encoders'"),
    ("--joint_content", lambda a: a.joint_content,
     "Queue 1: 'joint content'"),
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Transcode a video to ][-Vision format (PyTorch + CUDA).")
    p.add_argument("input", nargs="+", help="Input video file.")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode on (default: cuda).")
    p.add_argument("--frame_rate", type=float, default=None,
                   help="Override the probed input frame rate.")
    p.add_argument("--output", default=None, help="Output .a2m path.")
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
                   help="Not ported yet.")
    p.add_argument("--colour_model", type=str, default="window",
                   choices=["window", "yiq", "mono"],
                   help="Perceptual basis: 'window' (the reference's "
                        "nominal colours), 'yiq' (NTSC composite) or "
                        "'mono' (dot-level Hamming).")
    p.add_argument("--chunk_frames", type=int, default=None,
                   help="Not ported yet.")
    p.add_argument("--mesh", default=None, help="Not ported yet.")
    p.add_argument("--stats_json", default=None,
                   help="Write the transcode stats to this JSON file.")
    return p


def main(args=None):
    parser = build_parser()
    args = parser.parse_args(args)
    for flag, used, item in _NOT_PORTED:
        if used(args):
            parser.error("%s is not ported to iivision_tpu_torch yet "
                         "(ROADMAP.md %s)" % (flag, item))
    if args.dither is None:
        # the mono colour model pairs with the 1-bit mono quantizer
        args.dither = "mono" if args.colour_model == "mono" else "ordered"
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
        colour_model=args.colour_model,
    )
    print("Palette %s" % args.palette)
    print("Input frame rate = %f" % m.frames.input_frame_rate)
    stats = m.transcode(out)
    print("Wrote %s" % out)
    for key in ("n_ops", "movie_seconds", "encode_s", "total_s",
                "realtime_x"):
        print("%s = %s" % (key, stats[key]))
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump([{"input": path, "output": out,
                        "device": str(m.device), **stats}], f, indent=1)
        print("Stats written to %s" % args.stats_json)


if __name__ == "__main__":
    main()
