"""Render an `.a2m` stream back to viewable video frames (visual QA CLI; the
port's copy of iivision_tpu/render_stream.py).

Replays the opcode stream the way the player executes it, snapshots the
screen at a fixed frame rate, renders each snapshot through the colour
model (nominal palette or NTSC-composite YIQ) and writes an animated GIF
or a PNG sequence.  The reference has no renderer at all - QA there means
real hardware or eyeballing nothing.

Usage:
  python -m iivision_tpu_torch.render_stream movie.a2m out.gif [--fps 10]
  python -m iivision_tpu_torch.render_stream movie.a2m outdir/ --png [--renderer yiq]
"""

import argparse
import os
import sys

import numpy as np


def stream_screens(data: bytes, fps: float):
    """Replay a stream, yielding (32,256)x2 screen snapshots at `fps`.

    Uses the opcode VM's per-op decode (via quality.replay_ops) with
    snapshot boundaries every tick_rate/fps opcodes (1 op == 1 audio tick
    == 1/14700s of playback).
    """
    from iivision_tpu_torch.sim import PlayerVM
    from iivision_tpu_torch import quality

    vm = PlayerVM()
    res = vm.decode(data)
    if not res.ok:
        raise ValueError("stream does not decode: %s @%d"
                         % (res.error, res.error_pos))

    # re-parse op list: page/content/offsets + bank schedule from the ACK
    # soft-switch bytes.  The VM validated the stream, so a light second
    # pass over the framing is safe.
    ops, banks = [], []
    pos = 7  # header
    bank = 0
    n = len(data)
    while pos + 2 <= n:
        addr = (data[pos] << 8) | data[pos + 1]
        kind = vm.kind[addr]
        if kind == 1:  # tick
            page, content = int(vm.page[addr]), data[pos + 2]
            offs = list(data[pos + 3:pos + 7])
            ops.append([page, content] + offs)
            banks.append(bank)
            pos += 7
        elif kind == 2:  # ack
            sw = data[pos + 2]
            bank = 1 if sw == 0x55 else 0
            pos += 4
        elif kind == 3:  # terminate
            break
        else:  # nop or unknown: skip address
            pos += 2
    flat = np.asarray(ops, dtype=np.int64)
    op_bank = np.asarray(banks, dtype=np.int64)

    ticks_per_snap = max(int(round(14700.0 / fps)), 1)
    boundaries = np.arange(ticks_per_snap - 1, len(flat), ticks_per_snap)
    if len(boundaries) == 0 or boundaries[-1] != len(flat) - 1:
        boundaries = np.append(boundaries, len(flat) - 1)
    states = quality.replay_ops(flat, op_bank, boundaries)
    return states, res.video_mode


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stream", help="Path to .a2m file")
    ap.add_argument("output", help="Output .gif path, or directory (--png)")
    ap.add_argument("--fps", type=float, default=10.0,
                    help="Snapshot rate (default 10)")
    ap.add_argument("--png", action="store_true",
                    help="Write PNG frames into a directory instead")
    ap.add_argument("--renderer", choices=["nominal", "yiq"],
                    default="nominal",
                    help="Colour model: nominal palette or NTSC composite")
    ap.add_argument("--palette", default="NTSC", choices=["NTSC", "IIGS"])
    ap.add_argument("--scale", type=int, default=2,
                    help="Integer upscale of the 140x192 output")
    args = ap.parse_args(argv)

    from iivision_tpu_torch import render
    from iivision_tpu_torch.palettes import Palette
    from iivision_tpu_torch.video_mode import VideoMode

    data = open(args.stream, "rb").read()
    states, vmode = stream_screens(data, args.fps)
    mode = VideoMode(vmode)
    palette = Palette[args.palette]
    to_rgb = (render.screen_to_rgb_yiq if args.renderer == "yiq"
              else render.screen_to_rgb)

    from PIL import Image
    frames = []
    for st in states:
        rgb = np.asarray(to_rgb(st[0], st[1], mode, palette))
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        im = Image.fromarray(rgb)
        if args.scale != 1:
            im = im.resize((rgb.shape[1] * args.scale,
                            rgb.shape[0] * args.scale), Image.NEAREST)
        frames.append(im)

    if args.png:
        os.makedirs(args.output, exist_ok=True)
        for i, im in enumerate(frames):
            im.save(os.path.join(args.output, "%06d.png" % i))
        print("wrote %d PNG frames to %s" % (len(frames), args.output))
    else:
        frames[0].save(args.output, save_all=True,
                       append_images=frames[1:],
                       duration=int(1000 / args.fps), loop=0)
        print("wrote %s (%d frames at %.1f fps)"
              % (args.output, len(frames), args.fps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
