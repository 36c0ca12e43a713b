"""Seeking inside `.a2m` streams (the reference's "Playback controls"; the
port's copy of iivision_tpu/stream/seek.py).

The reference lists stream seeking as a future improvement (reference
README.md:240-242), noting the cost: the encoder emits *deltas* against its
model of the player's screen, so joining mid-stream shows transient "video
tearing" until every byte has been rewritten.  What makes seeking possible
at all is the frozen framing contract (stream/framing.py): every 2KB frame
ends with an ACK opcode that carries the MAIN/AUX bank *explicitly* in its
data byte, so the stream is self-describing at every 2KB boundary.

Seeking therefore needs no re-encode and no sidecar file:

  - ``seek_index(data)`` walks the stream grammar once and returns, for
    every 2KB frame, its byte offset, its playback timestamp (73 cycles per
    tick, 146 per ACK - the player's exact cadence), and the memory bank its
    stores target;
  - ``seek(data, frame)`` builds a new, fully valid stream: the 7-byte
    header, one synthesized preamble frame of 291 silent ticks (duty 34 =
    PCM zero, stores to a screen-hole offset so nothing is visible), an ACK
    selecting the seek frame's bank, then the original stream tail verbatim.
    The preamble is exactly one 2KB frame, so every subsequent original ACK
    stays on its boundary.

``python -m iivision_tpu_torch.stream.seek`` is the offline tool; the server's
``--seek`` starts every connection at a timestamp.
"""

import argparse
import sys
from dataclasses import dataclass
from typing import List, Optional

from iivision_tpu_torch.stream.opcodes import (
    Ack, Header, OpcodeAddresses, Tick, default_addresses, emit_opcode)
from iivision_tpu_torch.stream.retarget import walk
from iivision_tpu_torch.video_mode import VideoMode

TICK_CYCLES = 73  # player/main.s: every tick opcode is exactly 73 cycles
ACK_CYCLES = 146  # 2x73-cycle slow path (main.s:1290-1344)
CLOCK_HZ = 1024 * 1024  # nominal clock used by the VM's playback_seconds

# Offsets $78-$7F/$F8-$FF are (D)HGR screen holes on every page (reference
# transcoder/screen.py:41-62): preamble stores there are invisible.
_HOLE_OFFSET = 0x78
_PREAMBLE_TICKS = 291  # header(7) + 291*7 + ack(4) = exactly 2048 bytes


@dataclass(frozen=True)
class SeekPoint:
    frame: int  # 2KB frame number
    byte_offset: int  # == frame * 2048
    seconds: float  # playback time when this frame starts
    aux_bank: bool  # bank this frame's stores target (DHGR; False in HGR)


def seek_index(data: bytes,
               addrs: Optional[OpcodeAddresses] = None) -> List[SeekPoint]:
    """One SeekPoint per 2KB frame of a well-formed stream.

    Frame k's bank is the one selected by the ACK ending frame k-1 (frame 0
    always targets MAIN - framing.py segment_schedule); its timestamp is
    the playback time accumulated over every opcode before it.  The last
    frame (terminate + padding) gets a point too - seeking there is valid,
    just silent.
    """
    points = [SeekPoint(0, 0, 0.0, False)]
    cycles = 0
    for pos, kind, key in walk(data, addrs):
        if kind == "tick":
            cycles += TICK_CYCLES
        elif kind == "ack":
            cycles += ACK_CYCLES
            points.append(SeekPoint(len(points), pos + 4,
                                    cycles / CLOCK_HZ, bool(key)))
    return points


def frame_at(index: List[SeekPoint], seconds: float) -> SeekPoint:
    """The latest seek point at or before `seconds`."""
    best = index[0]
    for p in index:
        if p.seconds <= seconds:
            best = p
    return best


def seek(data: bytes, frame: int,
         addrs: Optional[OpcodeAddresses] = None) -> bytes:
    """A valid stream that starts playback at 2KB frame `frame`.

    frame 0 returns the stream unchanged; otherwise the result is
    header + one silent preamble frame (whose ACK selects the seek frame's
    bank) + the original tail verbatim: exactly
    `2048 + (len(data) - frame*2048)` bytes.
    """
    if frame == 0:
        return data
    index = seek_index(data, addrs)
    if not 0 < frame < len(index):
        raise ValueError("frame %d out of range (stream has %d seekable "
                         "frames)" % (frame, len(index)))
    point = index[frame]
    mode = VideoMode(data[6])
    a = addrs or default_addresses()
    out = [emit_opcode(Header(mode), a)]
    out += [emit_opcode(
        Tick(34, 32, 0, (_HOLE_OFFSET,) * 4), a)] * _PREAMBLE_TICKS
    out.append(emit_opcode(Ack(point.aux_bank), a))
    pre = b"".join(out)
    assert len(pre) == 2048, len(pre)
    return pre + data[point.byte_offset:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Seek inside an .a2m stream: print its seek index or "
                    "write a stream starting at a timestamp/frame.")
    ap.add_argument("stream", help="Input .a2m file")
    ap.add_argument("-o", "--output", help="Output .a2m file")
    ap.add_argument("--at", type=float, metavar="SECONDS",
                    help="Start playback at this timestamp")
    ap.add_argument("--frame", type=int, metavar="K",
                    help="Start playback at 2KB frame K")
    ap.add_argument("--index", action="store_true",
                    help="Print the seek index (one line per 2KB frame)")
    args = ap.parse_args(argv)

    data = open(args.stream, "rb").read()
    index = seek_index(data)
    if args.index or (args.at is None and args.frame is None):
        for p in index:
            print("frame %5d  byte %9d  t=%8.3fs  bank=%s"
                  % (p.frame, p.byte_offset, p.seconds,
                     "AUX" if p.aux_bank else "MAIN"))
        if args.at is None and args.frame is None:
            return 0
    point = (index[args.frame] if args.frame is not None
             else frame_at(index, args.at))
    out = seek(data, point.frame)
    if not args.output:
        ap.error("-o/--output is required when seeking")
    with open(args.output, "wb") as f:
        f.write(out)
    print("seek to frame %d (t=%.3fs, bank=%s): wrote %d bytes"
          % (point.frame, point.seconds,
             "AUX" if point.aux_bank else "MAIN", len(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
