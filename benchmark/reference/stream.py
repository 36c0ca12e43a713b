"""The `.a2m` stream, plain numpy: header, one 7-byte tick opcode per op,
an ACK closing every 2 KB frame, Terminate and zero padding (the framing
rules of iivision_tpu_torch/stream/framing.py, written whole-array).

The header is 7 bytes (six 0xff and the video mode); a tick is the 2-byte
(hi, lo) entry address of the player's routine for (speaker duty cycle,
page), then the content byte and the four offsets.  The first frame holds
the header and 291 ticks, every later one 292: 2044 bytes, then a 4-byte
ACK (the ack address, 0x55 when the AUX bank becomes active, else 0x54,
then 0xff).  In DHGR the bank flips at every ACK, MAIN first; HGR stays on
MAIN.  A full last frame gets its ACK too.  Terminate (its address) ends
the stream, zero-padded to the next 2 KB boundary.
"""

import numpy as np

from benchmark.reference.opcodes import (ACK_BYTES, FRAME_BYTES, PAGES,
                                         TICKS, default_addresses)
from benchmark.reference.video_mode import VideoMode

FILL = FRAME_BYTES - ACK_BYTES  # bytes of ops in a frame


def frame_stream(flat: np.ndarray, levels: np.ndarray,
                 mode: VideoMode) -> bytes:
    """flat: (n, 6) [page, content, o0, o1, o2, o3] ops; levels: (>= n,)
    audio levels in -15..16."""
    addrs = default_addresses()
    flat = np.asarray(flat, np.int64)
    n = len(flat)
    table = np.array([[addrs.tick[(t, p)] for p in PAGES] for t in TICKS],
                     np.int64)
    duty = np.asarray(levels[:n], np.int64) * 2 + 34
    a = table[(duty - TICKS[0]) // 2, flat[:, 0] - PAGES[0]]
    ticks = np.empty((n, 7), np.uint8)
    ticks[:, 0] = a >> 8
    ticks[:, 1] = a & 0xFF
    ticks[:, 2:] = flat[:, 1:] & 0xFF
    body = np.concatenate([np.array([0xFF] * 6 + [mode.value], np.uint8),
                           ticks.reshape(-1)])
    full = len(body) // FILL
    aux = (np.arange(full) % 2 == 0) if mode == VideoMode.DHGR \
        else np.zeros(full, bool)
    acks = np.empty((full, ACK_BYTES), np.uint8)
    acks[:, 0] = addrs.ack >> 8
    acks[:, 1] = addrs.ack & 0xFF
    acks[:, 2] = np.where(aux, 0x55, 0x54)
    acks[:, 3] = 0xFF
    frames = np.concatenate([body[:full * FILL].reshape(full, FILL), acks],
                            axis=1).reshape(-1)
    term = np.array([addrs.terminate >> 8, addrs.terminate & 0xFF],
                    np.uint8)
    out = np.concatenate([frames, body[full * FILL:], term])
    pad = FRAME_BYTES - len(out) % FRAME_BYTES
    return out.tobytes() + bytes(pad)
