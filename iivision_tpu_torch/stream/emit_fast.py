"""`.a2m` byte emission (the port's copy of
iivision_tpu/stream/emit_fast.py, native path).

Opcode records become 7-byte ticks through an address LUT, and ACK,
terminate and padding are spliced at the 2 KB boundaries, in one C++ pass
(sim/csrc/ingest_fast.cpp `emit_stream`).
"""

from typing import Optional

import numpy as np

from iivision_tpu_torch.sim import native
from iivision_tpu_torch.stream import opcodes as ops_mod
from iivision_tpu_torch.stream.opcodes import (OpcodeAddresses,
                                               default_addresses)
from iivision_tpu_torch.trace import span
from iivision_tpu_torch.video_mode import VideoMode, require_mode


def _addr_lut(addrs: OpcodeAddresses) -> np.ndarray:
    """(32 duty-cycles, 32 pages) -> opcode entry address."""
    lut = np.zeros((32, 32), dtype=np.int32)
    for (t, p), a in addrs.tick.items():
        lut[(t - 4) // 2, p - 32] = a
    return lut


def emit_stream_fast(flat_ops: np.ndarray, levels: np.ndarray,
                     mode: VideoMode,
                     addrs: Optional[OpcodeAddresses] = None,
                     max_bytes_out: Optional[int] = None,
                     into: Optional[dict] = None) -> bytes:
    """Assemble the full stream: header + ticks + ACKs + terminate + padding.

    flat_ops: (n, 6) int [page, content, o0..o3]; levels: (n,) in -15..16.
    max_bytes_out cuts the stream at the first opcode whose start position
    reaches the cap.  The call is the span `emit` (`trace.span`; its
    seconds go to `into["emit_s"]` when `into` is given)."""
    with span("emit", into):
        return _emit(flat_ops, levels, mode, addrs, max_bytes_out)


def _emit(flat_ops, levels, mode, addrs, max_bytes_out) -> bytes:
    require_mode(mode)
    addrs = addrs or default_addresses()
    n = len(flat_ops)
    if len(levels) < n:
        raise ValueError("%d audio levels for %d ops" % (len(levels), n))
    if max_bytes_out and n:
        i = np.arange(n)
        acks_before = np.where(
            i < ops_mod.OPS_FIRST_FRAME, 0,
            1 + (i - ops_mod.OPS_FIRST_FRAME) // ops_mod.OPS_PER_FRAME)
        starts = 7 + 7 * i + 4 * acks_before
        over = np.flatnonzero(starts >= max_bytes_out)
        if over.size:
            n = int(over[0])
    if n == 0:
        out = bytes([0xFF] * 6 + [mode.value]) + bytes(
            [addrs.terminate >> 8, addrs.terminate & 0xFF])
        return out + bytes((-len(out)) % ops_mod.FRAME_BYTES)
    return native.emit_stream(
        np.asarray(flat_ops[:n], np.int32), np.asarray(levels[:n]),
        _addr_lut(addrs), addrs.ack, addrs.terminate, mode.value,
        mode == VideoMode.DHGR, ops_mod.OPS_FIRST_FRAME,
        ops_mod.OPS_PER_FRAME)
