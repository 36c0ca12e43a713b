"""Frozen for the benchmark's reference: a copy of
iivision_tpu_torch/stream/opcodes.py, which this package never imports.

The player's opcode entry addresses, read from its symbol file (only the
address table and the framing constants are kept here; the stream itself
is built by `stream.frame_stream`).  Byte formats are frozen ABI:

  Header:    no address; 6x 0xff pad + video-mode byte  (main.s headerlen=$07)
  Tick(t,p): addr + [content, o0, o1, o2, o3]           (73-cycle audio+video op)
  Ack:       addr + [0x54|0x55, 0xff]                   (2KB buffer management)
  Terminate: addr only
"""

import functools
from typing import Dict, Optional, Tuple

from benchmark.reference.symbols import SymbolTable

TICKS = tuple(range(4, 68, 2))  # 32 speaker duty cycles
PAGES = tuple(range(32, 64))  # 32 HGR pages ($20..$3F)


class OpcodeAddresses:
    """Opcode entry addresses for a specific player binary (.dbg file)."""

    def __init__(self, debugfile: Optional[str] = None):
        self._load(SymbolTable(debugfile).opcode_addresses())

    def _load(self, addrs: Dict[str, int]) -> None:
        self.header = addrs["header"]
        self.terminate = addrs["terminate"]
        self.nop = addrs["nop"]
        self.ack = addrs["ack"]
        self.tick: Dict[Tuple[int, int], int] = {}
        for t in TICKS:
            for p in PAGES:
                self.tick[(t, p)] = addrs["tick_%d_page_%d" % (t, p)]
        missing = [k for k, v in self.tick.items() if v is None]
        if missing:
            raise ValueError("Missing opcode addresses: %r" % missing)


@functools.lru_cache(None)
def default_addresses() -> OpcodeAddresses:
    return OpcodeAddresses()


# Stream-framing constants (frozen ABI, see stream/framing.py)
FRAME_BYTES = 2048  # W5100 RX window the player drains per ACK
TICK_BYTES = 7  # addr(2) + content(1) + offsets(4)
HEADER_BYTES = 7
ACK_BYTES = 4
# ops per 2KB frame: first frame fits header + 291 ticks = 2044 bytes + ACK;
# every later frame fits exactly 292 ticks = 2044 bytes + ACK.
OPS_FIRST_FRAME = 291
OPS_PER_FRAME = 292
