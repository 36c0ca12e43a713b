"""The `.a2m` opcode ISA's addresses and framing constants (the port's copy
of what it uses of iivision_tpu/stream/opcodes.py).

Every opcode is the 2-byte (hi, lo) entry address of a player routine
followed by its inline data:

  Header:    no address; 6x 0xff pad + video-mode byte
  Tick(t,p): addr + [content, o0, o1, o2, o3]
  Ack:       addr + [0x54|0x55, 0xff]
  Terminate: addr only
  Nop:       addr only
"""

import functools
from typing import Dict, Optional, Tuple

from iivision_tpu_torch.stream.symbols import SymbolTable

TICKS = tuple(range(4, 68, 2))  # 32 speaker duty cycles
PAGES = tuple(range(32, 64))  # 32 HGR pages ($20..$3F)

# Stream-framing constants (frozen ABI)
FRAME_BYTES = 2048  # W5100 RX window the player drains per ACK
# ops per 2KB frame: the first frame fits header + 291 ticks = 2044 bytes +
# ACK; every later frame fits exactly 292 ticks = 2044 bytes + ACK
OPS_FIRST_FRAME = 291
OPS_PER_FRAME = 292


class OpcodeAddresses:
    """Opcode entry addresses for a specific player binary (.dbg file)."""

    def __init__(self, debugfile: Optional[str] = None):
        addrs = SymbolTable(debugfile).opcode_addresses()
        self.header = addrs["header"]
        self.terminate = addrs["terminate"]
        self.nop = addrs["nop"]
        self.ack = addrs["ack"]
        self.tick: Dict[Tuple[int, int], int] = {}
        for t in TICKS:
            for p in PAGES:
                self.tick[(t, p)] = addrs["tick_%d_page_%d" % (t, p)]


@functools.lru_cache(None)
def default_addresses() -> OpcodeAddresses:
    return OpcodeAddresses()
