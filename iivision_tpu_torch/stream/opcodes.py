"""The `.a2m` opcode ISA - the byte-stream contract with the 6502 player (the
port's copy of iivision_tpu/stream/opcodes.py).

Every opcode is the 2-byte (hi, lo) entry address of a player routine followed
by its inline data (reference transcoder/opcodes.py:48-52, player/main.s:450-
456: the player's only control flow is a self-modified JMP through these
addresses).  Byte formats are frozen ABI:

  Header:    no address; 6x 0xff pad + video-mode byte  (main.s headerlen=$07)
  Tick(t,p): addr + [content, o0, o1, o2, o3]           (73-cycle audio+video op)
  Ack:       addr + [0x54|0x55, 0xff]                   (2KB buffer management)
  Terminate: addr only
  Nop:       addr only

Instead of the reference's 1,024 dynamically generated classes (reference
transcoder/opcodes.py:149-165) the ISA here is a data table: an address map
from the player symbol table plus small value types.
"""

import functools
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

from iivision_tpu_torch.stream.symbols import SymbolTable
from iivision_tpu_torch.video_mode import VideoMode, require_mode

TICKS = tuple(range(4, 68, 2))  # 32 speaker duty cycles
PAGES = tuple(range(32, 64))  # 32 HGR pages ($20..$3F)


class OpcodeAddresses:
    """Opcode entry addresses for a specific player binary (.dbg file)."""

    def __init__(self, debugfile: Optional[str] = None):
        self._load(SymbolTable(debugfile).opcode_addresses())

    @classmethod
    def from_symbols(cls, symbols: Dict[str, int]) -> "OpcodeAddresses":
        """Build from an in-memory symbol map instead of a .dbg file.

        Accepts labels with or without the player's `op_` prefix, so both
        a parsed .dbg map and an `asm65.Assembly.symbols` dict (e.g. of a
        relocated player build) work directly.
        """
        addrs = {}
        for name, val in symbols.items():
            if name.startswith("op_"):
                addrs[name[3:]] = val
            elif name in ("header", "terminate", "nop", "ack") or \
                    name.startswith("tick_"):
                addrs.setdefault(name, val)
        self = cls.__new__(cls)
        self._load(addrs)
        return self

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


@dataclass(frozen=True)
class Header:
    mode: VideoMode

    def __post_init__(self):
        require_mode(self.mode)

    def emit(self, addrs: OpcodeAddresses) -> bytes:
        # Header does not vector: the player falls into it after connecting.
        # Padded to tick-opcode size so ACKs stay schedulable.
        return bytes([0xFF] * 6 + [self.mode.value])


@dataclass(frozen=True)
class Tick:
    tick: int  # speaker duty cycle, 4..66 step 2
    page: int  # screen memory page, 32..63
    content: int
    offsets: Tuple[int, int, int, int]

    def __post_init__(self):
        if len(self.offsets) != 4:
            raise ValueError(
                "Wrong number of offsets: %d != 4" % len(self.offsets))

    def emit(self, addrs: OpcodeAddresses) -> bytes:
        a = addrs.tick[(self.tick, self.page)]
        return bytes(
            [a >> 8, a & 0xFF, self.content & 0xFF]
            + [o & 0xFF for o in self.offsets])


@dataclass(frozen=True)
class Ack:
    aux_active: bool

    def emit(self, addrs: OpcodeAddresses) -> bytes:
        a = addrs.ack
        # 0x54/0x55: page-2 soft-switch byte steering MAIN/AUX stores,
        # self-modified into the player's STA $C0xx (main.s:1290-1344).
        return bytes([a >> 8, a & 0xFF, 0x55 if self.aux_active else 0x54,
                      0xFF])


@dataclass(frozen=True)
class Terminate:
    def emit(self, addrs: OpcodeAddresses) -> bytes:
        a = addrs.terminate
        return bytes([a >> 8, a & 0xFF])


@dataclass(frozen=True)
class Nop:
    def emit(self, addrs: OpcodeAddresses) -> bytes:
        a = addrs.nop
        return bytes([a >> 8, a & 0xFF])


def emit_opcode(op, addrs: Optional[OpcodeAddresses] = None) -> bytes:
    """Compile one opcode to stream bytes (the reference's Machine.emit)."""
    return op.emit(addrs or default_addresses())


def audio_level_to_tick(au: int) -> int:
    """Map a 5-bit audio level (-15..16) to a speaker duty cycle (4..66).

    Parity: reference transcoder/movie.py:104-107 (34 cycles = PCM zero).
    """
    return au * 2 + 34


# Stream-framing constants (frozen ABI, see stream/framing.py)
FRAME_BYTES = 2048  # W5100 RX window the player drains per ACK
TICK_BYTES = 7  # addr(2) + content(1) + offsets(4)
HEADER_BYTES = 7
ACK_BYTES = 4
# ops per 2KB frame: first frame fits header + 291 ticks = 2044 bytes + ACK;
# every later frame fits exactly 292 ticks = 2044 bytes + ACK.
OPS_FIRST_FRAME = 291
OPS_PER_FRAME = 292
