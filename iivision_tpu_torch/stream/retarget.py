"""Player/transcoder version coupling: fingerprint, detection, retargeting
(the port's copy of iivision_tpu/stream/retarget.py).

The transcoder compiles a movie against one player binary's opcode entry
addresses (stream/symbols.py); a stream played on a different player build
vectors the 6502 into garbage.  The reference lists the fix as a future
improvement (reference README.md:227-233 "Looser coupling between player and
transcoder version"): maintain a version identity for the player's symbol
addresses, detect a mismatched player/transcoder pair, and let the video
server "translate on the fly by interpreting the byte stream and mapping old
offsets to the appropriate values for the current player version".  All three
are implemented here against the frozen stream grammar (stream/opcodes.py):

  - ``fingerprint(addrs)``: a content-addressed version identity over the
    full opcode address map.  Two player builds share a fingerprint iff every
    stream valid for one is bit-valid for the other, so there is no manually
    incremented version counter to forget (the reference's "require the
    version to be incremented" workflow falls out for free).
  - ``identify(stream, candidates)``: which known player build a stream was
    compiled against, by walking the stream grammar under each address map.
  - ``retarget(stream, old, new)``: rewrite every opcode address from one
    build's map to another's.  Addresses are always exactly 2 bytes, so the
    rewrite is length-preserving: the 2KB/ACK framing, all inline data and
    the terminate padding survive byte-for-byte.

``server.py --known-dbg/--player-dbg`` uses these to serve archived streams
to a newer player build; ``python -m iivision_tpu_torch.stream.retarget`` is the
offline tool.
"""

import argparse
import hashlib
import sys
from typing import Dict, Iterator, Optional, Sequence, Tuple

from iivision_tpu_torch.stream.opcodes import (
    HEADER_BYTES, OpcodeAddresses, default_addresses)


class StreamFormatError(ValueError):
    """The byte stream does not parse under the given player address map."""

    def __init__(self, msg: str, pos: int):
        super().__init__("%s (at byte %d)" % (msg, pos))
        self.pos = pos


def fingerprint(addrs: Optional[OpcodeAddresses] = None) -> str:
    """Content-addressed player-version identity (sha256 hex).

    Hashes the canonical serialization of the complete opcode address map -
    the exact coupling surface between transcoder and player (reference
    transcoder/opcodes.py:168-217 reads these same symbols at import time).
    """
    a = addrs or default_addresses()
    items = ["header=%04x" % a.header, "ack=%04x" % a.ack,
             "terminate=%04x" % a.terminate, "nop=%04x" % a.nop]
    items += ["tick_%d_page_%d=%04x" % (t, p, a.tick[(t, p)])
              for (t, p) in sorted(a.tick)]
    return hashlib.sha256("\n".join(items).encode()).hexdigest()


def _reverse_map(addrs: OpcodeAddresses) -> Dict[int, Tuple[str, object]]:
    """addr -> (kind, key); raises if two opcodes share an entry address."""
    rev: Dict[int, Tuple[str, object]] = {}

    def put(addr, kind, key):
        if addr in rev:
            raise ValueError(
                "address map is ambiguous: $%04X is both %s and %s"
                % (addr, rev[addr][0], kind))
        rev[addr] = (kind, key)

    put(addrs.ack, "ack", None)
    put(addrs.terminate, "terminate", None)
    put(addrs.nop, "nop", None)
    for key, a in addrs.tick.items():
        put(a, "tick", key)
    return rev


def walk(data: bytes, addrs: Optional[OpcodeAddresses] = None
         ) -> Iterator[Tuple[int, str, object]]:
    """Yield (pos, kind, key) for every opcode of a well-formed stream.

    kinds: "header" (key = video-mode byte), "tick" (key = (duty, page)),
    "ack" (key = aux_active bool), "nop", "terminate".  Raises
    StreamFormatError on the first byte that violates the grammar.  This is
    the host-side lenient twin of the native VM decoder (sim/player_vm):
    it checks addresses and structure, not screen/duty semantics.
    """
    addrs = addrs or default_addresses()
    rev = _reverse_map(addrs)
    n = len(data)
    if n < HEADER_BYTES:
        raise StreamFormatError("truncated header", 0)
    if data[:6] != b"\xff" * 6:
        raise StreamFormatError("bad header padding", 0)
    if data[6] not in (0, 1):
        raise StreamFormatError("bad video-mode byte %d" % data[6], 6)
    yield 0, "header", data[6]

    pos = HEADER_BYTES
    while True:
        if pos + 2 > n:
            raise StreamFormatError("truncated opcode", pos)
        addr = (data[pos] << 8) | data[pos + 1]
        ent = rev.get(addr)
        if ent is None:
            raise StreamFormatError("unknown opcode address $%04X" % addr,
                                    pos)
        kind, key = ent
        if kind == "tick":
            if pos + 7 > n:
                raise StreamFormatError("truncated tick data", pos)
            yield pos, kind, key
            pos += 7
        elif kind == "ack":
            if pos + 4 > n:
                raise StreamFormatError("truncated ack data", pos)
            if data[pos + 2] not in (0x54, 0x55):
                raise StreamFormatError(
                    "bad ack soft-switch byte $%02X" % data[pos + 2], pos + 2)
            if data[pos + 3] != 0xFF:
                raise StreamFormatError("bad ack pad byte", pos + 3)
            if (pos + 4) % 2048 != 0:
                raise StreamFormatError("ack not on a 2KB frame boundary",
                                        pos)
            yield pos, kind, data[pos + 2] == 0x55
            pos += 4
        elif kind == "nop":
            yield pos, kind, None
            pos += 2
        else:  # terminate
            yield pos, kind, None
            pos += 2
            pad = n - pos
            if pad >= 2048 or n % 2048 != 0:
                raise StreamFormatError(
                    "stream does not end on the 2KB boundary after "
                    "terminate", pos)
            if any(data[pos:]):
                raise StreamFormatError("nonzero terminate padding", pos)
            return


def retarget(data: bytes, old: Optional[OpcodeAddresses] = None,
             new: Optional[OpcodeAddresses] = None) -> bytes:
    """Rewrite a stream's opcode addresses from `old`'s map to `new`'s.

    Length-preserving (addresses are always 2 bytes); inline data, framing
    and padding are copied verbatim.  retarget(retarget(s, a, b), b, a) == s.
    """
    old = old or default_addresses()
    new = new or default_addresses()
    out = bytearray(data)
    for pos, kind, key in walk(data, old):
        if kind == "tick":
            a = new.tick[key]
        elif kind == "ack":
            a = new.ack
        elif kind == "nop":
            a = new.nop
        elif kind == "terminate":
            a = new.terminate
        else:  # header carries no address
            continue
        out[pos] = a >> 8
        out[pos + 1] = a & 0xFF
    return bytes(out)


def identify(data: bytes,
             candidates: Sequence[Tuple[object, OpcodeAddresses]]):
    """Return the key of the first candidate address map the stream parses
    under (reference README.md:231 "detect when the symbol addresses have
    changed ... by maintaining a cache of versions and symbol addresses").

    Raises StreamFormatError (of the longest successful parse) if none match.
    """
    best_err = None
    for key, addrs in candidates:
        try:
            for _ in walk(data, addrs):
                pass
            return key
        except StreamFormatError as e:
            if best_err is None or e.pos > best_err.pos:
                best_err = e
    raise best_err if best_err is not None else ValueError("no candidates")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Retarget an .a2m stream to a different player build "
                    "(or print a player build's version fingerprint).")
    ap.add_argument("stream", nargs="?", help="Input .a2m file")
    ap.add_argument("-o", "--output", help="Output .a2m file")
    ap.add_argument("--from-dbg", action="append", default=[],
                    metavar="DBG", help="Candidate source player .dbg "
                    "(repeatable; auto-identified among them). Default: "
                    "the vendored player.")
    ap.add_argument("--to-dbg", metavar="DBG",
                    help="Target player .dbg. Default: the vendored player.")
    ap.add_argument("--fingerprint", metavar="DBG", nargs="?", const="",
                    help="Print the version fingerprint of a player .dbg "
                    "(default: the vendored player) and exit.")
    args = ap.parse_args(argv)

    if args.fingerprint is not None:
        addrs = (OpcodeAddresses(args.fingerprint) if args.fingerprint
                 else default_addresses())
        print(fingerprint(addrs))
        return 0

    if not args.stream or not args.output:
        ap.error("stream and -o/--output are required (or --fingerprint)")
    data = open(args.stream, "rb").read()
    cands = ([(p, OpcodeAddresses(p)) for p in args.from_dbg]
             or [("<vendored>", default_addresses())])
    src = identify(data, cands)
    old = dict(cands)[src]
    new = OpcodeAddresses(args.to_dbg) if args.to_dbg else default_addresses()
    out = retarget(data, old, new)
    with open(args.output, "wb") as f:
        f.write(out)
    print("retargeted %d bytes: %s (%s) -> %s" %
          (len(out), src, fingerprint(old)[:12], fingerprint(new)[:12]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
