"""Frozen for the benchmark's reference: a copy of
iivision_tpu_torch/stream/symbols.py, which this package never imports.

cc65 .dbg symbol-table parser (the port's copy of
iivision_tpu/stream/symbols.py).

The transcoder targets the player's opcode entry addresses, read from the
cc65 debug file emitted when the player is assembled.  The shipped one is
`DATA_DIR/iivision.dbg`, read by path.  Each line is `<kind>\\t<csv of
k=v>`; only `sym` lines matter, e.g.

    sym	id=907,name="op_ack",addrsize=absolute,...,val=0x8007,...
"""

import os
import re
from typing import Dict, Optional

from benchmark.reference import DATA_DIR

DEFAULT_DBG = os.path.join(DATA_DIR, "iivision.dbg")

# one k=v field of a sym line; values are either "quoted" or bare tokens
_FIELD = re.compile(r'([A-Za-z]+)=("[^"]*"|[^,]*)')


class SymbolFormatError(ValueError):
    """A .dbg sym record is missing a field the stream ABI requires."""


class SymbolTable:
    """Parses cc65 `sym` lines of a .dbg file into {name: {key: value}}."""

    def __init__(self, debugfile: Optional[str] = None):
        self.debugfile = debugfile or DEFAULT_DBG

    def parse(self) -> Dict[str, Dict]:
        syms: Dict[str, Dict] = {}
        with open(self.debugfile, "r") as f:
            for line in f:
                kind, _, rest = line.rstrip("\n").partition("\t")
                if kind != "sym":
                    continue
                sym = {m.group(1): m.group(2)
                       for m in _FIELD.finditer(rest)}
                name = sym.get("name")
                if name is not None:
                    syms[name] = sym
        return syms

    def opcode_addresses(self) -> Dict[str, int]:
        """{opcode name: entry address} for all `op_*` player labels, the
        quotes and the op_ prefix stripped ('tick_34_page_40' -> 0x....)."""
        out = {}
        for name, data in self.parse().items():
            stripped = name.strip('"')
            if not stripped.startswith("op_"):
                continue
            val = data.get("val")
            if val is None:
                raise SymbolFormatError(
                    "sym %r has no val= field in %s"
                    % (stripped, self.debugfile))
            try:
                out[stripped[3:]] = int(val, 16)
            except ValueError:
                raise SymbolFormatError(
                    "sym %r has non-hex val=%r in %s"
                    % (stripped, val, self.debugfile))
        return out
