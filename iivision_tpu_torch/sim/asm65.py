"""A cc65-subset 6502 assembler: assembles the vendored player source (the
port's copy of iivision_tpu/sim/asm65.py; data files come through `DATA_DIR`).

The player (`data/player/main.s`) is the frozen ABI this framework encodes
against.  Its build product - the cc65 debug symbol table `iivision.dbg` -
is vendored and operationally authoritative, but without the toolchain the
repo could not regenerate or cross-check it.  This module assembles the
player source directly (macros, segments, cheap locals, cc65 expression
syntax) and `validate_against_dbg` asserts that every label lands on the
address the vendored .dbg records - proving source, symbol table, and the
stream ISA (stream/opcodes.py) are one consistent artifact, and producing
an executable memory image for the 65C02 simulator (sim/machine65.py).

Supported subset (everything main.s uses): .macro/.endmacro (with
parameters and nested invocation), .ident/.concat/.string, .segment,
.proc/.endproc, .byte/.word, .include (ignored), .DEBUGINFO (ignored),
equates, cheap local labels (@x), unary </>/ lo/hi byte operators, the
documented 6502 instruction set + 65C02 additions, and cc65's
zeropage-vs-absolute operand sizing rule (zp only when the operand value
is already known and fits a byte).
"""

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from iivision_tpu_torch import DATA_DIR

# the vendored player source, read by path from the data directory
PLAYER_SOURCE = os.path.join(DATA_DIR, "player", "main.s")

# --- instruction tables -------------------------------------------------------

# mode keys: imp acc imm zp zpx zpy abs absx absy ind indx indy rel
OPCODES: Dict[str, Dict[str, int]] = {
    "ADC": dict(imm=0x69, zp=0x65, zpx=0x75, abs=0x6D, absx=0x7D, absy=0x79,
                indx=0x61, indy=0x71),
    "AND": dict(imm=0x29, zp=0x25, zpx=0x35, abs=0x2D, absx=0x3D, absy=0x39,
                indx=0x21, indy=0x31),
    "ASL": dict(acc=0x0A, zp=0x06, zpx=0x16, abs=0x0E, absx=0x1E),
    "BCC": dict(rel=0x90), "BCS": dict(rel=0xB0), "BEQ": dict(rel=0xF0),
    "BIT": dict(zp=0x24, abs=0x2C),
    "BMI": dict(rel=0x30), "BNE": dict(rel=0xD0), "BPL": dict(rel=0x10),
    "BRA": dict(rel=0x80),  # 65C02
    "BRK": dict(imp=0x00),
    "BVC": dict(rel=0x50), "BVS": dict(rel=0x70),
    "CLC": dict(imp=0x18), "CLD": dict(imp=0xD8), "CLI": dict(imp=0x58),
    "CLV": dict(imp=0xB8),
    "CMP": dict(imm=0xC9, zp=0xC5, zpx=0xD5, abs=0xCD, absx=0xDD, absy=0xD9,
                indx=0xC1, indy=0xD1),
    "CPX": dict(imm=0xE0, zp=0xE4, abs=0xEC),
    "CPY": dict(imm=0xC0, zp=0xC4, abs=0xCC),
    "DEC": dict(zp=0xC6, zpx=0xD6, abs=0xCE, absx=0xDE),
    "DEX": dict(imp=0xCA), "DEY": dict(imp=0x88),
    "EOR": dict(imm=0x49, zp=0x45, zpx=0x55, abs=0x4D, absx=0x5D, absy=0x59,
                indx=0x41, indy=0x51),
    "INC": dict(zp=0xE6, zpx=0xF6, abs=0xEE, absx=0xFE),
    "INX": dict(imp=0xE8), "INY": dict(imp=0xC8),
    "JMP": dict(abs=0x4C, ind=0x6C),
    "JSR": dict(abs=0x20),
    "LDA": dict(imm=0xA9, zp=0xA5, zpx=0xB5, abs=0xAD, absx=0xBD, absy=0xB9,
                indx=0xA1, indy=0xB1),
    "LDX": dict(imm=0xA2, zp=0xA6, zpy=0xB6, abs=0xAE, absy=0xBE),
    "LDY": dict(imm=0xA0, zp=0xA4, zpx=0xB4, abs=0xAC, absx=0xBC),
    "LSR": dict(acc=0x4A, zp=0x46, zpx=0x56, abs=0x4E, absx=0x5E),
    "NOP": dict(imp=0xEA),
    "ORA": dict(imm=0x09, zp=0x05, zpx=0x15, abs=0x0D, absx=0x1D, absy=0x19,
                indx=0x01, indy=0x11),
    "PHA": dict(imp=0x48), "PHP": dict(imp=0x08),
    "PHX": dict(imp=0xDA), "PHY": dict(imp=0x5A),  # 65C02
    "PLA": dict(imp=0x68), "PLP": dict(imp=0x28),
    "PLX": dict(imp=0xFA), "PLY": dict(imp=0x7A),  # 65C02
    "ROL": dict(acc=0x2A, zp=0x26, zpx=0x36, abs=0x2E, absx=0x3E),
    "ROR": dict(acc=0x6A, zp=0x66, zpx=0x76, abs=0x6E, absx=0x7E),
    "RTI": dict(imp=0x40), "RTS": dict(imp=0x60),
    "SBC": dict(imm=0xE9, zp=0xE5, zpx=0xF5, abs=0xED, absx=0xFD, absy=0xF9,
                indx=0xE1, indy=0xF1),
    "SEC": dict(imp=0x38), "SED": dict(imp=0xF8), "SEI": dict(imp=0x78),
    "STA": dict(zp=0x85, zpx=0x95, abs=0x8D, absx=0x9D, absy=0x99,
                indx=0x81, indy=0x91),
    "STX": dict(zp=0x86, zpy=0x96, abs=0x8E),
    "STY": dict(zp=0x84, zpx=0x94, abs=0x8C),
    "STZ": dict(zp=0x64, zpx=0x74, abs=0x9C, absx=0x9E),  # 65C02
    "TAX": dict(imp=0xAA), "TAY": dict(imp=0xA8),
    "TSX": dict(imp=0xBA), "TXA": dict(imp=0x8A), "TXS": dict(imp=0x9A),
    "TYA": dict(imp=0x98),
}

MODE_SIZE = dict(imp=1, acc=1, imm=2, zp=2, zpx=2, zpy=2, rel=2,
                 abs=3, absx=3, absy=3, ind=3, indx=2, indy=2)


class AsmError(Exception):
    pass


# --- expression evaluation ----------------------------------------------------

_NUM_RE = re.compile(r"\$[0-9a-fA-F]+|%[01]+|\d+")
_IDENT_RE = re.compile(r"[A-Za-z_@][A-Za-z0-9_]*")


class ExprParser:
    """cc65-style expression evaluator over a symbol table.

    Returns int or raises KeyError when a referenced symbol is undefined
    (callers treat that as 'unknown yet' in pass 1).
    """

    def __init__(self, symbols: Dict[str, int], local_prefix: str = ""):
        self.symbols = symbols
        self.local_prefix = local_prefix

    def parse(self, text: str) -> int:
        self.toks = self._tokenize(text)
        self.pos = 0
        val = self._expr()
        if self.pos != len(self.toks):
            raise AsmError("trailing tokens in expression: %r" % text)
        return val

    def _tokenize(self, text: str) -> List[str]:
        toks = []
        i = 0
        while i < len(text):
            c = text[i]
            if c.isspace():
                i += 1
                continue
            if c == "$" or c == "%" or c.isdigit():
                m = _NUM_RE.match(text, i)
                if not m:
                    raise AsmError("bad number at %r" % text[i:])
                toks.append(m.group(0))
                i = m.end()
            elif c.isalpha() or c in "_@":
                m = _IDENT_RE.match(text, i)
                toks.append(m.group(0))
                i = m.end()
            elif text.startswith("<<", i) or text.startswith(">>", i):
                toks.append(text[i:i + 2])
                i += 2
            elif c in "+-*/()<>&|^~":
                toks.append(c)
                i += 1
            else:
                raise AsmError("bad char %r in expression %r" % (c, text))
        return toks

    def _peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def _next(self):
        t = self._peek()
        self.pos += 1
        return t

    # precedence (low->high): | ^ & ; << >> ; + - ; * / ; unary
    def _expr(self):
        v = self._xor()
        while self._peek() == "|":
            self._next()
            v |= self._xor()
        return v

    def _xor(self):
        v = self._and()
        while self._peek() == "^":
            self._next()
            v ^= self._and()
        return v

    def _and(self):
        v = self._shift()
        while self._peek() == "&":
            self._next()
            v &= self._shift()
        return v

    def _shift(self):
        v = self._add()
        while self._peek() in ("<<", ">>"):
            op = self._next()
            rhs = self._add()
            v = (v << rhs) if op == "<<" else (v >> rhs)
        return v

    def _add(self):
        v = self._mul()
        while self._peek() in ("+", "-"):
            op = self._next()
            rhs = self._mul()
            v = v + rhs if op == "+" else v - rhs
        return v

    def _mul(self):
        v = self._unary()
        while self._peek() in ("*", "/"):
            op = self._next()
            rhs = self._unary()
            v = v * rhs if op == "*" else v // rhs
        return v

    def _unary(self):
        t = self._peek()
        if t == "<":  # low byte
            self._next()
            return self._unary() & 0xFF
        if t == ">":  # high byte
            self._next()
            return (self._unary() >> 8) & 0xFF
        if t == "-":
            self._next()
            return -self._unary()
        if t == "~":
            self._next()
            return ~self._unary()
        if t == "(":
            self._next()
            v = self._expr()
            if self._next() != ")":
                raise AsmError("missing )")
            return v
        return self._atom()

    def _atom(self):
        t = self._next()
        if t is None:
            raise AsmError("unexpected end of expression")
        if t.startswith("$"):
            return int(t[1:], 16)
        if t.startswith("%"):
            return int(t[1:], 2)
        if t[0].isdigit():
            return int(t, 10)
        name = t
        if name.startswith("@"):
            name = self.local_prefix + name
        return self.symbols[name]  # KeyError => undefined (pass 1)


# --- source preprocessing -----------------------------------------------------

def _strip_comment(line: str) -> str:
    """Remove ; comments (main.s uses no string literals outside .concat,
    where quotes protect the semicolon-free strings)."""
    out = []
    in_str = False
    for c in line:
        if c == '"':
            in_str = not in_str
        if c == ";" and not in_str:
            break
        out.append(c)
    return "".join(out).rstrip()


_IDENT_CALL_RE = re.compile(r"\.ident\s*\(", re.IGNORECASE)
_STRING_CALL_RE = re.compile(r"\.string\s*\(\s*([^)]*?)\s*\)", re.IGNORECASE)
_CONCAT_CALL_RE = re.compile(r"\.concat\s*\(", re.IGNORECASE)


def _find_paren_span(text: str, open_idx: int) -> int:
    depth = 0
    for i in range(open_idx, len(text)):
        if text[i] == "(":
            depth += 1
        elif text[i] == ")":
            depth -= 1
            if depth == 0:
                return i
    raise AsmError("unbalanced parens: %r" % text)


def expand_idents(line: str) -> str:
    """Resolve .ident(.concat(...)) constructs to plain identifiers."""
    while True:
        m = _IDENT_CALL_RE.search(line)
        if not m:
            return line
        open_idx = line.index("(", m.start())
        close_idx = _find_paren_span(line, open_idx)
        inner = line[open_idx + 1:close_idx].strip()
        name = _eval_string_expr(inner)
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
            raise AsmError("bad .ident result %r" % name)
        line = line[:m.start()] + name + line[close_idx + 1:]


def _eval_string_expr(text: str) -> str:
    """Evaluate a cc65 string expression: literal, .string(num), .concat."""
    text = text.strip()
    m = _CONCAT_CALL_RE.match(text)
    if m:
        open_idx = text.index("(")
        close_idx = _find_paren_span(text, open_idx)
        inner = text[open_idx + 1:close_idx]
        parts = _split_args(inner)
        return "".join(_eval_string_expr(p) for p in parts)
    m = _STRING_CALL_RE.match(text)
    if m:
        arg = m.group(1).strip()
        return str(int(arg, 0))  # numeric literal after macro substitution
    if text.startswith('"') and text.endswith('"'):
        return text[1:-1]
    raise AsmError("unsupported string expression %r" % text)


def _split_args(text: str) -> List[str]:
    """Split on commas at paren/quote depth 0."""
    parts, depth, cur, in_str = [], 0, [], False
    for c in text:
        if c == '"':
            in_str = not in_str
        if not in_str:
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
            elif c == "," and depth == 0:
                parts.append("".join(cur).strip())
                cur = []
                continue
        cur.append(c)
    if cur:
        parts.append("".join(cur).strip())
    return parts


# --- macro expansion ----------------------------------------------------------

@dataclass
class Macro:
    name: str
    params: List[str]
    body: List[str]


def _substitute_params(line: str, params: List[str], args: List[str]) -> str:
    """Replace parameter identifiers with argument text (token-wise)."""
    if not params:
        return line
    mapping = dict(zip(params, args))

    def repl(m):
        return mapping.get(m.group(0), m.group(0))

    return re.sub(r"[A-Za-z_][A-Za-z0-9_]*", repl, line)


class Preprocessor:
    """Collect macros and produce a fully expanded line stream."""

    def __init__(self):
        self.macros: Dict[str, Macro] = {}
        self._expand_counter = 0

    def run(self, lines: List[str]) -> List[str]:
        out: List[str] = []
        i = 0
        while i < len(lines):
            line = _strip_comment(lines[i])
            stripped = line.strip()
            low = stripped.lower()
            if low.startswith(".macro"):
                rest = stripped[len(".macro"):].strip()
                parts = rest.split(None, 1)
                name = parts[0]
                params = (_split_args(parts[1]) if len(parts) > 1 else [])
                body = []
                i += 1
                while i < len(lines):
                    b = _strip_comment(lines[i])
                    if b.strip().lower().startswith(".endmacro"):
                        break
                    body.append(b)
                    i += 1
                else:
                    raise AsmError("missing .endmacro for %s" % name)
                self.macros[name] = Macro(name, params, body)
                i += 1
                continue
            expanded = self._maybe_expand(stripped)
            if expanded is None:
                out.append(line)
            else:
                out.extend(self.run(expanded))
            i += 1
        return out

    def _maybe_expand(self, stripped: str) -> Optional[List[str]]:
        if not stripped:
            return None
        m = re.match(r"([A-Za-z_][A-Za-z0-9_]*)\b\s*(.*)$", stripped)
        if not m or m.group(1) not in self.macros:
            return None
        mac = self.macros[m.group(1)]
        args = _split_args(m.group(2)) if m.group(2).strip() else []
        if len(args) != len(mac.params):
            raise AsmError("macro %s expects %d args, got %d (%r)"
                           % (mac.name, len(mac.params), len(args), stripped))
        return [_substitute_params(b, mac.params, args) for b in mac.body]


# --- the assembler ------------------------------------------------------------

DEFAULT_SEGMENTS = {"LOWCODE": 0x0800, "HGR": 0x2000, "CODE": 0x4000}


@dataclass
class Assembly:
    image: bytearray  # 64KB memory image
    symbols: Dict[str, int]
    segments: Dict[str, List[Tuple[int, int]]]  # name -> [(start, end)]
    entry: int = 0x0800

    def symbol(self, name: str) -> int:
        return self.symbols[name]


@dataclass
class _Item:
    """One sized piece of output (instruction or data) for pass 2."""
    addr: int
    kind: str  # "ins" | "bytes"
    mnemonic: str = ""
    mode: str = ""
    operand_expr: str = ""
    local_prefix: str = ""
    data_exprs: List[str] = field(default_factory=list)
    width: int = 1  # for .byte/.word element width
    line: str = ""


class Assembler:
    def __init__(self, segments: Optional[Dict[str, int]] = None):
        self.seg_base = dict(segments or DEFAULT_SEGMENTS)
        self.symbols: Dict[str, int] = {}
        self.items: List[_Item] = []
        self.seg_ranges: Dict[str, List[Tuple[int, int]]] = {}

    # pass 1: layout + label definition
    def assemble(self, source: str) -> Assembly:
        pre = Preprocessor()
        lines = pre.run(source.splitlines())

        seg_pc = dict(self.seg_base)  # next free address per segment
        seg = "CODE"
        pc = seg_pc.get(seg, 0)
        local_scope = ""
        n_scopes = 0

        for raw in lines:
            line = raw.strip()
            if not line:
                continue
            line = expand_idents(line)

            # labels (possibly several) at line start
            while True:
                m = re.match(r"^(@[A-Za-z0-9_]+|[A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)$",
                             line)
                if not m:
                    break
                label, line = m.group(1), m.group(2).strip()
                if label.startswith("@"):
                    self._define(local_scope + label, pc)
                else:
                    self._define(label, pc)
                    local_scope = label + "::"

            if not line:
                continue

            low = line.lower()
            if low.startswith(".include") or low.startswith(".debuginfo") \
                    or low.startswith(".endproc"):
                continue
            if low.startswith(".proc"):
                name = line.split()[1]
                self._define(name, pc)
                local_scope = name + "::"
                n_scopes += 1
                continue
            if low.startswith(".segment"):
                # save current position, switch segment
                seg_pc[seg] = pc
                m = re.match(r'\.segment\s+"(\w+)"', line, re.IGNORECASE)
                if not m:
                    raise AsmError("bad .segment: %r" % line)
                seg = m.group(1)
                if seg not in seg_pc:
                    raise AsmError("segment %s has no base address" % seg)
                pc = seg_pc[seg]
                self.seg_ranges.setdefault(seg, []).append((pc, pc))
                continue
            if low.startswith(".byte") or low.startswith(".word") \
                    or low.startswith(".addr"):
                width = 1 if low.startswith(".byte") else 2
                exprs = _split_args(line.split(None, 1)[1])
                self.items.append(_Item(
                    addr=pc, kind="bytes", data_exprs=exprs, width=width,
                    local_prefix=local_scope, line=raw))
                pc += width * len(exprs)
                continue

            # equate?
            m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(.+)$", line)
            if m:
                val = ExprParser(self.symbols).parse(m.group(2))
                self._define(m.group(1), val)
                continue

            # instruction
            mn, _, rest = line.partition(" ")
            mn = mn.upper()
            if mn not in OPCODES:
                raise AsmError("unknown instruction %r in line %r"
                               % (mn, raw))
            mode, operand = self._classify(mn, rest.strip(), local_scope)
            self.items.append(_Item(
                addr=pc, kind="ins", mnemonic=mn, mode=mode,
                operand_expr=operand, local_prefix=local_scope, line=raw))
            pc += MODE_SIZE[mode]

        seg_pc[seg] = pc
        # record segment extents
        for name, base in self.seg_base.items():
            end = seg_pc.get(name, base)
            self.seg_ranges.setdefault(name, [(base, end)])

        # pass 2: emit
        image = bytearray(65536)
        for it in self.items:
            self._emit(it, image)

        return Assembly(image=image, symbols=dict(self.symbols),
                        segments=dict(self.seg_ranges),
                        entry=self.seg_base.get("LOWCODE", 0x0800))

    def _define(self, name: str, val: int):
        if name in self.symbols and self.symbols[name] != val:
            raise AsmError("redefinition of %s (%04x -> %04x)"
                           % (name, self.symbols[name], val))
        self.symbols[name] = val

    def _classify(self, mn: str, operand: str,
                  local_scope: str) -> Tuple[str, str]:
        """Pick the addressing mode (cc65 sizing rule for zp vs abs)."""
        modes = OPCODES[mn]
        if not operand or operand.upper() == "A" and "acc" in modes:
            if not operand:
                return (("imp" in modes and "imp") or "acc", "")
            return "acc", ""
        if "rel" in modes:
            return "rel", operand
        if operand.startswith("#"):
            return "imm", operand[1:]
        if operand.startswith("(") and mn == "JMP":
            return "ind", operand[1:operand.rindex(")")]
        m = re.match(r"^(.*?),\s*([XxYy])$", operand, re.DOTALL)
        idx = None
        if m and not (operand.startswith("(")
                      and operand.rindex(")") > m.start(2)):
            operand, idx = m.group(1).strip(), m.group(2).upper()
        # indirect indexed? (not used by main.s, but cheap to support)
        if operand.startswith("("):
            inner = operand[1:operand.rindex(")")]
            return ("indy" if idx == "Y" else "indx"), inner
        # zp vs abs: zp only when the value is already resolvable and fits
        try:
            val = ExprParser(self.symbols, local_scope).parse(operand)
            small = 0 <= val <= 0xFF
        except (KeyError, AsmError):
            small = False
        if idx == "X":
            mode = "zpx" if small and "zpx" in modes else "absx"
        elif idx == "Y":
            mode = "zpy" if small and "zpy" in modes else "absy"
        else:
            mode = "zp" if small and "zp" in modes else "abs"
        if mode not in modes:
            raise AsmError("%s does not support mode %s (%r)"
                           % (mn, mode, operand))
        return mode, operand

    def _emit(self, it: _Item, image: bytearray):
        ep = ExprParser(self.symbols, it.local_prefix)
        if it.kind == "bytes":
            pc = it.addr
            for ex in it.data_exprs:
                v = ep.parse(ex)
                image[pc] = v & 0xFF
                if it.width == 2:
                    image[pc + 1] = (v >> 8) & 0xFF
                pc += it.width
            return
        opcode = OPCODES[it.mnemonic][it.mode]
        image[it.addr] = opcode
        size = MODE_SIZE[it.mode]
        if size == 1:
            return
        val = ep.parse(it.operand_expr)
        if it.mode == "rel":
            off = val - (it.addr + 2)
            if not -128 <= off <= 127:
                raise AsmError("branch out of range at %r" % it.line)
            image[it.addr + 1] = off & 0xFF
        elif size == 2:
            if not -255 <= val <= 0xFF:
                if it.mode == "imm":
                    raise AsmError("immediate out of range: %r" % it.line)
                raise AsmError("zp operand out of range: %r" % it.line)
            image[it.addr + 1] = val & 0xFF
        else:
            image[it.addr + 1] = val & 0xFF
            image[it.addr + 2] = (val >> 8) & 0xFF


def assemble_player(source_path: Optional[str] = None) -> Assembly:
    """Assemble the vendored player main.s with its linker-config layout."""
    if source_path is None:
        source_path = PLAYER_SOURCE
    with open(source_path) as f:
        return Assembler().assemble(f.read())


def dbg_labels(dbg_path: str) -> Dict[str, int]:
    """All label symbols (name -> addr) from a cc65 .dbg file."""
    out = {}
    with open(dbg_path) as f:
        for line in f:
            if not line.startswith("sym"):
                continue
            fields = dict(kv.split("=", 1)
                          for kv in line.split("\t")[1].strip().split(","))
            if fields.get("type") != "lab":
                continue
            name = fields["name"].strip('"')
            out[name] = int(fields["val"], 16)
    return out


def validate_against_dbg(asm: Assembly,
                         dbg_path: Optional[str] = None) -> Dict[str, int]:
    """Assert every shared label matches the vendored .dbg addresses.

    Returns the compared {name: addr} map (raises on any mismatch).
    """
    if dbg_path is None:
        dbg_path = os.path.join(DATA_DIR, "iivision.dbg")
    want = dbg_labels(dbg_path)
    compared = {}
    mismatches = []
    for name, addr in asm.symbols.items():
        if "::" in name or name not in want:
            continue
        if want[name] != addr:
            mismatches.append((name, addr, want[name]))
        compared[name] = addr
    if mismatches:
        raise AsmError("label mismatches vs .dbg: %s"
                       % mismatches[:10])
    return compared
