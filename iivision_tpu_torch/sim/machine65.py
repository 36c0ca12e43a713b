"""Run the assembled player on the 6502 Apple IIe machine (csrc/apple2_vm;
the port's copy of iivision_tpu/sim/machine65.py).

This is end-to-end hardware-level verification: `play_stream` assembles the
vendored player source (asm65.py - every label validated against the frozen
.dbg), loads the image into a simulated 64K Apple IIe with a W5100 model,
connects the `.a2m` byte stream as the TCP feed, and executes the player
instruction-by-instruction with cycle accounting.  Callers can then assert:

- final MAIN/AUX hires screen memory == the encoder's model (the parity
  clause at the machine level, not just the opcode-ABI level);
- speaker tick cadence: ticks must fall exactly 73 cycles apart pairwise
  per opcode with the stream's duty cycles (the audio DAC contract,
  main.s:366-398);
- the decode loop's register/bank invariants held for the whole run.
"""

import ctypes
import functools
from dataclasses import dataclass

import numpy as np

from iivision_tpu_torch.sim._build import build_so
from iivision_tpu_torch.sim import asm65

EXIT_NAMES = {0: "TERMINATED", 1: "PRODOS_QUIT", 2: "MAX_CYCLES",
              3: "BRK", 4: "STALL", 5: "UNDOCUMENTED",
              6: "MLI_UNSUPPORTED"}


@dataclass
class TraceEntry:
    """One executed instruction: state BEFORE execution."""
    pc: int
    op_bytes: tuple  # up to 3 raw bytes at pc (self-modification safe:
    # captured at execution time, not from final memory)
    a: int
    x: int
    y: int
    p: int
    sp: int
    cycles: int

    def disassemble(self, symbols=None) -> str:
        return disassemble_bytes(self.pc, self.op_bytes, symbols)

    def format(self, symbols=None) -> str:
        return ("%04X  %-12s A=%02X X=%02X Y=%02X P=%02X SP=%02X cyc=%d"
                % (self.pc, self.disassemble(symbols), self.a, self.x,
                   self.y, self.p, self.sp, self.cycles))


@functools.lru_cache(None)
def _disasm_table():
    """opcode byte -> (mnemonic, mode) from the assembler's own table."""
    out = {}
    for mnem, modes in asm65.OPCODES.items():
        for mode, byte in modes.items():
            out[byte] = (mnem, mode)
    return out


def disassemble_bytes(pc: int, op_bytes, symbols=None) -> str:
    """Render one instruction (reference simulator/apple2.py:196-204 shape).

    symbols: optional {name: addr} map (e.g. Assembly.symbols) - absolute
    operands matching a symbol render as the name.
    """
    table = _disasm_table()
    b0 = op_bytes[0]
    if b0 not in table:
        return ".byte $%02X" % b0
    mnem, mode = table[b0]
    size = asm65.MODE_SIZE[mode]
    sym = {}
    if symbols:
        sym = {v: k for k, v in sorted(symbols.items(),
                                       key=lambda kv: kv[1], reverse=True)}

    def name16(v):
        return sym.get(v, "$%04X" % v)

    if mode in ("imp", "acc"):
        return mnem
    if mode == "imm":
        return "%s #$%02X" % (mnem, op_bytes[1])
    if mode == "rel":
        # the signed 8-bit offset, in Python integers (numpy 2 refuses to
        # add an integer above 127 to an np.int8)
        dst = (pc + 2 + ((op_bytes[1] ^ 0x80) - 0x80)) & 0xFFFF
        return "%s %s" % (mnem, name16(dst))
    if mode == "zp":
        return "%s $%02X" % (mnem, op_bytes[1])
    if mode == "zpx":
        return "%s $%02X,X" % (mnem, op_bytes[1])
    if mode == "zpy":
        return "%s $%02X,Y" % (mnem, op_bytes[1])
    if mode == "indx":
        return "%s ($%02X,X)" % (mnem, op_bytes[1])
    if mode == "indy":
        return "%s ($%02X),Y" % (mnem, op_bytes[1])
    ad = op_bytes[1] | (op_bytes[2] << 8)
    if mode == "abs":
        return "%s %s" % (mnem, name16(ad))
    if mode == "absx":
        return "%s %s,X" % (mnem, name16(ad))
    if mode == "absy":
        return "%s %s,Y" % (mnem, name16(ad))
    if mode == "ind":
        return "%s (%s)" % (mnem, name16(ad))
    return mnem


def _build_library() -> str:
    return build_so("apple2_vm")


@dataclass
class RunResult:
    exit_reason: str
    cycles: int
    tick_cycles: np.ndarray  # (n_ticks,) cycle time of each speaker access
    main: np.ndarray  # (32, 256) final main hires page ($2000-$3FFF)
    aux: np.ndarray  # (32, 256) final aux hires page
    n_recv: int  # W5100 RECV commands issued (== ACK opcodes executed)
    pc: int
    regs: tuple  # (A, X, Y) at exit
    trace: list = None  # list[TraceEntry] when tracing was requested
    n_executed: int = 0  # total instructions executed (when tracing)
    cout: bytes = b""  # bytes the program printed via the COUT trap
    # (Apple high-ASCII; the player prints retry dots + error strings)

    @property
    def duty_cycles(self) -> np.ndarray:
        """Per-opcode speaker duty: gap between each tick pair.

        The player ticks the speaker exactly twice per 73-cycle opcode
        (N cycles apart = the duty), and keeps the 36/37 cadence through
        the ACK slow path - so pairing consecutive ticks recovers the
        encoded audio levels.
        """
        t = self.tick_cycles
        n = len(t) & ~1  # an aborted run can end mid-pair
        return (t[1:n:2] - t[0:n:2]).astype(np.int64)


class Apple2Player:
    """The vendored player running on the simulated machine."""

    ARGTYPES_BASE = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_uint16, ctypes.c_uint16,
        ctypes.c_uint16, ctypes.c_uint16, ctypes.c_uint16,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
    ]
    KEY_ARGTYPES = [  # scheduled keyboard events (pause/resume testing),
        # connect-failure injection, COUT text capture
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    ARGTYPES = ARGTYPES_BASE + KEY_ARGTYPES

    def __init__(self, assembly=None):
        """assembly: a custom `asm65.Assembly` of the player (e.g. a
        relocated build for stream-retargeting tests). Default: the
        vendored source, validated label-for-label against the frozen
        .dbg; custom builds skip that check (their addresses differ by
        design)."""
        if assembly is None:
            assembly = asm65.assemble_player()
            asm65.validate_against_dbg(assembly)
        self.assembly = assembly
        self._lib = ctypes.CDLL(_build_library())
        self._lib.a2_run.restype = ctypes.c_int64
        self._lib.a2_run.argtypes = self.ARGTYPES

    def run(self, stream: bytes,
            max_cycles: int = 1 << 40, trace=None,
            key_events=None, connect_fails: int = 0,
            terminate_trap: bool = True,
            w5100_slot: int = 1) -> RunResult:
        """Execute the player against `stream`.

        trace: None, or ("first", N) / ("ring", N) to capture the first /
        last N executed instructions (TraceEntry list on the result) -
        the way to locate the first diverging instruction after a
        parity failure.

        key_events: optional [(cycle, code), ...] keyboard schedule: each
        key latches (KBD bit7) once the machine passes its cycle and
        clears on KBDSTRB - drives the player's documented pause/resume
        path (reference README.md v0.2 "Press any key to pause/resume";
        main.s recv keyboard check).

        connect_fails: make the W5100 model fail the first N CONNECT
        commands (status SOCK_CLOSED) - drives the player's 6-attempt
        retry-with-reset loop and its BRK-with-error-message failure
        path (main.s CHECKTEST/FAILED/ERRDONE).  The COUT bytes the
        player prints land on the result's `cout`.

        terminate_trap=False removes the op_terminate entry trap so the
        player's real post-terminate behaviour executes: wait for a
        keypress, then ProDOS QUIT via the MLI vector (exit_reason
        PRODOS_QUIT) - pair with key_events to drive it.
        """
        syms = self.assembly.symbols
        main = np.zeros(65536, np.uint8)
        aux = np.zeros(65536, np.uint8)
        main[:] = np.frombuffer(bytes(self.assembly.image), np.uint8)
        # 2 ticks per data op (7 bytes) + 4 per ACK slow path (4-byte
        # opcode, 2KB cadence) + startup/terminate slack
        tick_cap = (len(stream) // 7 * 2 + len(stream) // 2048 * 4
                    + 4096)
        ticks = np.zeros(tick_cap, np.int64)
        counts = np.zeros(10, np.int64)

        def ptr(arr, ty):
            return arr.ctypes.data_as(ctypes.POINTER(ty))

        trace_mode, trace_cap = _parse_trace(trace)
        trace_buf = np.zeros(max(trace_cap, 1) * 3, np.int64)
        kc, kk, nk = _key_arrays(key_events)
        cout_buf = np.zeros(256, np.uint8)

        rc = self._lib.a2_run(
            ptr(main, ctypes.c_uint8), ptr(aux, ctypes.c_uint8),
            stream, len(stream), max_cycles,
            ptr(ticks, ctypes.c_int64), tick_cap,
            ptr(counts, ctypes.c_int64),
            self.assembly.entry,
            syms["op_terminate"] if terminate_trap else 0xFFFF,
            syms["HGR0"], syms["COUT"], syms["PRODOS"],
            ptr(trace_buf, ctypes.c_int64), trace_cap, trace_mode,
            None if kc is None else ptr(kc, ctypes.c_int64),
            None if kk is None else ptr(kk, ctypes.c_uint8), nk,
            connect_fails, ptr(cout_buf, ctypes.c_uint8), w5100_slot)
        del rc
        if int(counts[0]) > tick_cap:
            # The C core keeps counting but stops logging past the cap; a
            # silently truncated trace would let audio-cadence assertions
            # pass vacuously.  The cap is derived from the stream size, so
            # overflow means that estimate (or the stream) is wrong.
            raise RuntimeError(
                "speaker tick log overflow: %d ticks > cap %d "
                "(trace truncated; tick_cap estimate needs widening)"
                % (int(counts[0]), tick_cap))
        n_ticks = min(int(counts[0]), tick_cap)
        return RunResult(
            exit_reason=EXIT_NAMES.get(int(counts[2]), str(counts[2])),
            cycles=int(counts[1]),
            tick_cycles=ticks[:n_ticks].copy(),
            main=main[0x2000:0x4000].reshape(32, 256).copy(),
            aux=aux[0x2000:0x4000].reshape(32, 256).copy(),
            n_recv=int(counts[4]),
            pc=int(counts[3]),
            regs=(int(counts[6]), int(counts[7]), int(counts[8])),
            trace=_decode_trace(trace_buf, trace_cap, int(counts[9]),
                                trace_mode == 1),
            n_executed=int(counts[9]),
            cout=bytes(cout_buf[:min(int(counts[5]), 256)]),
        )


def _key_arrays(key_events):
    """[(cycle, code), ...] -> (int64 cycles, uint8 codes, n) or nulls."""
    if not key_events:
        return None, None, 0
    ev = sorted(key_events)
    kc = np.asarray([int(c) for c, _ in ev], np.int64)
    kk = np.asarray([int(k) & 0x7F for _, k in ev], np.uint8)
    return kc, kk, len(ev)


def _parse_trace(trace):
    """("first"|"ring", N) -> (mode int, cap int); None -> (0, 0)."""
    if trace is None:
        return 0, 0
    kind, cap = trace
    if kind not in ("first", "ring") or cap <= 0:
        raise ValueError("trace must be ('first'|'ring', N>0), got %r"
                         % (trace,))
    return (1 if kind == "ring" else 0), int(cap)


def _decode_trace(buf: np.ndarray, cap: int, n_trace: int, ring: bool):
    """Unpack the C trace buffer into TraceEntry objects (ring-ordered)."""
    if cap <= 0 or n_trace <= 0:
        return None
    n = min(n_trace, cap)
    e = buf[:cap * 3].reshape(cap, 3)
    if ring and n_trace > cap:  # oldest entry is at n_trace % cap
        start = n_trace % cap
        e = np.concatenate([e[start:], e[:start]])[-n:]
    else:
        e = e[:n]
    out = []
    for meta, regs, cyc in e:
        meta, regs = int(meta), int(regs)
        out.append(TraceEntry(
            pc=meta & 0xFFFF,
            op_bytes=((meta >> 16) & 0xFF, (meta >> 24) & 0xFF,
                      (meta >> 32) & 0xFF),
            a=regs & 0xFF, x=(regs >> 8) & 0xFF, y=(regs >> 16) & 0xFF,
            p=(regs >> 24) & 0xFF, sp=(regs >> 32) & 0xFF,
            cycles=int(cyc)))
    return out


def run_program(source: str, entry: str = "start", stop: str = "stop",
                max_cycles: int = 10 ** 7, trace=None,
                stream: bytes = b"") -> RunResult:
    """Assemble a standalone 6502 source (asm65 syntax) and execute it.

    Runs on the same Apple IIe machine model as the player (soft switches,
    W5100, speaker) with execution from `entry` label until the `stop`
    label is reached.  The vehicle for testing CPU behaviour directly -
    e.g. that every form asm65 can assemble also executes.
    """
    asm = asm65.Assembler().assemble(source)
    lib = ctypes.CDLL(_build_library())
    lib.a2_run.restype = ctypes.c_int64
    lib.a2_run.argtypes = Apple2Player.ARGTYPES
    main = np.zeros(65536, np.uint8)
    aux = np.zeros(65536, np.uint8)
    main[:] = np.frombuffer(bytes(asm.image), np.uint8)
    ticks = np.zeros(65536, np.int64)
    counts = np.zeros(10, np.int64)
    trace_mode, trace_cap = _parse_trace(trace)
    trace_buf = np.zeros(max(trace_cap, 1) * 3, np.int64)

    def ptr(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    lib.a2_run(
        main.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        aux.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        stream, len(stream), max_cycles,
        ptr(ticks), len(ticks), ptr(counts),
        asm.symbols[entry], asm.symbols[stop],
        0xFFFF, 0xFFFF, 0xFFFF,  # no ROM traps for raw programs
        ptr(trace_buf), trace_cap, trace_mode,
        None, None, 0, 0, None, 1)
    res = RunResult(
        exit_reason=EXIT_NAMES.get(int(counts[2]), str(counts[2])),
        cycles=int(counts[1]),
        tick_cycles=ticks[:min(int(counts[0]), len(ticks))].copy(),
        main=main[0x2000:0x4000].reshape(32, 256).copy(),
        aux=aux[0x2000:0x4000].reshape(32, 256).copy(),
        n_recv=int(counts[4]),
        pc=int(counts[3]),
        regs=(int(counts[6]), int(counts[7]), int(counts[8])),
        trace=_decode_trace(trace_buf, trace_cap, int(counts[9]),
                            trace_mode == 1),
        n_executed=int(counts[9]))
    res.memory = main  # full 64K for assertions
    res.symbols = asm.symbols
    return res


_PLAYER = None


def play_stream(stream: bytes, max_cycles: int = 1 << 40,
                trace=None, key_events=None, connect_fails: int = 0,
                w5100_slot: int = 1) -> RunResult:
    global _PLAYER
    if _PLAYER is None:
        _PLAYER = Apple2Player()
    return _PLAYER.run(stream, max_cycles, trace=trace,
                       key_events=key_events,
                       connect_fails=connect_fails,
                       w5100_slot=w5100_slot)


_MLI_ARGTYPES = Apple2Player.ARGTYPES_BASE + [
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64, ctypes.c_uint16,
] + Apple2Player.KEY_ARGTYPES

MLI_ENTRY = 0xBF00  # the ProDOS MLI vector the loader chain JSRs


def boot_disk(disk_bytes: bytes, stream: bytes,
              max_cycles: int = 1 << 40, trace=None,
              system_file: str = "IIVISION.SYSTEM",
              w5100_slot: int = 1) -> RunResult:
    """Boot a produced ProDOS disk image's loader chain and play `stream`.

    Mirrors what ProDOS does after its own startup (the part the reference
    delegates to Apple's licensed OS binary): loads the volume's .SYSTEM
    file at $2000, puts its pathname at $0280 (the ProDOS startup-path
    convention the cc65 loader reads), and serves the loader's MLI calls
    ($BF00: GET_FILE_INFO/OPEN/READ/CLOSE/QUIT) from the files of the
    ACTUAL disk image.  The REAL reference loader binary then loads the
    REAL on-disk player at its recorded aux_type address and jumps to it;
    the player streams from the W5100 to op_terminate exactly like
    play_stream.  So the produced .po/.dsk is proven bootable end-to-end
    minus only ProDOS itself (reference player/Makefile +
    make/createDiskImage packaging flow).
    """
    from iivision_tpu_torch import prodos

    vol = prodos.ProDOSVolume.from_bytes(disk_bytes)
    files = [(e.name, vol.read_file(e.name), e.file_type, e.aux_type)
             for e in vol.list_files()]
    by_name = {n: (c, t, a) for n, c, t, a in files}
    if system_file not in by_name:
        raise ValueError("no %s on the disk image (files: %s)"
                         % (system_file, sorted(by_name)))

    # serialize the file table for the C MLI service
    blob = bytearray()
    idx = np.zeros(len(files) * 6, np.int64)
    for i, (name, content, ftype, aux) in enumerate(files):
        idx[i * 6 + 0] = len(blob)
        idx[i * 6 + 1] = len(name)
        blob += name.encode("ascii")
        idx[i * 6 + 2] = len(blob)
        idx[i * 6 + 3] = len(content)
        blob += content
        idx[i * 6 + 4] = ftype
        idx[i * 6 + 5] = aux
    blob_np = np.frombuffer(bytes(blob), np.uint8)

    lib = ctypes.CDLL(_build_library())
    lib.a2_run_mli.restype = ctypes.c_int64
    lib.a2_run_mli.argtypes = _MLI_ARGTYPES

    # frozen-ABI symbols (op_terminate etc.) - the player bytes come from
    # the DISK, the addresses from the pinned .dbg
    syms = asm65.assemble_player().symbols
    main = np.zeros(65536, np.uint8)
    aux = np.zeros(65536, np.uint8)
    loader, ltype, _laux = by_name[system_file]
    if ltype != 0xFF:
        raise ValueError("%s is not a SYS file (type %02x)"
                         % (system_file, ltype))
    main[0x2000:0x2000 + len(loader)] = np.frombuffer(loader, np.uint8)
    # ProDOS startup pathname at $0280 (length-prefixed)
    path = "/IIVISION/" + system_file
    main[0x0280] = len(path)
    main[0x0281:0x0281 + len(path)] = np.frombuffer(
        path.encode("ascii"), np.uint8)

    tick_cap = (len(stream) // 7 * 2 + len(stream) // 2048 * 4 + 4096)
    ticks = np.zeros(tick_cap, np.int64)
    counts = np.zeros(10, np.int64)
    trace_mode, trace_cap = _parse_trace(trace)
    trace_buf = np.zeros(max(trace_cap, 1) * 3, np.int64)

    def ptr(arr, ty):
        return arr.ctypes.data_as(ctypes.POINTER(ty))

    lib.a2_run_mli(
        ptr(main, ctypes.c_uint8), ptr(aux, ctypes.c_uint8),
        stream, len(stream), max_cycles,
        ptr(ticks, ctypes.c_int64), tick_cap,
        ptr(counts, ctypes.c_int64),
        0x2000, syms["op_terminate"],
        syms["HGR0"], syms["COUT"], syms["PRODOS"],
        ptr(trace_buf, ctypes.c_int64), trace_cap, trace_mode,
        ptr(blob_np, ctypes.c_uint8), ptr(idx, ctypes.c_int64),
        len(files), MLI_ENTRY,
        None, None, 0, 0, None, w5100_slot)
    if int(counts[0]) > tick_cap:
        raise RuntimeError("speaker tick log overflow: %d > %d"
                           % (int(counts[0]), tick_cap))
    n_ticks = min(int(counts[0]), tick_cap)
    return RunResult(
        exit_reason=EXIT_NAMES.get(int(counts[2]), str(counts[2])),
        cycles=int(counts[1]),
        tick_cycles=ticks[:n_ticks].copy(),
        main=main[0x2000:0x4000].reshape(32, 256).copy(),
        aux=aux[0x2000:0x4000].reshape(32, 256).copy(),
        n_recv=int(counts[4]),
        pc=int(counts[3]),
        regs=(int(counts[6]), int(counts[7]), int(counts[8])),
        trace=_decode_trace(trace_buf, trace_cap, int(counts[9]),
                            trace_mode == 1),
        n_executed=int(counts[9]))
