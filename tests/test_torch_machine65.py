"""The port's 6502 assembler and Apple IIe machine against the JAX
package's: the assembled player, raw programs, player runs on seeded
streams (keys, connect failures, the real ProDOS QUIT ending, traces) and
the disk boot, each through both packages on the same inputs.  Every
comparison is exact: images, symbols, cycles and screen bytes."""

import dataclasses
import os

import numpy as np
import pytest

from iivision_tpu import make_disk as jmake_disk
from iivision_tpu.sim import asm65 as jasm65
from iivision_tpu.sim import machine65 as jmachine65
from iivision_tpu_torch import DATA_DIR
from iivision_tpu_torch import make_disk as tmake_disk
from iivision_tpu_torch.sim import PlayerVM
from iivision_tpu_torch.sim import asm65 as tasm65
from iivision_tpu_torch.sim import machine65 as tmachine65
from iivision_tpu_torch.stream import opcodes as tops
from iivision_tpu_torch.stream import retarget as trt

from tests.test_torch_delivery import (MODES, assert_results_equal,
                                       seeded_ticks, synth_stream)

RELOCATED = {"LOWCODE": 0x0800, "HGR": 0x2000, "CODE": 0x4100}


def player_source():
    with open(tasm65.PLAYER_SOURCE) as f:
        return f.read()


def assert_assemblies_equal(got, want):
    """Two `Assembly` objects by image, entry and symbols."""
    assert bytes(got.image) == bytes(want.image)
    assert got.entry == want.entry
    assert dict(got.symbols) == dict(want.symbols)


# --- the assembler ------------------------------------------------------------

def test_assemble_player_equal_and_validated():
    got, want = tasm65.assemble_player(), jasm65.assemble_player()
    assert_assemblies_equal(got, want)
    compared = tasm65.validate_against_dbg(got)
    assert compared == jasm65.validate_against_dbg(want)
    assert len(compared) > 1900
    dbg = os.path.join(DATA_DIR, "iivision.dbg")
    assert tasm65.dbg_labels(dbg) == jasm65.dbg_labels(dbg)
    # the port finds the source and the symbol file through DATA_DIR
    assert tasm65.PLAYER_SOURCE == os.path.join(DATA_DIR, "player", "main.s")
    assert_assemblies_equal(tasm65.assemble_player(tasm65.PLAYER_SOURCE), got)
    assert tasm65.validate_against_dbg(got, dbg) == compared


def test_tables_equal():
    assert tasm65.OPCODES == jasm65.OPCODES
    assert tasm65.MODE_SIZE == jasm65.MODE_SIZE


def test_relocated_player_equal_and_refused_by_validation():
    src = player_source()
    got = tasm65.Assembler(segments=RELOCATED).assemble(src)
    want = jasm65.Assembler(segments=RELOCATED).assemble(src)
    assert_assemblies_equal(got, want)
    new = tops.OpcodeAddresses.from_symbols(got.symbols)
    assert new.tick[(34, 40)] == tops.default_addresses().tick[(34, 40)] + 0x100
    for pkg, asm in ((tasm65, got), (jasm65, want)):
        with pytest.raises(pkg.AsmError, match="label mismatches"):
            pkg.validate_against_dbg(asm)


SNIPPETS = {
    "modes": ({"CODE": 0x4000}, """
base = $1234
zp = $08
    .segment "CODE"
start:
    LDA #<base
    LDX #>base
    STA zp
    STA base
    STA base,X
    STA $2000,Y
loop:
    BNE loop
    JMP (base)
    .byte 1, 2, $FF
    .word base
"""),
    "macro": ({"CODE": 0x5000}, """
    .macro mk name, val
.ident(.concat("lab_", .string(val))):
    LDA #val
.endmacro
    .segment "CODE"
mk foo, 7
mk foo, 9
"""),
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_assembler_snippets_equal(name):
    segments, src = SNIPPETS[name]
    assert_assemblies_equal(tasm65.Assembler(segments).assemble(src),
                            jasm65.Assembler(segments).assemble(src))


@pytest.mark.parametrize("src,match", [
    ('    .segment "CODE"\na = 1\na = 2\n', "redefinition"),
    ('    .segment "CODE"\n    FOO #1\n', "unknown instruction"),
    ('    .segment "CODE"\nfar = $8000\n    BNE far\n',
     "branch out of range"),
])
def test_assembler_errors_equal(src, match):
    msgs = []
    for pkg in (tasm65, jasm65):
        with pytest.raises(pkg.AsmError, match=match) as e:
            pkg.Assembler({"CODE": 0x4000}).assemble(src)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --- raw programs on the machine ----------------------------------------------

PROGRAMS = {
    "65c02": """
    .segment "CODE"
start:
    LDX #$21
    LDY #$42
    PHX
    PHY
    LDX #0
    LDY #0
    PLY
    PLX
    LDA #$FF
    STA $40
    STA $44
    STA $2100
    STA $2104
    STZ $40
    STZ $2100
    LDX #4
    STZ $40,X
    STZ $2100,X
    LDX #$21
    BRA over
    BRK
over:
    LDA #$A5
stop:
    NOP
""",
    "nmos": """
ptr = $60
    .segment "CODE"
start:
    LDA #$81
    STA $50
    ASL $50
    ROL $50
    LDA #$41
    STA $5000
    ROR $5000
    LSR $5000
    LDX #3
    INC $5100,X
    INC $5100,X
    DEC $5104,X
    LDA #$00
    STA ptr
    LDA #$52
    STA ptr+1
    LDY #7
    LDA #$0F
    STA $5207
    LDA #$F0
    ORA (ptr),Y
    STA $51
    LDA #>ret
    PHA
    LDA #<ret
    PHA
    PHP
    RTI
    BRK
ret:
    LDA $50
stop:
    NOP
""",
    "brk": """
    .segment "CODE"
start:
    NOP
    BRK
stop:
    NOP
""",
    "undocumented": """
    .segment "CODE"
start:
    NOP
    .byte $02
stop:
    NOP
""",
    "speaker": """
    .segment "CODE"
start:
    STA $C030
    NOP
    NOP
    STA $C030
    LDX #5
spin:
    DEX
    BNE spin
    STA $C030
stop:
    NOP
""",
}
EXITS = {"65c02": "TERMINATED", "nmos": "TERMINATED", "brk": "BRK",
         "undocumented": "UNDOCUMENTED", "speaker": "TERMINATED"}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("trace", [None, ("first", 5), ("ring", 4)])
def test_run_program_equal(name, trace):
    got = tmachine65.run_program(PROGRAMS[name], trace=trace)
    want = jmachine65.run_program(PROGRAMS[name], trace=trace)
    assert got.exit_reason == EXITS[name]
    assert_results_equal(got, want)
    assert np.array_equal(got.memory, want.memory)
    assert got.symbols == want.symbols
    if trace is not None:
        assert formats(got.trace, got.symbols) == \
            formats(want.trace, want.symbols)
        assert len(got.trace) == min(trace[1], got.n_executed)
    if name == "65c02":
        assert got.regs == (0xA5, 0x21, 0x42)
    if name == "speaker":
        assert len(got.tick_cycles) == 3


def is_branch(op_byte: int) -> bool:
    return any(modes.get("rel") == op_byte
               for modes in tasm65.OPCODES.values())


def formats(trace, symbols):
    """The entries' printed lines, relative branches left out: under
    numpy 2 the JAX package's disassembler cannot add a branch offset to
    an address (`pc + 2 + np.int8(...)` overflows), which the port's copy
    does in Python integers."""
    return [t.format(symbols) for t in trace if not is_branch(t.op_bytes[0])]


def test_run_program_refuses_a_bad_trace_request():
    for pkg in (tmachine65, jmachine65):
        with pytest.raises(ValueError):
            pkg.run_program(PROGRAMS["brk"], trace=("last", 3))
        with pytest.raises(ValueError):
            pkg.run_program(PROGRAMS["brk"], trace=("ring", 0))


def test_disassembly_equal():
    """Every opcode byte but the relative branches disassembles to the
    same text in both packages, with and without symbols; the branches
    (see `formats`) are held to their targets directly."""
    syms = {"target": 0x1234, "near": 0x4012}
    for b0 in range(256):
        if is_branch(b0):
            continue
        for s in (None, syms):
            for operand in ((0x10, 0x12), (0x34, 0x12)):
                args = (0x4000, (b0,) + operand, s)
                assert tmachine65.disassemble_bytes(*args) == \
                    jmachine65.disassemble_bytes(*args)
    bne = tasm65.OPCODES["BNE"]["rel"]
    assert tmachine65.disassemble_bytes(0x4000, (bne, 0x10, 0)) == "BNE $4012"
    assert tmachine65.disassemble_bytes(0x4000, (bne, 0x10, 0), syms) == \
        "BNE near"
    assert tmachine65.disassemble_bytes(0x4000, (bne, 0xFE, 0)) == "BNE $4000"
    assert tmachine65.disassemble_bytes(0x0001, (bne, 0x80, 0)) == "BNE $FF83"
    assert tmachine65.EXIT_NAMES == jmachine65.EXIT_NAMES
    assert tmachine65.MLI_ENTRY == jmachine65.MLI_ENTRY


# --- the player on seeded streams ---------------------------------------------

@pytest.mark.parametrize("mode_name", MODES)
def test_play_stream_equal(mode_name):
    """The unmodified player plays a stream the JAX package emitted:
    every field of RunResult equal, screens equal to the VM's."""
    data = synth_stream(650, mode_name, 0)
    got, want = tmachine65.play_stream(data), jmachine65.play_stream(data)
    assert got.exit_reason == "TERMINATED"
    assert_results_equal(got, want)
    vm = PlayerVM().decode(data)
    assert np.array_equal(got.main, vm.main)
    assert np.array_equal(got.aux, vm.aux)
    assert got.n_recv == vm.n_acks and got.regs[1] == 0
    assert np.array_equal(got.duty_cycles, want.duty_cycles)


def test_duty_cycles_recover_the_stream_duties():
    """The port's copy of the audio check: the machine's tick pairs, split
    by the framing schedule, are the stream's duties (two of the 32
    variants tick one cycle short in hardware)."""
    n_ops = 650
    ticks = seeded_ticks(n_ops, "DHGR", 0)
    res = tmachine65.play_stream(synth_stream(n_ops, "DHGR", 0))
    pairs = res.duty_cycles
    data, i, per_frame, remaining = [], 1, tops.OPS_FIRST_FRAME, n_ops
    while remaining > 0:
        take = min(per_frame, remaining)
        data.extend(pairs[i:i + take])
        i += take + 2
        remaining -= take
        per_frame = tops.OPS_PER_FRAME
    want = np.asarray([t[0] for t in ticks])
    want[want == 22] = 21
    want[want == 40] = 39
    assert np.array_equal(np.asarray(data), want)


@pytest.mark.parametrize("case", ["pause", "connect_2", "connect_99",
                                  "slot_2", "short_budget", "ring", "first"])
def test_play_stream_options_equal(case):
    data = synth_stream(650, "DHGR", 0)
    base = jmachine65.play_stream(data)
    kw = {
        "pause": dict(key_events=[(base.cycles // 2, ord(" ")),
                                  (base.cycles // 2 + 250_000, ord(" "))]),
        "connect_2": dict(connect_fails=2),
        "connect_99": dict(connect_fails=99),
        "slot_2": dict(w5100_slot=2),  # no card in slot 1: the BRK path
        "short_budget": dict(max_cycles=30000),
        "ring": dict(trace=("ring", 8)),
        "first": dict(trace=("first", 50)),
    }[case]
    got = tmachine65.play_stream(data, **kw)
    want = jmachine65.play_stream(data, **kw)
    assert_results_equal(got, want)
    exits = {"connect_99": "BRK", "slot_2": "BRK",
             "short_budget": "MAX_CYCLES"}
    assert got.exit_reason == exits.get(case, "TERMINATED")
    if case == "pause":
        assert got.cycles >= base.cycles + 250_000 - 75_000
        assert np.array_equal(got.main, base.main)
    if case == "connect_2":
        assert got.cout.count(b"\xae") == 2
    if case == "connect_99":
        text = bytes(b & 0x7F for b in got.cout).decode("ascii")
        assert "SOCKET COULD NOT CONNECT" in text
    if case == "ring":
        syms = tmachine65._PLAYER.assembly.symbols
        assert got.trace[-1].disassemble(syms).startswith("JMP")
        assert formats(got.trace, syms) == formats(
            want.trace, jmachine65._PLAYER.assembly.symbols)


def test_real_prodos_quit_ending_equal():
    """With the op_terminate trap removed the player's own ending runs:
    wait for a key, then QUIT through the MLI vector."""
    data = synth_stream(650, "DHGR", 0)
    base = tmachine65.play_stream(data)
    kw = dict(key_events=[(base.cycles + 80_000, 0x1B)],
              terminate_trap=False)
    got = tmachine65.Apple2Player().run(data, **kw)
    want = jmachine65.Apple2Player().run(data, **kw)
    assert got.exit_reason == "PRODOS_QUIT"
    assert got.cycles >= base.cycles + 80_000
    assert_results_equal(got, want)


def test_relocated_player_plays_a_retargeted_stream_equal():
    """A stream retargeted by the port onto a relocated build plays on
    that build, in both machines, to the screens, duties and cycles of the
    vendored build playing the original."""
    src = player_source()
    data = synth_stream(650, "DHGR", 7)
    tasm = tasm65.Assembler(segments=RELOCATED).assemble(src)
    jasm = jasm65.Assembler(segments=RELOCATED).assemble(src)
    moved = trt.retarget(data, tops.default_addresses(),
                         tops.OpcodeAddresses.from_symbols(tasm.symbols))
    base = tmachine65.play_stream(data)
    got = tmachine65.Apple2Player(assembly=tasm).run(moved)
    want = jmachine65.Apple2Player(assembly=jasm).run(moved)
    assert_results_equal(got, want)
    assert got.exit_reason == "TERMINATED"
    assert np.array_equal(got.main, base.main)
    assert np.array_equal(got.aux, base.aux)
    assert np.array_equal(got.duty_cycles, base.duty_cycles)
    assert got.cycles == base.cycles


# --- the disk boot ------------------------------------------------------------

@pytest.fixture(scope="module")
def template():
    with open(tmake_disk.TEMPLATE_DISK, "rb") as f:
        return f.read()


@pytest.mark.parametrize("order", ["po", "dsk"])
def test_boot_disk_equal(template, order):
    """The disk the port builds boots on the port's machine as the JAX
    package's disk does on its machine, and to the directly loaded
    player's screens and duties."""
    stream = synth_stream(600, "DHGR", 13)
    tdisk = getattr(tmake_disk.build_disk(template=template), "to_" + order)()
    jdisk = getattr(jmake_disk.build_disk(template=template), "to_" + order)()
    assert tdisk == jdisk
    got = tmachine65.boot_disk(tdisk, stream, max_cycles=10 ** 8)
    want = jmachine65.boot_disk(jdisk, stream, max_cycles=10 ** 8)
    assert got.exit_reason == "TERMINATED", (got.exit_reason, hex(got.pc))
    assert_results_equal(got, want)
    direct = tmachine65.play_stream(stream)
    assert np.array_equal(got.main, direct.main)
    assert np.array_equal(got.aux, direct.aux)
    assert np.array_equal(got.duty_cycles, direct.duty_cycles)


@pytest.mark.parametrize("slot,machine_slot,exit_reason", [
    (2, 2, "TERMINATED"), (2, 1, "BRK"), (None, 1, "TERMINATED")])
def test_boot_config_patched_disk_equal(template, slot, machine_slot,
                                        exit_reason):
    stream = synth_stream(320, "DHGR", 14)
    config = dict(server_ip="192.168.7.1", port=8080)
    if slot is not None:
        config["slot"] = slot
    binary = tmake_disk.patch_player_config(**config)
    disk = tmake_disk.build_disk(template=template, binary=binary).to_po()
    kw = dict(max_cycles=10 ** 8, w5100_slot=machine_slot,
              trace=("ring", 4))
    got = tmachine65.boot_disk(disk, stream, **kw)
    want = jmachine65.boot_disk(disk, stream, **kw)
    assert got.exit_reason == exit_reason
    assert_results_equal(got, want)


def test_boot_disk_refusals_equal(template):
    from iivision_tpu import prodos as jprodos
    from iivision_tpu_torch import prodos as tprodos

    stream = synth_stream(64, "DHGR", 1)
    for machine, prodos in ((tmachine65, tprodos), (jmachine65, jprodos)):
        with pytest.raises(ValueError, match="IIVISION.SYSTEM"):
            machine.boot_disk(prodos.ProDOSVolume.create("EMPTY").to_po(),
                              stream)
        vol = prodos.ProDOSVolume.create("WRONG")
        vol.add_file("IIVISION.SYSTEM", b"\x60", file_type=0x06)
        with pytest.raises(ValueError, match="not a SYS file"):
            machine.boot_disk(vol.to_po(), stream)


def test_trace_entries_are_plain_dataclasses():
    """What the tests compare as tuples: a TraceEntry carries pc, bytes,
    registers and cycles, nothing of its package."""
    res = tmachine65.run_program(PROGRAMS["brk"], trace=("first", 1))
    assert dataclasses.astuple(res.trace[0]) == \
        (res.symbols["start"], (0xEA, 0x00, 0xEA), 0, 0, 0,
         res.trace[0].p, res.trace[0].sp, 0)
