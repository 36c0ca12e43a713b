"""Frozen `.a2m` stream ABI: opcode ISA, symbol table, 2KB framing (the
port's copy of iivision_tpu/stream)."""

from iivision_tpu_torch.stream.symbols import SymbolTable  # noqa: F401
from iivision_tpu_torch.stream.opcodes import (  # noqa: F401
    OpcodeAddresses, Header, Ack, Terminate, Nop, Tick, emit_opcode,
)
