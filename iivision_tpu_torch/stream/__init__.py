"""The `.a2m` stream ABI: the player's symbol table, opcode addresses and
byte emission (the port's copy of what it uses of iivision_tpu/stream)."""
