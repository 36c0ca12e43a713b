"""Host-side native helpers and playback verification.

- player_vm: the native `.a2m` decoder that enforces the stream contract;
- native: the C++ resize, quantize, dither and emit passes;
- asm65: cc65-subset assembler for the vendored player source, validated
  label for label against the frozen iivision.dbg;
- machine65: cycle-accurate 6502 Apple IIe + W5100 executing the assembled
  player against real streams.

`asm65` and `machine65` are submodules, imported where they are used:
importing this package assembles and builds nothing.
"""

from iivision_tpu_torch.sim.player_vm import PlayerVM, DecodeResult  # noqa: F401
