"""Stream verification CLI: validate an `.a2m` file end to end (the port's
copy of iivision_tpu/verify_stream.py).

Two independent checkers:
  1. the native opcode-ABI VM (sim/player_vm): framing, opcode validity,
     2KB/ACK contract, screen reconstruction, duty extraction;
  2. (--machine) the cycle-accurate 6502 Apple IIe running the REAL player
     assembled from the vendored source (sim/machine65): screen memory and
     speaker timing produced by actual execution.

Usage: python -m iivision_tpu_torch.verify_stream movie.a2m [--machine]
Exits non-zero if validation fails.
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stream", help="Path to .a2m file")
    ap.add_argument("--machine", action="store_true",
                    help="Also execute on the simulated 6502 Apple IIe "
                         "and cross-check both checkers' screen memory.")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="With --machine: keep the last N executed "
                         "instructions and print them (disassembled, with "
                         "player symbols) when verification fails.")
    args = ap.parse_args(argv)

    from iivision_tpu_torch.sim import PlayerVM

    data = open(args.stream, "rb").read()
    res = PlayerVM().decode(data)
    print("stream: %d bytes (%d 2KB frames)" % (len(data), len(data) // 2048))
    print("VM: %s  ops=%d acks=%d playback=%.2fs video_mode=%s"
          % (res.error, res.n_ops, res.n_acks, res.playback_seconds,
             {0: "HGR", 1: "DHGR"}.get(res.video_mode, res.video_mode)))
    if not res.ok:
        print("FAIL: VM decode error %s at byte %d"
              % (res.error, res.error_pos))
        return 1

    if args.machine:
        from iivision_tpu_torch.sim import machine65

        trace = ("ring", args.trace) if args.trace > 0 else None
        mres = machine65.play_stream(data, trace=trace)
        print("6502: exit=%s cycles=%d (%.2fs at 1.0227MHz) recv=%d"
              % (mres.exit_reason, mres.cycles,
                 mres.cycles / (1024 * 1024), mres.n_recv))

        def dump_trace():
            if not mres.trace:
                return
            syms = machine65._PLAYER.assembly.symbols
            print("last %d executed instructions:" % len(mres.trace))
            for t in mres.trace:
                print("  " + t.format(syms))

        if mres.exit_reason != "TERMINATED":
            print("FAIL: machine did not reach op_terminate "
                  "(exit=%s at pc=$%04X)" % (mres.exit_reason, mres.pc))
            dump_trace()
            return 1
        if not np.array_equal(mres.main, res.main) or \
                not np.array_equal(mres.aux, res.aux):
            print("FAIL: machine screen memory diverges from VM model")
            dump_trace()
            return 1
        print("6502 screen memory matches the VM model (MAIN+AUX)")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
