"""Package the player onto a ProDOS disk image (no Java, no cc65; the port's
copy of iivision_tpu/make_disk.py).

Reproduces the reference's apple2-loader packaging step (reference
player/make/createDiskImage:137-147, 262-273: delete BASIC.SYSTEM, rename
LOADER.SYSTEM to IIVISION.SYSTEM, add the player binary as type BIN at its
start address) using the native ProDOS filesystem in `prodos.py` and the
player binary assembled by `sim/asm65.py` from the vendored source.

Usage:
    python -m iivision_tpu_torch.make_disk out.po            # fresh volume
    python -m iivision_tpu_torch.make_disk out.dsk --template prodos_template.dsk

With --template (e.g. the upstream build pipeline's prodos_template.dsk,
which carries ProDOS plus the cc65 loader) the result is bootable exactly
like the reference's iivision.dsk.  Without it, the image is a valid
ProDOS volume holding the player binary; copy ProDOS + a loader onto it
(or pass a template) to boot - the same external requirement the
reference's Makefile has.
"""

import argparse
import os
import sys

import numpy as np

from iivision_tpu_torch import DATA_DIR, prodos

# the upstream build pipeline's template disk (ProDOS plus the cc65 loader)
TEMPLATE_DISK = os.path.join(DATA_DIR, "player", "prodos_template.dsk")

PLAYER_START = 0x0800
PLAYER_NAME = "IIVISION"


def player_binary() -> bytes:
    """Assemble the vendored player; bytes loaded at PLAYER_START."""
    from iivision_tpu_torch.sim import asm65
    asm = asm65.assemble_player()
    asm65.validate_against_dbg(asm)
    img = np.frombuffer(bytes(asm.image), np.uint8)
    nz = np.nonzero(img)[0]
    end = int(nz[-1]) + 1
    if asm.entry != PLAYER_START:
        raise RuntimeError("unexpected player entry %04x" % asm.entry)
    return img[PLAYER_START:end].tobytes()


def _parse_ip(s: str):
    parts = [int(p) for p in s.split(".")]
    if len(parts) != 4 or any(not 0 <= p <= 255 for p in parts):
        raise ValueError("bad IPv4 address: %r" % s)
    return parts


def _parse_mac(s: str):
    parts = [int(p, 16) for p in s.replace("-", ":").split(":")]
    if len(parts) != 6 or any(not 0 <= p <= 255 for p in parts):
        raise ValueError("bad MAC address: %r" % s)
    return parts


def patch_player_config(w5100_ip: str = None, server_ip: str = None,
                        port: int = None, mac: str = None,
                        slot: int = None) -> bytes:
    """Assembled player with its hardcoded network config replaced.

    The reference documents changing the player's IPs/MAC/slot by editing
    main.s and rebuilding with cc65 (reference README.md:193-206,
    main.s:34-45 "TODO: make these configurable"); asm65 does it natively.
    IP/port/MAC are data bytes in the self-erasing HGR bootstrap segment,
    patched at their symbol offsets; `slot` moves the four W5100 I/O
    equates to $C080 + slot*$10 + 4 and REASSEMBLES the vendored source
    (absolute operands only - every instruction keeps its size, so all
    1,946 labels still match the frozen .dbg, which stays validated).
    The stream ABI is untouched either way.
    """
    from iivision_tpu_torch.sim import asm65

    with open(asm65.PLAYER_SOURCE) as f:
        text = f.read()
    if slot is not None:
        if not 1 <= slot <= 7:
            raise ValueError("slot must be 1-7")
        base = 0xC080 + 0x10 * slot + 4
        for i, name in enumerate(("WMODE", "WADRH", "WADRL", "WDATA")):
            old = "%s = $C09%d" % (name, 4 + i)
            if old not in text:
                raise RuntimeError("player source changed: %r absent"
                                   % old)
            text = text.replace(old, "%s = $%04X" % (name, base + i))
    asm = asm65.Assembler().assemble(text)
    asm65.validate_against_dbg(asm)  # label addresses must be unchanged

    img = bytearray(asm.image)

    def put(sym, vals):
        a = asm.symbols[sym]
        img[a:a + len(vals)] = bytes(vals)

    if w5100_ip is not None:
        put("SRCADDR", _parse_ip(w5100_ip))
    if server_ip is not None:
        put("FADDR", _parse_ip(server_ip))
    if port is not None:
        if not 0 < port < 65536:
            raise ValueError("bad port %r" % port)
        put("FPORT", [(port >> 8) & 0xFF, port & 0xFF])
    if mac is not None:
        put("MAC", _parse_mac(mac))

    arr = np.frombuffer(bytes(img), np.uint8)
    end = int(np.nonzero(arr)[0][-1]) + 1
    return arr[PLAYER_START:end].tobytes()


def build_disk(template: bytes = None, binary: bytes = None,
               volume_name: str = "IIVISION") -> prodos.ProDOSVolume:
    if binary is None:
        binary = player_binary()
    if template is not None:
        vol = prodos.ProDOSVolume.from_bytes(template)
        names = {e.name for e in vol.list_files()}
        # the reference's apple2-loader flow, file for file
        if "BASIC.SYSTEM" in names:
            vol.delete_file("BASIC.SYSTEM")
        if "LOADER.SYSTEM" in names:
            vol.rename_file("LOADER.SYSTEM", PLAYER_NAME + ".SYSTEM")
        if PLAYER_NAME in {e.name for e in vol.list_files()}:
            vol.delete_file(PLAYER_NAME)
    else:
        vol = prodos.ProDOSVolume.create(volume_name)
    vol.add_file(PLAYER_NAME, binary, file_type=prodos.FILE_TYPES["bin"],
                 aux_type=PLAYER_START)
    return vol


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Package the assembled player onto a ProDOS image")
    ap.add_argument("output", help="output image (.po or .dsk)")
    ap.add_argument("--template", default=None,
                    help="existing ProDOS image to package into "
                         "(reference flow; makes the result bootable)")
    ap.add_argument("--binary", default=None,
                    help="binary to package instead of the assembled "
                         "player")
    ap.add_argument("--volume", default="IIVISION",
                    help="volume name for fresh images")
    ap.add_argument("--w5100-ip", default=None,
                    help="player's own IP (default 10.0.65.2)")
    ap.add_argument("--server-ip", default=None,
                    help="video server IP to connect to (default "
                         "10.0.0.1)")
    ap.add_argument("--port", type=int, default=None,
                    help="video server TCP port (default 1977)")
    ap.add_argument("--mac", default=None,
                    help="W5100 MAC address (aa:bb:cc:dd:ee:ff)")
    ap.add_argument("--slot", type=int, default=None,
                    help="Uthernet II slot 1-7 (reassembles the W5100 "
                         "I/O equates; default slot 1)")
    args = ap.parse_args(argv)

    template = open(args.template, "rb").read() if args.template else None
    binary = open(args.binary, "rb").read() if args.binary else None
    cfg = (args.w5100_ip, args.server_ip, args.port, args.mac, args.slot)
    if any(v is not None for v in cfg):
        if binary is not None:
            ap.error("--binary and network-config flags are exclusive "
                     "(config patching assembles the vendored player)")
        binary = patch_player_config(*cfg)
    vol = build_disk(template, binary, args.volume)
    data = vol.to_dsk() if args.output.lower().endswith(".dsk") \
        else vol.to_po()
    with open(args.output, "wb") as f:
        f.write(data)
    files = ", ".join("%s(%s,$%04X,%dB)" % (
        e.name, prodos.TYPE_NAMES.get(e.file_type, "$%02X" % e.file_type),
        e.aux_type, e.eof) for e in vol.list_files())
    print("wrote %s: volume %s, %d blocks free, files: %s"
          % (args.output, vol.volume_name, vol.free_blocks(), files))
    return 0


if __name__ == "__main__":
    sys.exit(main())
