"""Stream server: serves an `.a2m` file over TCP to the Apple II player (the
port's copy of iivision_tpu/server.py).

Parity: reference server/server.py (TCPServer on :1977, whole-file sendall;
flow control is TCP backpressure against the player's 2KB ACK pacing).

Beyond parity: on-the-fly player-version translation (the reference's
"Looser coupling" future improvement, reference README.md:227-233) - with
--player-dbg / --known-dbg the server identifies which known player build a
stream was compiled against and retargets its opcode addresses to the
serving player before sending (stream/retarget.py).
"""

import argparse
import socketserver


def build_handler(filename: str, chunk: int = 64 * 1024, transform=None):
    class ChunkHandler(socketserver.BaseRequestHandler):
        def handle(self):
            print("Connection from %s" % (self.client_address,))
            if transform is not None:
                self.request.sendall(
                    transform(open(filename, "rb").read()))
            else:
                with open(filename, "rb") as f:
                    while True:
                        data = f.read(chunk)
                        if not data:
                            break
                        self.request.sendall(data)
            print("Stream complete")
    return ChunkHandler


def build_retargeter(player_dbg, known_dbgs):
    """A bytes->bytes translator onto the `player_dbg` build's addresses.

    Streams already valid for the serving player pass through unmodified;
    others are identified among `known_dbgs` and retargeted.  Raising on an
    unidentifiable stream (rather than sending it) keeps a garbage stream
    from vectoring the 6502 into the weeds.
    """
    from iivision_tpu_torch.stream.opcodes import OpcodeAddresses, \
        default_addresses
    from iivision_tpu_torch.stream import retarget as rt

    target = (OpcodeAddresses(player_dbg) if player_dbg
              else default_addresses())
    cands = [("<player>", target)]
    cands += [(p, OpcodeAddresses(p)) for p in known_dbgs]

    def translate(data: bytes) -> bytes:
        src = rt.identify(data, cands)
        if src == "<player>":
            return data
        old = dict(cands)[src]
        print("retargeting stream: %s (%s) -> player (%s)"
              % (src, rt.fingerprint(old)[:12],
                 rt.fingerprint(target)[:12]))
        return rt.retarget(data, old, target)

    return translate


def build_seeker(seconds: float, player_dbg=None):
    """A bytes->bytes transform starting playback at a timestamp (the
    reference's "Playback controls" future improvement, README.md:240-242;
    stream/seek.py synthesizes the preamble frame)."""
    from iivision_tpu_torch.stream import seek as sk
    from iivision_tpu_torch.stream.opcodes import OpcodeAddresses, \
        default_addresses

    addrs = (OpcodeAddresses(player_dbg) if player_dbg
             else default_addresses())

    def do_seek(data: bytes) -> bytes:
        point = sk.frame_at(sk.seek_index(data, addrs), seconds)
        print("seeking to frame %d (t=%.3fs, bank=%s)"
              % (point.frame, point.seconds,
                 "AUX" if point.aux_bank else "MAIN"))
        return sk.seek(data, point.frame, addrs)

    return do_seek


def serve(filename: str, host: str = "0.0.0.0", port: int = 1977,
          transform=None):
    with socketserver.TCPServer(
            (host, port),
            build_handler(filename, transform=transform)) as server:
        server.allow_reuse_address = True
        print("Serving %s on %s:%d" % (filename, host, port))
        server.serve_forever()


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Serve a ][-Vision .a2m stream over TCP.")
    parser.add_argument("input", help="Path to .a2m file.")
    parser.add_argument("--port", type=int, default=1977)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--player-dbg", default=None, metavar="DBG",
                        help="Serving player build's .dbg; streams are "
                        "retargeted onto its opcode addresses (default: "
                        "the vendored player).")
    parser.add_argument("--known-dbg", action="append", default=[],
                        metavar="DBG",
                        help="Candidate source player .dbg a stream may "
                        "have been compiled against (repeatable). Enables "
                        "on-the-fly retargeting.")
    parser.add_argument("--seek", type=float, default=None,
                        metavar="SECONDS",
                        help="Start every connection's playback at this "
                        "timestamp (expect transient tearing until the "
                        "picture is fully repainted).")
    a = parser.parse_args(args)
    stages = []
    if a.player_dbg or a.known_dbg:
        stages.append(build_retargeter(a.player_dbg, a.known_dbg))
    if a.seek is not None:
        # after retargeting, so the seek walks the serving player's map
        stages.append(build_seeker(a.seek, a.player_dbg))
    transform = None
    if stages:
        def transform(data):
            for stage in stages:
                data = stage(data)
            return data
    serve(a.input, a.host, a.port, transform=transform)


if __name__ == "__main__":
    main()
