"""The delivery half of iivision_tpu_torch against the JAX package: the
opcode classes and 2KB framing, retargeting, seeking, the TCP server,
ProDOS volumes and `make_disk`, `verify_stream` and `render_stream`, each
on the same seeded inputs, and the slice as a whole (CLI, server, fetch,
6502 machine) through both packages.  Everything here is bytes and
integers: every comparison demands equality (tolerance 0)."""

import dataclasses
import os
import socket
import socketserver
import threading

import numpy as np
import pytest

from iivision_tpu import cli as jcli
from iivision_tpu import make_disk as jmake_disk
from iivision_tpu import prodos as jprodos
from iivision_tpu import render_stream as jrender_stream
from iivision_tpu import server as jserver
from iivision_tpu import verify_stream as jverify
from iivision_tpu.encoder import plan_movie as jplan_movie
from iivision_tpu.sim import asm65 as jasm65
from iivision_tpu.sim import machine65 as jmachine65
from iivision_tpu.stream import framing as jframing
from iivision_tpu.stream import opcodes as jops
from iivision_tpu.stream import retarget as jrt
from iivision_tpu.stream import seek as jsk
from iivision_tpu.video_mode import VideoMode as JVideoMode
from iivision_tpu_torch import DATA_DIR
from iivision_tpu_torch import cli as tcli
from iivision_tpu_torch import make_disk as tmake_disk
from iivision_tpu_torch import prodos as tprodos
from iivision_tpu_torch import render_stream as trender_stream
from iivision_tpu_torch import server as tserver
from iivision_tpu_torch import verify_stream as tverify
from iivision_tpu_torch.plan import plan_movie as tplan_movie
from iivision_tpu_torch.sim import PlayerVM
from iivision_tpu_torch.sim import machine65 as tmachine65
from iivision_tpu_torch.stream import framing as tframing
from iivision_tpu_torch.stream import opcodes as tops
from iivision_tpu_torch.stream import retarget as trt
from iivision_tpu_torch.stream import seek as tsk
from iivision_tpu_torch.video_mode import VideoMode

from tests.test_pipeline import gradient_movie

MODES = ["DHGR", "HGR"]
DBG = os.path.join(DATA_DIR, "iivision.dbg")


def seeded_ticks(n_ops, mode_name, seed):
    """n_ops rows of (duty, page, content, (o0..o3)) from one numpy seed."""
    rng = np.random.RandomState(seed)
    hi = 128 if mode_name == "DHGR" else 256
    return [(4 + 2 * int(rng.randint(0, 32)), 32 + int(rng.randint(0, 32)),
             int(rng.randint(0, hi)),
             tuple(int(x) for x in rng.randint(0, 256, 4)))
            for _ in range(n_ops)]


def framed(pkg_ops, pkg_framing, mode, ticks, **kw):
    """The rows as one package's Header + Tick opcodes through its
    StreamFramer."""
    ops = [pkg_ops.Header(mode)] + [pkg_ops.Tick(*t) for t in ticks]
    framer = pkg_framing.StreamFramer(mode, **kw)
    return b"".join(framer.emit_stream(iter(ops))), framer


def synth_stream(n_ops=600, mode_name="DHGR", seed=0):
    """A seeded stream, emitted by the JAX package: what crosses into the
    port is its bytes."""
    data, _ = framed(jops, jframing, JVideoMode[mode_name],
                     seeded_ticks(n_ops, mode_name, seed))
    return data


def shifted(pkg_ops, delta=0x10):
    """One package's vendored address map, uniformly shifted: a synthetic
    new player build, from a plain dict of symbols."""
    d = pkg_ops.default_addresses()
    syms = {"op_header": d.header + delta, "op_ack": d.ack + delta,
            "op_terminate": d.terminate + delta, "op_nop": d.nop + delta}
    syms.update({"op_tick_%d_page_%d" % k: v + delta
                 for k, v in d.tick.items()})
    return pkg_ops.OpcodeAddresses.from_symbols(syms)


def write_dbg(addrs, path):
    """A minimal cc65-style .dbg for an address map."""
    names = [("op_header", addrs.header), ("op_ack", addrs.ack),
             ("op_terminate", addrs.terminate), ("op_nop", addrs.nop)]
    names += [("op_tick_%d_page_%d" % k, v)
              for k, v in sorted(addrs.tick.items())]
    with open(path, "w") as f:
        for i, (name, val) in enumerate(names):
            f.write('sym\tid=%d,name="%s",addrsize=absolute,scope=0,'
                    'def=1,val=0x%X,type=lab\n' % (i, name, val))


def address_tables(a):
    return (a.header, a.terminate, a.nop, a.ack, dict(a.tick))


def fetch(handler):
    """Serve one connection on 127.0.0.1, port 0, and return what a real
    socket reads until the server closes it."""
    srv = socketserver.TCPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        chunks = []
        with socket.create_connection(srv.server_address, timeout=10) as s:
            while True:
                buf = s.recv(65536)
                if not buf:
                    break
                chunks.append(buf)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)
    return b"".join(chunks)


def assert_results_equal(got, want):
    """Two RunResults, field by field (the two packages' dataclasses are
    different types, so each field is compared)."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif f.name == "trace":
            assert (a is None) == (b is None), f.name
            if b is not None:
                assert [dataclasses.astuple(t) for t in a] == \
                    [dataclasses.astuple(t) for t in b]
        else:
            assert a == b, f.name


# --- opcodes and framing ------------------------------------------------------

def test_opcode_constants_and_addresses_equal():
    for name in ("TICKS", "PAGES", "FRAME_BYTES", "TICK_BYTES", "HEADER_BYTES",
                 "ACK_BYTES", "OPS_FIRST_FRAME", "OPS_PER_FRAME"):
        assert getattr(tops, name) == getattr(jops, name), name
    assert address_tables(tops.default_addresses()) == \
        address_tables(jops.default_addresses())
    assert address_tables(tops.OpcodeAddresses(DBG)) == \
        address_tables(jops.OpcodeAddresses(DBG))
    assert address_tables(shifted(tops)) == address_tables(shifted(jops))
    assert [tops.audio_level_to_tick(a) for a in range(-15, 17)] == \
        [jops.audio_level_to_tick(a) for a in range(-15, 17)]


def test_from_symbols_takes_an_assembly_dict_and_refuses_gaps():
    """`from_symbols` takes a plain dict on both sides: an assembled
    player's symbols (names with `op_`), or bare names; a missing tick
    raises KeyError in both."""
    syms = dict(jasm65.assemble_player().symbols)
    assert address_tables(tops.OpcodeAddresses.from_symbols(syms)) == \
        address_tables(jops.OpcodeAddresses.from_symbols(syms)) == \
        address_tables(jops.default_addresses())
    bare = {k[3:]: v for k, v in syms.items() if k.startswith("op_")}
    assert address_tables(tops.OpcodeAddresses.from_symbols(bare)) == \
        address_tables(jops.OpcodeAddresses.from_symbols(bare))
    del bare["tick_34_page_40"]
    for pkg in (tops, jops):
        with pytest.raises(KeyError):
            pkg.OpcodeAddresses.from_symbols(bare)


@pytest.mark.parametrize("kind", ["header_hgr", "header_dhgr", "tick",
                                  "ack_main", "ack_aux", "terminate", "nop"])
@pytest.mark.parametrize("addresses", ["vendored", "shifted"])
def test_emit_opcode_equal(kind, addresses):
    """`emit_opcode` of every opcode class, under the vendored map and a
    shifted one."""
    def build(pkg, mode_enum):
        addrs = None if addresses == "vendored" else shifted(pkg)
        ops = {
            "header_hgr": [pkg.Header(mode_enum.HGR)],
            "header_dhgr": [pkg.Header(mode_enum.DHGR)],
            "tick": [pkg.Tick(*t) for t in seeded_ticks(64, "HGR", 1)],
            "ack_main": [pkg.Ack(False)], "ack_aux": [pkg.Ack(True)],
            "terminate": [pkg.Terminate()], "nop": [pkg.Nop()],
        }[kind]
        return [pkg.emit_opcode(op, addrs) for op in ops]

    got, want = build(tops, VideoMode), build(jops, JVideoMode)
    assert got == want and all(isinstance(b, bytes) for b in got)


def test_tick_refuses_wrong_offset_count():
    for pkg in (tops, jops):
        with pytest.raises(ValueError):
            pkg.Tick(34, 32, 0, (1, 2, 3))


def test_foreign_enums_refused():
    """The port's opcode and framing entry points take the port's own
    VideoMode; the JAX package's raises TypeError."""
    with pytest.raises(TypeError):
        tops.Header(JVideoMode.DHGR)
    with pytest.raises(TypeError):
        tframing.StreamFramer(JVideoMode.DHGR)
    assert tops.Header(VideoMode.DHGR).emit(None) == \
        jops.Header(JVideoMode.DHGR).emit(None)


@pytest.mark.parametrize("mode_name", MODES)
@pytest.mark.parametrize("max_bytes_out", [None, 4096, 5000])
@pytest.mark.parametrize("n_ops", [0, 290, 291, 292, 1200])
def test_emit_stream_equal(mode_name, max_bytes_out, n_ops):
    """`StreamFramer.emit_stream` byte-equal, with and without a byte cap,
    around the first frame's 291-op boundary; the framers end in the same
    state."""
    ticks = seeded_ticks(n_ops, mode_name, 3)
    got, tf = framed(tops, tframing, VideoMode[mode_name], ticks,
                     max_bytes_out=max_bytes_out)
    want, jf = framed(jops, jframing, JVideoMode[mode_name], ticks,
                      max_bytes_out=max_bytes_out)
    assert got == want and len(got) % 2048 == 0
    assert (tf.stream_pos, tf.aux_memory_bank) == \
        (jf.stream_pos, jf.aux_memory_bank)
    assert PlayerVM().decode(got).ok


def test_emit_stream_under_a_shifted_map_equal():
    ticks = seeded_ticks(700, "DHGR", 5)
    got, _ = framed(tops, tframing, VideoMode.DHGR, ticks,
                    addrs=shifted(tops))
    want, _ = framed(jops, jframing, JVideoMode.DHGR, ticks,
                     addrs=shifted(jops))
    assert got == want
    assert PlayerVM(shifted(tops)).decode(got).ok


@pytest.mark.parametrize("total", [0, 1, 290, 291, 292, 583, 584, 29399])
def test_segment_schedule_equal(total):
    assert tframing.segment_schedule(total) == \
        jframing.segment_schedule(total)


@pytest.mark.parametrize("mode_name", MODES)
@pytest.mark.parametrize("n_audio_ticks", [300, 2000, 7350])
def test_segment_schedule_agrees_with_plan_movie(mode_name, n_audio_ticks):
    """`plan.plan_movie` recomputes the segment rule inline: each op's
    segment and, for DHGR, its bank are `segment_schedule`'s, in both
    packages."""
    kw = dict(n_frames=15, n_audio_ticks=n_audio_ticks,
              input_frame_rate=30.0, ticks_per_second=14700.0,
              every_n_video_frames=2, k=8)
    plan, _ = tplan_movie(mode=VideoMode[mode_name], **kw)
    jplan, _ = jplan_movie(mode=JVideoMode[mode_name], **kw)
    assert plan.n_ops == jplan.n_ops > 0
    segs = tframing.segment_schedule(plan.n_ops)
    assert sum(n for n, _ in segs) == plan.n_ops
    bank = np.concatenate([np.full(n, aux and mode_name == "DHGR", np.int64)
                           for n, aux in segs])
    for p in (plan, jplan):
        # a step's real ops share its bank; steps are in stream order
        op_bank = np.repeat(np.asarray(p.step_bank).astype(np.int64),
                            np.asarray(p.step_nvalid))
        assert np.array_equal(op_bank, bank)


# --- retarget -----------------------------------------------------------------

def test_fingerprint_equal_and_sensitive():
    assert trt.fingerprint() == jrt.fingerprint()
    assert trt.fingerprint(shifted(tops)) == jrt.fingerprint(shifted(jops))
    assert trt.fingerprint(shifted(tops)) != trt.fingerprint()
    one = shifted(tops, 0)
    one.tick[(34, 40)] += 1
    assert trt.fingerprint(one) != trt.fingerprint()


@pytest.mark.parametrize("mode_name", MODES)
def test_walk_equal(mode_name):
    data = synth_stream(700, mode_name, 3)
    assert list(trt.walk(data)) == list(jrt.walk(data))


@pytest.mark.parametrize("mode_name", MODES)
def test_retarget_equal_and_round_trip(mode_name):
    data = synth_stream(700, mode_name, 3)
    assert trt.retarget(data) == data  # the identity is a byte no-op
    moved = trt.retarget(data, tops.default_addresses(), shifted(tops))
    assert moved == jrt.retarget(data, jops.default_addresses(),
                                 shifted(jops))
    assert len(moved) == len(data) and moved != data
    assert trt.retarget(moved, shifted(tops), tops.default_addresses()) == data
    base, got = PlayerVM().decode(data), PlayerVM(shifted(tops)).decode(moved)
    assert base.ok and got.ok and not PlayerVM().decode(moved).ok
    assert np.array_equal(base.main, got.main)
    assert np.array_equal(base.aux, got.aux)
    assert np.array_equal(base.duty, got.duty)
    cands = [("old", tops.default_addresses()), ("new", shifted(tops))]
    jcands = [("old", jops.default_addresses()), ("new", shifted(jops))]
    for stream in (data, moved):
        assert trt.identify(stream, cands) == jrt.identify(stream, jcands)
    assert trt.identify(moved, cands) == "new"


@pytest.mark.parametrize("corruption", ["short", "address", "ack_byte",
                                        "padding", "header", "mode_byte"])
def test_walk_rejects_corruption_equal(corruption):
    """Both packages raise StreamFormatError at the same byte with the
    same message; `identify` raises it too."""
    data = bytearray(synth_stream(300, "DHGR", 0))
    if corruption == "short":
        data = data[:-1]
    else:
        pos = {"address": 7, "ack_byte": 2046, "padding": len(data) - 1,
               "header": 2, "mode_byte": 6}[corruption]
        data[pos] ^= 0x80
    data = bytes(data)
    with pytest.raises(trt.StreamFormatError) as got:
        list(trt.walk(data))
    with pytest.raises(jrt.StreamFormatError) as want:
        list(jrt.walk(data))
    assert got.value.pos == want.value.pos
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
    with pytest.raises(trt.StreamFormatError):
        trt.identify(data, [("old", tops.default_addresses())])


def test_retarget_cli_equal(tmp_path, capsys):
    assert trt.main(["--fingerprint"]) == 0
    assert capsys.readouterr().out.strip() == jrt.fingerprint()
    data = synth_stream(350, "DHGR", 5)
    src = str(tmp_path / "in.a2m")
    with open(src, "wb") as f:
        f.write(data)
    new_dbg = str(tmp_path / "new.dbg")
    write_dbg(shifted(tops), new_dbg)
    outs = []
    for pkg, tag in ((trt, "t"), (jrt, "j")):
        dst = str(tmp_path / (tag + ".a2m"))
        assert pkg.main([src, "-o", dst, "--to-dbg", new_dbg]) == 0
        back = str(tmp_path / (tag + "_back.a2m"))
        assert pkg.main([dst, "-o", back, "--from-dbg", new_dbg,
                         "--from-dbg", DBG]) == 0
        outs.append((open(dst, "rb").read(), open(back, "rb").read()))
    assert outs[0] == outs[1] and outs[0][1] == data
    # the port's message carries the port's module name nowhere: same text
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:2] == [ln.replace("j.a2m", "t.a2m") for ln in lines[2:]]


# --- seek ---------------------------------------------------------------------

@pytest.mark.parametrize("mode_name", MODES)
def test_seek_index_frame_at_and_seek_equal(mode_name):
    data = synth_stream(1200, mode_name, 4)
    idx, jidx = tsk.seek_index(data), jsk.seek_index(data)
    assert [dataclasses.astuple(p) for p in idx] == \
        [dataclasses.astuple(p) for p in jidx]
    assert len(idx) == len(data) // 2048
    for t in (0.0, idx[1].seconds, idx[2].seconds - 1e-9, 0.1, 1e9):
        assert dataclasses.astuple(tsk.frame_at(idx, t)) == \
            dataclasses.astuple(jsk.frame_at(jidx, t))
    for k in range(len(idx)):
        assert tsk.seek(data, k) == jsk.seek(data, k)
    assert tsk.seek(data, 0) == data
    assert PlayerVM().decode(tsk.seek(data, 2)).ok
    assert tsk.seek(data, 2, shifted(tops, 0)) == jsk.seek(data, 2)


def test_seek_range_errors_equal():
    data = synth_stream(600, "DHGR", 6)
    n = len(data) // 2048
    for frame in (n, n + 5, -1):
        with pytest.raises(ValueError) as got:
            tsk.seek(data, frame)
        with pytest.raises(ValueError) as want:
            jsk.seek(data, frame)
        assert str(got.value) == str(want.value)


def test_seek_cli_equal(tmp_path, capsys):
    data = synth_stream(800, "DHGR", 8)
    src = str(tmp_path / "in.a2m")
    with open(src, "wb") as f:
        f.write(data)
    texts = []
    for pkg, tag in ((tsk, "t"), (jsk, "j")):
        assert pkg.main([src, "--index"]) == 0
        dst = str(tmp_path / (tag + ".a2m"))
        at = str(tsk.seek_index(data)[1].seconds)
        assert pkg.main([src, "-o", dst, "--at", at]) == 0
        assert pkg.main([src, "-o", dst + "2", "--frame", "2"]) == 0
        texts.append(capsys.readouterr().out)
        assert open(dst, "rb").read() == jsk.seek(data, 1)
        assert open(dst + "2", "rb").read() == jsk.seek(data, 2)
    assert texts[0] == texts[1]


# --- server -------------------------------------------------------------------

def served(server_mod, monkeypatch, argv):
    """What a client fetches from `server_mod.main(argv)`: `main` builds
    its transform from the flags and calls `serve`, which is replaced by
    one connection on a loopback port."""
    got = []
    monkeypatch.setattr(
        server_mod, "serve",
        lambda filename, host, port, transform=None: got.append(fetch(
            server_mod.build_handler(filename, transform=transform))))
    server_mod.main(argv)
    return got[0]


def test_server_streams_file_exactly(tmp_path, monkeypatch):
    payload = np.random.RandomState(0).bytes(300 * 1024)  # many chunks
    path = str(tmp_path / "movie.a2m")
    with open(path, "wb") as f:
        f.write(payload)
    assert fetch(tserver.build_handler(path)) == payload
    assert fetch(tserver.build_handler(path, chunk=1000)) == payload
    assert served(tserver, monkeypatch, [path]) == payload
    assert served(jserver, monkeypatch, [path]) == payload


@pytest.mark.parametrize("flags", ["seek", "retarget", "retarget_seek",
                                   "passthrough"])
def test_server_transforms_equal(tmp_path, monkeypatch, flags):
    """`main` with --seek, with --player-dbg/--known-dbg and with both,
    over a real loopback socket: the port serves what the JAX server
    serves, which is the offline transform."""
    data = synth_stream(1000, "DHGR", 9)
    path = str(tmp_path / "movie.a2m")
    with open(path, "wb") as f:
        f.write(data)
    new = shifted(tops)
    new_dbg = str(tmp_path / "new_player.dbg")
    write_dbg(new, new_dbg)
    at = tsk.seek_index(data)[2].seconds
    moved = trt.retarget(data, tops.default_addresses(), new)
    argv, want = {
        "seek": ([path, "--seek", str(at)], tsk.seek(data, 2)),
        "retarget": ([path, "--player-dbg", new_dbg, "--known-dbg", DBG],
                     moved),
        "retarget_seek": ([path, "--player-dbg", new_dbg, "--known-dbg", DBG,
                           "--seek", str(at)], tsk.seek(moved, 2, new)),
        "passthrough": ([path, "--known-dbg", new_dbg], data),
    }[flags]
    got = served(tserver, monkeypatch, argv)
    assert got == want
    assert got == served(jserver, monkeypatch, argv)
    assert PlayerVM(new if "retarget" in flags else None).decode(got).ok


def test_server_retargeter_refuses_an_unknown_stream(tmp_path):
    new_dbg = str(tmp_path / "new_player.dbg")
    write_dbg(shifted(tops), new_dbg)
    data = synth_stream(300, "DHGR", 1)
    for mod, err in ((tserver, trt.StreamFormatError),
                     (jserver, jrt.StreamFormatError)):
        translate = mod.build_retargeter(new_dbg, [])
        with pytest.raises(err):
            translate(data)
        moved = trt.retarget(data, tops.default_addresses(), shifted(tops))
        assert translate(moved) == moved


# --- prodos and make_disk -----------------------------------------------------

def test_prodos_source_is_the_original():
    """`prodos.py` imports nothing of either package: the port's copy is
    the original file."""
    with open(tprodos.__file__, "rb") as f, open(jprodos.__file__, "rb") as g:
        assert f.read() == g.read()


def build_volume(pkg):
    """Seedling, sapling and tree files, a delete and a rename, from one
    seed."""
    rng = np.random.RandomState(12)
    vol = pkg.ProDOSVolume.create("SEEDED")
    vol.add_file("TINY", rng.bytes(100))
    vol.add_file("SAPLING", rng.bytes(20000), file_type=0xFF, aux_type=0x2000)
    vol.add_file("TREE", rng.bytes(70000), file_type=0x04)
    vol.add_file("GONE", rng.bytes(3000))
    vol.delete_file("GONE")
    vol.rename_file("TINY", "SMALL.BIN")
    return vol


def test_prodos_volume_bytes_equal():
    tv, jv = build_volume(tprodos), build_volume(jprodos)
    assert tv.to_po() == jv.to_po() and tv.to_dsk() == jv.to_dsk()
    assert tv.free_blocks() == jv.free_blocks()
    assert tv.volume_name == jv.volume_name == "SEEDED"
    assert [dataclasses.astuple(e) for e in tv.list_files()] == \
        [dataclasses.astuple(e) for e in jv.list_files()]
    # each package reads the other's image, in both sector orders
    for image in (jv.to_po(), jv.to_dsk()):
        back = tprodos.ProDOSVolume.from_bytes(image)
        for e in jv.list_files():
            assert back.read_file(e.name) == jv.read_file(e.name)
    assert tprodos.po_to_dsk(jv.to_po()) == jv.to_dsk()
    assert tprodos.dsk_to_po(jv.to_dsk()) == jv.to_po()
    for pkg in (tprodos, jprodos):
        with pytest.raises(pkg.ProDOSError):
            build_volume(pkg).add_file("bad name!", b"")
        with pytest.raises(pkg.ProDOSError):
            build_volume(pkg).add_file("HUGE", bytes(200000))


def test_player_binary_equal():
    assert tmake_disk.player_binary() == jmake_disk.player_binary()
    assert tmake_disk.PLAYER_START == jmake_disk.PLAYER_START
    assert tmake_disk.PLAYER_NAME == jmake_disk.PLAYER_NAME


@pytest.mark.parametrize("template", ["none", "vendored"])
def test_build_disk_bytes_equal(template):
    tmpl = None
    if template == "vendored":
        with open(tmake_disk.TEMPLATE_DISK, "rb") as f:
            tmpl = f.read()
    tv = tmake_disk.build_disk(template=tmpl)
    jv = jmake_disk.build_disk(template=tmpl)
    assert tv.to_po() == jv.to_po() and tv.to_dsk() == jv.to_dsk()
    names = {e.name for e in tv.list_files()}
    assert "IIVISION" in names and "BASIC.SYSTEM" not in names
    assert ("IIVISION.SYSTEM" in names) == (template == "vendored")


@pytest.mark.parametrize("config", [
    dict(w5100_ip="192.168.7.2", server_ip="192.168.7.1", port=8080,
         mac="02:11:22:33:44:55"),
    dict(slot=2),
    dict(slot=7, port=1977),
    dict(),
])
def test_patch_player_config_equal(config):
    got = tmake_disk.patch_player_config(**config)
    assert got == jmake_disk.patch_player_config(**config)
    if not config:
        assert got == jmake_disk.player_binary()


@pytest.mark.parametrize("bad", [dict(slot=0), dict(port=70000),
                                 dict(server_ip="1.2.3"),
                                 dict(mac="02:11:22")])
def test_patch_player_config_errors_equal(bad):
    for pkg in (tmake_disk, jmake_disk):
        with pytest.raises(ValueError):
            pkg.patch_player_config(**bad)


def test_make_disk_cli_equal(tmp_path, capsys):
    images = []
    for pkg, tag in ((tmake_disk, "t"), (jmake_disk, "j")):
        po = tmp_path / (tag + ".po")
        dsk = tmp_path / (tag + ".dsk")
        assert pkg.main([str(po)]) == 0
        assert pkg.main([str(dsk), "--template", tmake_disk.TEMPLATE_DISK,
                         "--server-ip", "10.1.2.3", "--slot", "3"]) == 0
        images.append((po.read_bytes(), dsk.read_bytes()))
        with pytest.raises(SystemExit):
            pkg.main([str(po), "--binary", str(po), "--port", "80"])
    assert images[0] == images[1]
    out = capsys.readouterr().out.replace("j.po", "t.po").replace(
        "j.dsk", "t.dsk").splitlines()
    assert out[:2] == out[2:]


# --- verify_stream and render_stream ------------------------------------------

@pytest.mark.parametrize("mode_name", MODES)
def test_verify_stream_cli_equal(tmp_path, capsys, mode_name):
    """The verification CLI prints and returns the same in both packages:
    a valid stream with --machine, a corrupt ACK without, and a stream
    that sends the 6502 into data, with --trace."""
    data = synth_stream(650, mode_name, 0)
    path = str(tmp_path / "ok.a2m")
    with open(path, "wb") as f:
        f.write(data)
    bad = bytearray(data)
    bad[2044] ^= 0xFF  # the first ACK's opcode address
    badp = str(tmp_path / "bad.a2m")
    with open(badp, "wb") as f:
        f.write(bytes(bad))
    outs = []
    for pkg in (tverify, jverify):
        assert pkg.main([path, "--machine"]) == 0
        assert pkg.main([path, "--machine", "--trace", "4"]) == 0
        assert pkg.main([badp]) == 1
        assert pkg.main([badp, "--machine"]) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "6502 screen memory matches" in outs[0]
    assert "FAIL: VM decode error" in outs[0]


def test_verify_stream_machine_failure_prints_the_trace(tmp_path, capsys,
                                                        monkeypatch):
    """A stream the VM accepts but the machine does not finish (the cycle
    budget cut short) fails with the disassembled ring trace, the same
    text in both packages."""
    data = synth_stream(650, "DHGR", 0)
    path = str(tmp_path / "ok.a2m")
    with open(path, "wb") as f:
        f.write(data)
    outs = []
    for pkg, machine in ((tverify, tmachine65), (jverify, jmachine65)):
        play = machine.play_stream
        monkeypatch.setattr(
            machine, "play_stream",
            lambda d, trace=None, play=play: play(d, max_cycles=20000,
                                                  trace=trace))
        assert pkg.main([path, "--machine", "--trace", "6"]) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "last 6 executed instructions" in outs[0]
    assert "exit=MAX_CYCLES" in outs[0]


@pytest.mark.parametrize("mode_name", MODES)
@pytest.mark.parametrize("fps", [10.0, 30.0, 1.0])
def test_stream_screens_equal(mode_name, fps):
    # 14,700 ops a second: 3000 ops span several snapshots at 30 and 10 fps
    data = synth_stream(3000, mode_name, 2)
    got, gmode = trender_stream.stream_screens(data, fps)
    want, wmode = jrender_stream.stream_screens(data, fps)
    assert gmode == wmode == VideoMode[mode_name].value
    assert got.dtype == want.dtype and np.array_equal(got, want)
    vm = PlayerVM().decode(data)
    assert np.array_equal(got[-1, 0], vm.main)
    assert np.array_equal(got[-1, 1], vm.aux)


def test_stream_screens_refuses_a_corrupt_stream():
    bad = bytearray(synth_stream(300, "DHGR", 2))
    bad[7] ^= 0x80
    for pkg in (trender_stream, jrender_stream):
        with pytest.raises(ValueError, match="does not decode"):
            pkg.stream_screens(bytes(bad), 10.0)


@pytest.mark.parametrize("renderer", ["nominal", "yiq"])
def test_render_stream_cli_equal(tmp_path, renderer):
    """`render_stream.main` writes the same PNG frames and GIF through
    both packages (Pillow, imported inside `main` only)."""
    Image = pytest.importorskip("PIL.Image")
    data = synth_stream(2000, "DHGR", 2)
    path = str(tmp_path / "m.a2m")
    with open(path, "wb") as f:
        f.write(data)
    frames = []
    for pkg, tag in ((trender_stream, "t"), (jrender_stream, "j")):
        out = str(tmp_path / tag)
        assert pkg.main([path, out, "--png", "--renderer", renderer,
                         "--scale", "1"]) == 0
        assert pkg.main([path, out + ".gif", "--fps", "15"]) == 0
        names = sorted(os.listdir(out))
        frames.append([np.asarray(Image.open(os.path.join(out, n)))
                       for n in names])
        assert Image.open(out + ".gif").n_frames == 3
    assert len(frames[0]) == len(frames[1]) == 2
    for a, b in zip(*frames):
        assert a.shape == (192, 140, 3) and np.array_equal(a, b)


# --- the slice as a whole -----------------------------------------------------

@pytest.mark.parametrize("mode_name", MODES)
def test_cli_server_machine_equal(tmp_path, mode_name):
    """A 2 s clip through the port's CLI on the CPU, the port's server and
    the port's 6502 machine, against the same clip through the JAX CLI,
    server and machine: the streams are byte-equal at every stage and the
    RunResults equal field by field; the port's `verify_stream --machine`
    passes the fetched file."""
    results = []
    for tag, cli, server_mod, machine, extra in (
            ("t", tcli, tserver, tmachine65, ["--device", "cpu"]),
            ("j", jcli, jserver, jmachine65, [])):
        work = tmp_path / tag
        work.mkdir()
        clip = str(work / "clip.npz")
        np.savez(clip, frames=gradient_movie(F=60), frame_rate=30.0)
        out = str(work / "clip.a2m")
        cli.main([clip, "--output", out, "--k", "8", "--video_mode",
                  mode_name] + extra)
        with open(out, "rb") as f:
            data = f.read()
        fetched = fetch(server_mod.build_handler(out))
        assert fetched == data
        results.append((data, machine.play_stream(fetched)))
    (tdata, tres), (jdata, jres) = results
    assert tdata == jdata and len(tdata) > 100 * 2048
    assert tres.exit_reason == "TERMINATED" and tres.n_recv >= 100
    assert_results_equal(tres, jres)
    vm = PlayerVM().decode(tdata)
    assert np.array_equal(tres.main, vm.main)
    assert np.array_equal(tres.aux, vm.aux)
    fetched_path = str(tmp_path / "fetched.a2m")
    with open(fetched_path, "wb") as f:
        f.write(tdata)
    assert tverify.main([fetched_path, "--machine"]) == 0
