"""The program's spans in a trace (`model/program.py`), the readers of the
metrics that read them or the program's stage timings, and
`program_run`'s lent reduction on a tiny traced run on the CPU."""

import json

import pytest

from benchmark import harness, program_run, run
from benchmark.model import program, trace
from benchmark.tests.test_harness_model import Ev
from benchmark.tests.test_harness_run import _tiny

# test_harness_model.test_trace_reduction's events
BASE = [
    Ev("bench.window", "CPU", 0, 1000, corr=1, annotation=True),
    Ev("bench.ingest", "CPU", 10, 200, corr=2, annotation=True),
    Ev("bench.encode", "CPU", 300, 300, corr=3, annotation=True),
    Ev("aten::add", "CPU", 20, 5, corr=4),
    Ev("cudaLaunchKernel", "CPU", 21, 2, corr=50),
    Ev("cudaLaunchKernelExC", "CPU", 310, 2, corr=51),
    Ev("bench.fetch_emit", "CPU", 100, 600, corr=6, tid=2, annotation=True),
    Ev("add_kernel", "CUDA", 100, 100, corr=50, linked=4),
    Ev("body_kernel", "CUDA", 400, 200, corr=51),
    Ev("copy", "CUDA", 550, 100, corr=99, linked=77),
    Ev("bench.encode", "CUDA", 300, 300, corr=3, annotation=True),
]
# the program's ranges inside them, with their device mirrors (named and
# flagged as user annotations, as the profiler has them)
IIV = [
    Ev("iiv.ingest", "CPU", 12, 190, corr=20, annotation=True),
    Ev("iiv.ingest.resize", "CPU", 15, 10, corr=21, annotation=True),
    Ev("iiv.ingest.cat", "CPU", 150, 40, corr=22, annotation=True),
    Ev("iiv.encode", "CPU", 302, 290, corr=23, annotation=True),
    Ev("iiv.encode.launch", "CPU", 305, 20, corr=24, annotation=True),
    Ev("iiv.emit", "CPU", 200, 100, corr=25, tid=2, annotation=True),
    Ev("iiv.ingest", "CUDA", 100, 100, corr=20, annotation=True),
    Ev("iiv.encode.launch", "CUDA", 400, 200, corr=24, annotation=True),
]
# a mirror that the profiler failed to flag
UNFLAGGED = Ev("iiv.encode", "CUDA", 400, 200, corr=23)


def test_program_ranges_change_nothing_the_benchmark_reads():
    assert trace.from_kineto(BASE + IIV) == trace.from_kineto(BASE)


def test_program_spans_take_launches_and_idle_gaps():
    stats = program.by_span(program.from_kineto(BASE + IIV + [UNFLAGGED]))
    # add_kernel's runtime call (t = 21) is inside iiv.ingest.resize;
    # body_kernel's (t = 310) inside iiv.encode.launch; the copy has no
    # host event
    assert stats["iiv.ingest.resize"].launches == 1
    assert stats["iiv.ingest.resize"].device_s == pytest.approx(100e-9)
    assert stats["iiv.encode.launch"].launches == 1
    assert stats["iiv.encode.launch"].device_s == pytest.approx(200e-9)
    assert stats["none"].launches == 1
    # the mirrors are no device activity of any span
    assert sum(st.launches for st in stats.values()) == 3
    # idle 0-100, 200-400 and 650-1000, cut where main-thread spans open
    # or close: 0-10 none, 10-12 bench.ingest, 12-15 iiv.ingest, 15-25
    # its resize, 25-100 iiv.ingest; 200-202 iiv.ingest, 202-210
    # bench.ingest, 210-300 none, 300-302 bench.encode, 302-305
    # iiv.encode, 305-325 its launch, 325-400 iiv.encode; 650-1000 none
    idle = {n: st.idle_s * 1e9 for n, st in stats.items() if st.idle_s}
    assert idle == {"none": pytest.approx(450), "bench.ingest":
                    pytest.approx(10), "iiv.ingest": pytest.approx(80),
                    "iiv.ingest.resize": pytest.approx(10),
                    "bench.encode": pytest.approx(2),
                    "iiv.encode": pytest.approx(78),
                    "iiv.encode.launch": pytest.approx(20)}
    assert stats["iiv.ingest"].host_s == pytest.approx(190e-9)
    assert stats["iiv.emit"].host_s == pytest.approx(100e-9)
    ingest = program.within(stats, "iiv.ingest")
    assert (ingest.host_s, ingest.launches) == (pytest.approx(190e-9), 1)
    assert ingest.idle_s == pytest.approx(90e-9)
    assert program.idle_share(stats, "iiv.") == pytest.approx(188 / 650)
    assert [r[0] for r in program.table(stats)] == [
        "iiv.emit", "iiv.encode", "iiv.encode.launch", "iiv.ingest",
        "iiv.ingest.cat", "iiv.ingest.resize"]


NEW = ("encode.host_us_per_launch", "encode.wait_ms_per_movie_s",
       "ingest.launches_per_movie", "ingest.idle_ms_per_movie_s")


def _run(**kw):
    return harness.Run(workload="w", config={}, traffic={"batch": 2}, **kw)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_find_nothing_to_read(name):
    read = harness.reader(name)
    assert read(_run()) is None  # no trace, no clip
    # a clip of a program that keeps no launch or wait seconds
    old = {"encoder": "whole", "movie_seconds": 10.0, "frames_s": 0.05,
           "encode_s": 0.04}
    assert read(_run(timings=[old], movie_s=10.0, encodes=1)) is None
    # clips that took another encoder
    new = dict(old, encoder="streaming", launch_s=0.02, wait_s=0.01,
               body_launches=400)
    assert read(_run(timings=[new], movie_s=10.0, encodes=1)) is None


def test_new_readers_read():
    clips = [{"encoder": "whole", "movie_seconds": 10.0, "launch_s": 0.02,
              "wait_s": 0.01, "body_launches": 400},
             {"encoder": "whole", "movie_seconds": 10.0, "launch_s": 0.03,
              "wait_s": 0.03, "body_launches": 600}]
    r = _run(timings=clips, movie_s=20.0, encodes=2)
    assert harness.reader("encode.host_us_per_launch")(r) == \
        pytest.approx(50.0)
    assert harness.reader("encode.wait_ms_per_movie_s")(r) == \
        pytest.approx(2.0)
    r = _run(movie_s=20.0, encodes=2, trace=trace.from_kineto(BASE))
    # one activity launched in `ingest`, 2 rounds of 2 movies
    assert harness.reader("ingest.launches_per_movie")(r) == \
        pytest.approx(0.25)
    assert harness.reader("ingest.idle_ms_per_movie_s")(r) == \
        pytest.approx(1e3 * 100e-9 / 20.0)


def test_program_run_lends_and_puts_back():
    """A tiny traced solo run on the CPU through the lent reduction and
    client: the lines come out and everything is put back."""
    from benchmark import drive

    before = (trace.from_kineto, drive.client)
    kept = {}
    restore = program_run._lend(kept)
    try:
        code, line, lines = run.run_cell(
            "dhgr_solo_10s", 2 ** 31 + 5, 0.3, True, on_card=False,
            traffic_override=_tiny("dhgr_solo_10s"))
    finally:
        restore()
    assert (trace.from_kineto, drive.client) == before
    assert code == 0, lines
    assert json.loads(line)["correct"] is True
    out = program_run.summary(kept)
    assert [ln.split(":")[0] for ln in out] == ["program", "counters",
                                                "layer"]
    spans = {r[0] for r in json.loads(out[0][len("program: "):])["spans"]}
    assert {"iiv.frames", "iiv.encode", "iiv.encode.launch", "iiv.emit",
            "iiv.write"} <= spans
    # the counters count card launches: the CPU encode moves none
    assert json.loads(out[1][len("counters: "):]) == {}
    layer = json.loads(out[2][len("layer: "):])
    assert layer["encode.host_us_per_launch"] > 0
    assert layer["ingest.launches_per_movie"] is None


STREAM = {"stream.frames_ms_per_movie_s": "frames_s",
          "stream.encode_ms_per_movie_s": "encode_s"}


@pytest.mark.parametrize("name,key", sorted(STREAM.items()))
def test_stream_readers(name, key):
    """The streaming encode's readers sum the streaming clips alone, over
    their movie seconds, and find nothing without one."""
    read = harness.reader(name)
    whole = {"encoder": "whole", "movie_seconds": 10.0, "frames_s": 0.05,
             "encode_s": 0.04}
    assert read(_run()) is None
    others = [whole, dict(whole, encoder="chunked", movie_seconds=40.0)]
    assert read(_run(timings=others, movie_s=50.0, encodes=2)) is None
    streamed = [dict(whole, encoder="streaming", movie_seconds=80.0,
                     frames_s=0.4, encode_s=0.7),
                dict(whole, encoder="streaming", movie_seconds=80.0,
                     frames_s=0.6, encode_s=0.9)]
    r = _run(timings=others + streamed, movie_s=210.0, encodes=4)
    assert read(r) == pytest.approx(
        1e3 * sum(c[key] for c in streamed) / 160.0)


def test_batch_readers():
    """The card's pace from an untraced run's device profile, and the
    batch cells' copies of the per-layer readers of the solo cells."""
    card = harness.reader("card_realtime_x")
    assert card(_run(movie_s=20.0)) is None  # no device profile
    assert card(_run(movie_s=20.0, card_busy_s=4.0)) == pytest.approx(5.0)
    r = _run(movie_s=20.0, window_s=10.0, peak_bytes=2 * 10 ** 9,
             trace=trace.from_kineto(BASE))
    for name in ("realtime_x", "device.idle_pct", "device.peak_GB"):
        assert harness.reader(name + ".batch")(r) == \
            pytest.approx(harness.reader(name)(r))
        assert harness.reader(name + ".batch")(_run()) is None
