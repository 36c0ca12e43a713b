"""The port's spans and launch counters (`iivision_tpu_torch.trace`) on the
CPU: a span opens a profiler range only while a profiler records, `into=`
sums, `Movie.timings` holds every stage and adds up to the wall time, the
streaming encoder's pulls count as host ingest, the encode's local count of
bodies follows the plan, and the launch counters (card launches) are the
ones the chip smoke reads."""

import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from iivision_tpu_torch import audio, encoder, frames, movie, trace
from iivision_tpu_torch.movie import STAGES, Movie
from iivision_tpu_torch.ops import distance
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

DHGR = VideoMode.DHGR


def clip(F=2, h=192, w=140):
    t = np.linspace(0, 1, F)[:, None, None]
    yy = np.linspace(0, 1, h)[None, :, None]
    xx = np.linspace(0, 1, w)[None, None, :]
    return np.stack([255 * np.broadcast_to(np.abs(np.sin(3 * (xx + t))),
                                           (F, h, w)),
                     255 * np.broadcast_to(yy * (1 - t), (F, h, w)),
                     255 * np.broadcast_to(xx * t, (F, h, w))],
                    axis=-1).astype(np.uint8)


@pytest.fixture(scope="module")
def dist():
    return distance.ComputedDistance(DHGR, Palette.NTSC, "window",
                                     device="cpu")


def transcode(dist, path):
    """(wall seconds around construction and transcode, Movie, stats,
    launch counters' delta) of a 2-frame clip."""
    tone = (np.sin(2 * np.pi * 330 * np.arange(6000) / 6000)
            * 12000).astype(np.float32)
    aud = audio.Audio(data=tone, rate=14700, bitrate=14700, device="cpu")
    c0 = trace.counters()
    t0 = time.perf_counter()
    m = Movie(frames_source=clip(), device="cpu", every_n_video_frames=2,
              k=8, dist=dist, audio_source=aud)
    stats = m.transcode(str(path))
    wall = time.perf_counter() - t0
    c1 = trace.counters()
    return wall, m, stats, {k: c1[k] - c0[k] for k in c1}


@pytest.fixture(scope="module")
def whole(dist, tmp_path_factory):
    return transcode(dist, tmp_path_factory.mktemp("whole") / "w.a2m")


def test_span_without_profiler_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(trace, "record_function", opened.append)
    assert not torch.autograd.profiler._is_profiler_enabled
    with trace.span("a"):
        with trace.span("a.b", {}):
            pass
    assert opened == []


def test_into_sums_repeated_spans(monkeypatch):
    ticks = iter([0, 1000, 5000, 8000, 10000, 10000])
    monkeypatch.setattr(trace, "perf_counter_ns", lambda: next(ticks))
    into = {"launch_s": 1.0}
    for _ in range(3):
        with trace.span("encode.launch", into):
            pass
    # the key is the name's last dotted part
    assert into == {"launch_s": pytest.approx(1.0 + 4000 / 1e9)}


def test_profiler_ranges_nest_on_the_opening_thread():
    def worker():
        with trace.span("t"):
            torch.ones(2).sum()

    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=every_thread) as prof:
        with trace.span("a"):
            with trace.span("a.b"):
                torch.ones(2).sum()
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=60)
    assert not th.is_alive()
    evs = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("iiv."):
            evs.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.start_thread_id()))
    assert sorted(evs) == ["iiv.a", "iiv.a.b", "iiv.t"]
    assert all(len(v) == 1 for v in evs.values())
    (a0, a1, ta), (b0, b1, tb), (_, _, tt) = (evs[n][0] for n in
                                              ("iiv.a", "iiv.a.b", "iiv.t"))
    assert a0 <= b0 <= b1 <= a1 and ta == tb != tt


def test_movie_timings_hold_every_stage_and_sum_to_the_wall(whole):
    wall, m, st, _ = whole
    assert m.encoder_used == "whole"
    nested = {"targets_s", "launch_s", "wait_s"}
    assert {s + "_s" for s in STAGES} | nested <= set(st)
    assert st["total_s"] == pytest.approx(sum(st[s + "_s"] for s in STAGES))
    assert st["total_s"] <= wall <= 1.02 * st["total_s"]
    assert sum(st[k] for k in nested) <= st["encode_s"]
    assert st["realtime_x"] == pytest.approx(st["movie_seconds"]
                                             / st["total_s"])


def test_body_launches_follow_the_plan(whole):
    _, m, st, _ = whole
    S, Sc = len(m.plan.step_frame), m.plan.chunk_steps
    assert st["body_launches"] == len(range(0, S, Sc)) > 1


def test_counters_delta_is_the_bodies_launched(whole):
    """The counters count launches on a card: a CPU encode runs the plain
    bodies and launches no kernel, so no counter moves, while the local
    `body_launches` follows the plan.  (On a card, `chip_smoke.py` holds
    the counters' delta to `body_launches`.)"""
    _, _, st, delta = whole
    assert {"encode_body.launches", "encode_body.joint_launches",
            "encode_body.recompute_launches",
            "encode_body.yiq_recompute_launches",
            "threefry_uniform.launches", "pair_distance.launches",
            "dist_pairs_elementwise.launches", "lane_distance.launches",
            "run_kernel.launches", "ingest_batch.launches"} == set(delta)
    assert st["body_launches"] > 1
    assert delta == {k: 0 for k in delta}


def test_smoke_reads_every_counter():
    """The chip smoke names its kernels' launch counters as `counters()`
    does, one kernel a counter: one list of counters, `_build.COUNTERS`."""
    import chip_smoke

    named = [c for c, *_ in chip_smoke.KERNELS.values()]
    assert sorted(named) == sorted(trace.counters())


def test_streaming_pulls_count_as_host_ingest(dist, tmp_path, monkeypatch):
    """The generator's pulls (each made to sleep) land in frames_s and are
    not counted again in encode_s: the stages still add up to the wall."""
    slept = []
    real = frames.ingest_stream_array

    def slow(*a, **kw):
        for item in real(*a, **kw):
            time.sleep(0.05)
            slept.append(0.05)
            yield item

    monkeypatch.setattr(movie, "STREAM_MIN_FRAMES", 0)
    monkeypatch.setattr(frames, "ingest_stream_array", slow)
    wall, m, st, _ = transcode(dist, tmp_path / "s.a2m")
    assert m.encoder_used == "streaming" and slept
    assert st["frames_s"] >= sum(slept)
    assert st["encode_s"] <= wall - sum(slept)
    assert st["total_s"] <= wall <= 1.02 * st["total_s"]
    assert st["targets_s"] > 0 and st["launch_s"] > 0


def test_each_encode_counts_into_its_own_dict(dist):
    """Two encodes, each with its own dict, count their own bodies (a local
    count: no other encode's launches land in it)."""
    plan, n_enc = encoder.plan_movie(
        n_frames=2, n_audio_ticks=980, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=2, mode=DHGR, k=8,
        j=1)
    rgb = torch.zeros((n_enc, 32, 256), dtype=torch.uint8)
    lanes, bytes_ = encoder.prepare_targets(rgb, rgb, DHGR, "cpu")
    got = []
    for _ in range(2):
        into = {}
        encoder.encode_movie(dist, lanes, bytes_, plan, DHGR, seed=None,
                             into=into)
        got.append(into["body_launches"])
    want = len(range(0, len(plan.step_frame), plan.chunk_steps))
    assert got == [want, want]
