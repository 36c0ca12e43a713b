"""The yardstick's arithmetic: the work count does not depend on how the
plan is cut into launches, and the trace reduction's union, attribution
and gaps."""

import numpy as np
import pytest

from benchmark.model import roofline, trace
from benchmark.reference import plan as plan_mod
from benchmark.reference.video_mode import VideoMode


def _plan(mode, body_cap, seconds=2.0, k=16, j=4):
    old = plan_mod.BODY_CAP
    plan_mod.BODY_CAP = body_cap
    plan_mod._plan_movie_cached.cache_clear()
    try:
        return plan_mod.plan_movie(int(30 * seconds), int(14700 * seconds),
                                   30.0, 14700.0, 2, mode, k, j)
    finally:
        plan_mod.BODY_CAP = old
        plan_mod._plan_movie_cached.cache_clear()


@pytest.mark.parametrize("mode", ["DHGR", "HGR"])
def test_work_independent_of_body_split(mode):
    works = set()
    for cap in (1, 2, 3, 8):
        p, n_enc = _plan(VideoMode[mode], cap)
        assert p.chunk_steps <= cap
        works.add(roofline.encode_work(p.step_nvalid, p.step_recompute,
                                       n_enc, mode, 32))
    assert len(works) == 1


def test_padding_and_fusion_add_nothing():
    p, n_enc = _plan(VideoMode.DHGR, 8)
    w = roofline.encode_work(p.step_nvalid, p.step_recompute, n_enc, "DHGR",
                             4)
    # steps that run nothing, wherever they sit, and a chunk start counted
    # once whether it has a launch of its own or not
    nv = np.concatenate([p.step_nvalid, np.zeros(5, np.int32)])
    rc = np.concatenate([p.step_recompute, np.zeros(5, bool)])
    assert roofline.encode_work(nv, rc, n_enc, "DHGR", 4) == w
    assert w.bytes > 0 and w.int32_ops > 0 and w.fp32_ops == 0


def test_work_scales_with_batch_and_counts():
    p, n_enc = _plan(VideoMode.DHGR, 8)
    w1 = roofline.encode_work(p.step_nvalid, p.step_recompute, n_enc, "DHGR",
                              1)
    w2 = roofline.encode_work(p.step_nvalid, p.step_recompute, n_enc, "DHGR",
                              2)
    assert w2.int32_ops == 2 * w1.int32_ops
    assert w2.bytes == 2 * w1.bytes - 16 * 16 * 4
    n_ops = int(np.sum(p.step_nvalid))
    assert w1.bytes == (n_enc * 2 * 8192 + n_ops * 512 + n_ops * 6 + 2 * 8192
                        + 1024)
    un = roofline.encode_work(p.step_nvalid, p.step_recompute, n_enc, "DHGR",
                              1, seeded=False)
    chunks = int(np.sum(p.step_recompute))
    assert un.int32_ops == chunks * 32 * 240 * 4 * 10


def test_peaks():
    pk = roofline.peaks_of("NVIDIA H100 80GB HBM3")
    assert pk.hbm_bytes_per_s == 3.35e12
    with pytest.raises(ValueError):
        roofline.peaks_of("some other card")
    w = roofline.Work(3.35e12, 0.0, 0.0)
    assert roofline.least_seconds(w, pk) == pytest.approx(1.0)


class Ev:
    """A stand-in for a kineto event."""

    def __init__(self, name, dev, start, dur, corr=0, linked=0, tid=1,
                 annotation=False):
        self._v = (name, dev, start, dur, corr, linked, tid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def test_trace_reduction():
    evs = [
        Ev("bench.window", "CPU", 0, 1000, corr=1, annotation=True),
        Ev("bench.ingest", "CPU", 10, 200, corr=2, annotation=True),
        Ev("bench.encode", "CPU", 300, 300, corr=3, annotation=True),
        Ev("aten::add", "CPU", 20, 5, corr=4),
        Ev("cudaLaunchKernel", "CPU", 21, 2, corr=50),
        Ev("cudaLaunchKernelExC", "CPU", 310, 2, corr=51),
        Ev("bench.fetch_emit", "CPU", 100, 600, corr=6, tid=2,
           annotation=True),
        Ev("add_kernel", "CUDA", 100, 100, corr=50, linked=4),
        Ev("body_kernel", "CUDA", 400, 200, corr=51),
        Ev("copy", "CUDA", 550, 100, corr=99, linked=77),
        Ev("bench.encode", "CUDA", 300, 300, corr=3, annotation=True),
    ]
    tr = trace.from_kineto(evs)
    assert tr.window_s == pytest.approx(1e-6)
    assert trace.busy_s(tr) == pytest.approx(350e-9)
    assert trace.device_s(tr, "ingest") == pytest.approx(100e-9)
    assert trace.device_s(tr, "encode") == pytest.approx(200e-9)
    assert trace.device_s(tr, "fetch_emit") is None
    assert trace.attributed_share(tr) == pytest.approx(300 / 400)
    assert trace.top_ops(tr)[0] == ["body_kernel", pytest.approx(2e-7)]
    gaps = dict(trace.idle_gaps(tr))
    # idle 0-100 (in ingest), 200-400 (encode from 300; none before),
    # 650-1000 (none)
    assert sum(gaps.values()) == pytest.approx(650e-9)
    assert gaps["ingest"] == pytest.approx(100e-9)


def test_device_busy_of_a_device_only_profile():
    # the device's activities alone, as a profile of those has them: the
    # union of the kernels and the copy, the mirror of a host range left out
    evs = [Ev("add_kernel", "CUDA", 100, 100, corr=50),
           Ev("body_kernel", "CUDA", 400, 200, corr=51),
           Ev("copy", "CUDA", 550, 100, corr=99),
           Ev("bench.encode", "CUDA", 300, 300, corr=3, annotation=True),
           Ev("cudaLaunchKernel", "CPU", 21, 2, corr=50)]
    assert trace.device_busy_s(evs) == pytest.approx(350e-9)
    assert trace.device_busy_s(evs[3:]) is None
