"""A traced window reduced to what the per-layer metrics read (the union
and gap arithmetic copied from iivision_tpu_torch/bench.py `trace_rep`).

The benchmark wraps the calls into each layer in spans of its own
(`torch.profiler.record_function("bench.<name>")`).  From the profiler's
kineto events this keeps:

- every device activity (kernel, copy, set) inside the window, with the
  benchmark span that launched it: the device event shares its
  correlation id with the runtime call that launched it (or, failing
  that, names the host operation around it as its linked id), and the
  innermost benchmark span open on that host event's thread at its
  start is the one.  The profiler's mirrors of the host's ranges on the
  device timeline are no activity and are left out;
- the spans themselves, by thread.

Then: the union of device activity (busy seconds), device seconds by
span, the top device operations by name, and the idle gaps labelled by
the span open on the main thread while the device waited.
"""

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    t0: int  # window bounds, ns on the profiler's clock
    t1: int
    main_tid: int
    # (start, end, name, span or None), device activities in the window
    device: List[Tuple[int, int, str, Optional[str]]] = field(
        default_factory=list)
    # thread -> [(start, end, name)] of benchmark spans, by start
    spans: Dict[int, List[Tuple[int, int, str]]] = field(
        default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9


def _innermost(spans: List[Tuple[int, int, str]], t: int) -> Optional[str]:
    """The innermost span of one thread's (start-sorted) spans that holds
    time t: the latest-starting one that has not ended.  The benchmark's
    spans nest two deep with at most four children, so it lies among the
    last 64 that start by t."""
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    best = None
    for a, b, name in reversed(spans[max(0, i - 64):i]):
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, name)
    return None if best is None else best[1]


def from_kineto(events, window_span: str = "bench.window") -> Trace:
    """Reduce the kineto events of one profiled window (the profiler's
    `profiler.kineto_results.events()`).  The window is the span named
    `window_span`, and its thread is the main thread."""
    runtime, ops, spans, device = {}, {}, {}, []
    window = None
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CPU"):
            a = e.start_ns()
            tid = e.start_thread_id()
            (runtime if name.startswith("cu") else ops)[
                e.correlation_id()] = (a, tid)
            if name.startswith(SPAN_PREFIX):
                b = a + e.duration_ns()
                if name == window_span:
                    window = (a, b, tid)
                else:
                    spans.setdefault(tid, []).append(
                        (a, b, name[len(SPAN_PREFIX):]))
        elif not (name.startswith(SPAN_PREFIX) or e.is_user_annotation()):
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name, e.correlation_id(),
                           e.linked_correlation_id()))
    if window is None:
        raise ValueError("the trace holds no %r span" % window_span)
    for v in spans.values():
        v.sort()
    tr = Trace(window[0], window[1], window[2], spans=spans)
    for a, b, name, corr, linked in device:
        a, b = max(a, tr.t0), min(b, tr.t1)
        if b <= a:
            continue
        host = runtime.get(corr) or ops.get(linked)
        span = (None if host is None
                else _innermost(spans.get(host[1], []), host[0]))
        tr.device.append((a, b, name, span))
    tr.device.sort()
    return tr


def merged(tr: Trace) -> List[Tuple[int, int]]:
    """The union of device activity as disjoint intervals."""
    out = []
    for a, b, _, _ in tr.device:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in merged(tr)) / 1e9


def device_busy_s(events) -> Optional[float]:
    """Busy seconds of a window profiled with the device's activities
    alone: the union of every device activity, the profiler's mirrors of
    host ranges left out; None when it recorded none."""
    act = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), "", None)
                 for e in events
                 if not str(e.device_type()).endswith("CPU")
                 and not (e.name().startswith(SPAN_PREFIX)
                          or e.is_user_annotation()))
    return busy_s(Trace(0, 0, 0, device=act)) if act else None


def idle_pct(tr: Optional[Trace]) -> Optional[float]:
    """100 x (1 - union of device activity / window); None without a
    traced device activity."""
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - busy_s(tr) / tr.window_s)


def device_s(tr: Trace, span: str) -> Optional[float]:
    """Device seconds of the activities launched inside `span`; None when
    none was."""
    got = [b - a for a, b, _, s in tr.device if s == span]
    return sum(got) / 1e9 if got else None


def attributed_share(tr: Trace) -> float:
    """The share of device time that a benchmark span launched."""
    tot = sum(b - a for a, b, _, _ in tr.device)
    got = sum(b - a for a, b, _, s in tr.device if s is not None)
    return got / tot if tot else 0.0


def top_ops(tr: Trace, n: int = 10) -> List[list]:
    by = {}
    for a, b, name, _ in tr.device:
        by[name] = by.get(name, 0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_gaps(tr: Trace, n: int = 10) -> List[list]:
    """Idle device time by the benchmark span open on the main thread at
    each gap's middle ("none" outside every span), largest first."""
    main = tr.spans.get(tr.main_tid, [])
    by, end = {}, tr.t0
    for a, b in merged(tr) + [(tr.t1, tr.t1)]:
        if a > end:
            label = _innermost(main, (a + end) // 2) or "none"
            by[label] = by.get(label, 0) + (a - end)
        end = max(end, b)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]
