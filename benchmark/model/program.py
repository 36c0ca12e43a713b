"""The program's own spans in a traced window: the `iiv.<name>` ranges that
`iivision_tpu_torch.trace.span` opens while a profiler records, read from
the kineto events that `model/trace.py` reads, on the same clock.

`from_kineto` runs `trace.from_kineto` on a view of the events in which
every `iiv.` range, and every benchmark span but the window, reads as a
benchmark span named by its full name (`iiv.ingest.resize`,
`bench.ingest`).  So the device activities are put down to spans, and the
idle gaps labelled, by that module's own rule (the launching runtime
call's correlation id, else the linked host operation; the innermost span
open on its thread, `trace._innermost`), now with both kinds of span, the
program's nested inside the benchmark's.  The device mirrors of both kinds
stay out of the device activities by their new name.  `trace._innermost`
looks back over the last 64 spans that started on the thread: an idle gap
between the sub-spans of a stage that opened more than 64 spans earlier
(a batch's `iiv.ingest` holds about 130) reads as "none", never as a
wrong span.

`by_span` then gives per span: host seconds (summed over threads, inside
the window), the device seconds and the number of device activities it
launched, and the idle device seconds while it was the innermost span open
on the main thread (`idle_by_span`: each idle gap cut where a main-thread
span opens or closes, each piece to the span open over it; where
`trace.idle_gaps` gives a whole gap to the span open at its middle, a
solo clip's gap from the end of its encode to the next clip's first
upload would go to the longest stage in it).  A profiler records the
ranges of other threads than its own only when asked to
(`_ExperimentalConfig(profile_all_threads=True)`); without that, what a
worker launches reads as "none".
"""

import bisect
from dataclasses import dataclass
from typing import Dict, Optional

from benchmark.model import trace

PROGRAM_PREFIX = "iiv."


class _Renamed:
    """A kineto event under another name."""

    __slots__ = ("_e", "_name")

    def __init__(self, e, name: str):
        self._e, self._name = e, name

    def name(self):
        return self._name

    def __getattr__(self, attr):
        return getattr(self._e, attr)


def _view(events, window_span: str):
    for e in events:
        name = e.name()
        if name != window_span and (name.startswith(PROGRAM_PREFIX)
                                    or name.startswith(trace.SPAN_PREFIX)):
            yield _Renamed(e, trace.SPAN_PREFIX + name)
        else:
            yield e


def from_kineto(events, window_span: str = "bench.window",
                reduce=None) -> trace.Trace:
    """`trace.from_kineto` (or `reduce`, a function of the same form) with
    the program's spans and the benchmark's, each under its full name
    (`iiv.encode.launch`, `bench.clip`)."""
    return (reduce or trace.from_kineto)(_view(events, window_span),
                                         window_span)


@dataclass
class SpanStats:
    host_s: float = 0.0
    device_s: float = 0.0
    launches: int = 0  # device activities launched inside
    idle_s: float = 0.0  # device idle while innermost on the main thread


def by_span(tr: trace.Trace) -> Dict[str, SpanStats]:
    """SpanStats of every span of `from_kineto`'s trace, and of "none"
    (what no span holds)."""
    out = {}

    def at(name):
        return out.setdefault(name or "none", SpanStats())

    for spans in tr.spans.values():
        for a, b, name in spans:
            a, b = max(a, tr.t0), min(b, tr.t1)
            if b > a:
                at(name).host_s += (b - a) / 1e9
    for a, b, _, name in tr.device:
        st = at(name)
        st.device_s += (b - a) / 1e9
        st.launches += 1
    for name, s in idle_by_span(tr).items():
        at(name).idle_s += s
    return out


def idle_by_span(tr: trace.Trace) -> Dict[str, float]:
    """Idle device seconds by the innermost span open on the main thread
    ("none" outside every span), each gap cut at the main thread's span
    boundaries."""
    main = tr.spans.get(tr.main_tid, [])
    cuts = sorted({t for a, b, _ in main for t in (a, b)})
    by, end = {}, tr.t0
    for a, b in trace.merged(tr) + [(tr.t1, tr.t1)]:
        lo, i = end, bisect.bisect_right(cuts, end)
        while lo < a:
            hi = min(a, cuts[i]) if i < len(cuts) else a
            label = trace._innermost(main, (lo + hi) // 2) or "none"
            by[label] = by.get(label, 0) + (hi - lo)
            lo, i = hi, i + 1
        end = max(end, b)
    return {k: v / 1e9 for k, v in by.items()}


def within(stats: Dict[str, SpanStats], span: str) -> SpanStats:
    """The sum of `span`'s stats and its sub-spans' (`span.*`); host
    seconds are `span`'s own, which hold its sub-spans'."""
    out = SpanStats()
    for name, st in stats.items():
        if name == span or name.startswith(span + "."):
            out.device_s += st.device_s
            out.launches += st.launches
            out.idle_s += st.idle_s
            if name == span:
                out.host_s = st.host_s
    return out


def idle_share(stats: Dict[str, SpanStats], prefix: str) -> Optional[float]:
    """The share of the window's idle device time labelled with a span
    whose name starts with `prefix`; None with no idle time."""
    tot = sum(st.idle_s for st in stats.values())
    got = sum(st.idle_s for n, st in stats.items() if n.startswith(prefix))
    return got / tot if tot else None


def table(stats: Dict[str, SpanStats]) -> list:
    """[[span, host_s, device_s, launches, idle_s]] of the program's spans,
    by name."""
    return [[n, st.host_s, st.device_s, st.launches, st.idle_s]
            for n, st in sorted(stats.items())
            if n.startswith(PROGRAM_PREFIX)]
