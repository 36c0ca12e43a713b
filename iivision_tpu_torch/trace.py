"""The port's spans and launch counters: one system for `Movie.timings`,
the CLI's batch timing and a profiler's trace.

    with span("encode.launch", into=timings):
        ...

A span always reads `time.perf_counter_ns()` twice and, given `into` (a
dict), adds its seconds to `into["<last dotted part of name>_s"]`
(`encode.launch` -> `launch_s`), summing repeated spans.  Only while a
torch profiler records does it also open
`torch.profiler.record_function("iiv.<name>")`: the range lands in the
profiler's event list on the thread that opened it, on the clock of every
device activity there, so a trace can put each kernel launch and each idle
gap of the device down to the program stage that was open.  With no
profiler a span makes no torch call: two clock reads and a branch on
torch's process-wide flag (`torch.autograd.profiler._is_profiler_enabled`;
`torch.autograd._profiler_enabled()` is false on every thread but the
profiler's own).  A profiler records the ranges of other threads only when
it is made to (`_ExperimentalConfig(profile_all_threads=True)`).
Recording follows the profiler; nothing else switches it.

`counters()` snapshots the kernel wrappers' launch counters (made by
`_build.counter`, kept by `_build.count`) by "wrapper.attr".
"""

import importlib
import pkgutil
from time import perf_counter_ns

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = "iiv."


class span:
    """Context manager: one stage of the program (see the module
    docstring).  `name` is short and dotted, the parent stage first."""

    __slots__ = ("name", "into", "_t0", "_range")

    def __init__(self, name: str, into: dict = None):
        self.name = name
        self.into = into
        self._range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.into is not None:
            key = self.name.rpartition(".")[2] + "_s"
            self.into[key] = self.into.get(key, 0.0) + dt / 1e9
        return False


def counters() -> dict:
    """{"wrapper.attr": launches} of every kernel launch counter
    (`_build.COUNTERS`), read under the counters' lock (a mesh's shards
    count from threads of their own).  The counters count launches on a
    card, from 0 in each process; take the difference of two snapshots."""
    from iivision_tpu_torch import _build, ops

    # each kernel's module makes its counters when it is imported
    for mod in pkgutil.iter_modules(ops.__path__):
        importlib.import_module("%s.%s" % (ops.__name__, mod.name))
    with _build.COUNT_LOCK:
        return {"%s.%s" % (fn.__name__, a): getattr(fn, a)
                for fn, a in _build.COUNTERS}
