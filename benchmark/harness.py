"""The parts of a run that every cell shares: the manifest and the files it
names, the run's record that the metric readers read, the benchmark's own
spans, and the result line.

A cell (`workloads` entry of BENCHMARK.json) names a configuration, whose
file is `benchmark/configs/<config>.json`, and a traffic mix, whose file is
`benchmark/traffic/<traffic>.json`.  Each metric is read by
`benchmark/metrics/<name>.py`, whose `read(run)` returns a number or None
when it finds nothing to read.  A cell reports an end-to-end metric when
the metric lists the cell under `workloads` or lists none, and a
per-layer metric on the same rule, among those that move an end-to-end
metric the cell reports.
"""

import importlib.util
import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: str = MANIFEST) -> dict:
    return load_json(path)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload %r in BENCHMARK.json" % name)


def config_of(man: dict, w: dict) -> dict:
    for c in man["configs"]:
        if c["name"] == w["config"]:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError("no configuration %r" % w["config"])


def traffic_of(w: dict) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic",
                                  w["traffic"] + ".json"))


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", (workload,))


def metrics_of(man: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
    e2e = [m for m in man["end_to_end"] if _reports(m, workload)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if m["moves"] in moved and _reports(m, workload)]


def reader(name: str):
    """The `read` function of benchmark/metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """The benchmark's spans around its calls into the program: host
    seconds summed by name (always), and under the profiler a
    `record_function("bench.<name>")` range that the trace reads."""

    def __init__(self, tracing: bool = False):
        self.tracing = tracing
        self.host_s = defaultdict(float)
        self._lock = threading.Lock()

    @contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        if self.tracing:
            from torch.profiler import record_function

            with record_function("bench." + name):
                yield
        else:
            yield
        dt = time.perf_counter() - t
        with self._lock:
            self.host_s[name] += dt


@dataclass
class Run:
    """What one run measured, for the metric readers."""
    workload: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    movie_s: float = 0.0  # movie seconds of the streams completed
    attempted: int = 0
    failed: int = 0
    clip_s: List[float] = field(default_factory=list)  # each clip's wall
    # per clip: the program's Movie.timings and encoder (solo cells)
    timings: List[dict] = field(default_factory=list)
    spans_s: Dict[str, float] = field(default_factory=dict)
    peak_bytes: int = 0
    card: str = ""
    trace: Optional[object] = None  # model.trace.Trace of a traced run
    # busy device seconds of the window, in an untraced run of a cell that
    # reports an end-to-end metric read from the device's trace
    card_busy_s: Optional[float] = None
    # the plan's per-step arrays and shapes, for the work count
    plan: Optional[dict] = None
    encodes: int = 0  # batches (or clips) encoded in the window


def result_line(correct: bool, run: Run, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    """The last line of standard output; `checks` comes last."""
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
