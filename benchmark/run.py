"""The port's benchmark: one run of one cell.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

A run is one process on one card, its host threads fixed first
(`steady_host`).  It sets up (the kernels built or
loaded from the checkout's cache, the distance model, the clip pool made
from the seed, one warm-up round of the cell's own shapes), drives the
cell's traffic for `--seconds` (`drive.py`), closes the window, reads the
device memory high-water mark, frees the program's state, checks the
sampled clips against the plain reference (`reference/check.py`) and
prints one JSON line: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics from
a torch.profiler trace of the window; an untraced run of a cell with an
end-to-end metric from the device's trace profiles the window's device
activities alone), `device`, `breakdown` (traced
runs) and, last, `checks`: each number compared beside its limit, which
are also the last lines on standard error.  Before them, standard error
has the encoder each of the window's clips took (solo loops), the
reference's seconds by stage and, traced, the share of device activity
inside the benchmark's spans.

Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result; if `jax`, `jaxlib`, `flax` or `iivision_tpu` is
loaded once the window has closed, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402

from benchmark import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "iivision_tpu")
CACHE = os.path.join(harness.BENCH_DIR, ".cache")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is one of
    FORBIDDEN, compared whole (`iivision_tpu_torch` is not
    `iivision_tpu`)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def steady_host() -> None:
    """One intra-op thread for torch and the BLAS libraries, set before
    numpy and torch load: the program's host work runs on its own pools,
    and idle intra-op workers only contend with them."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             on_card: bool = True, traffic_override: dict = None):
    """One run; returns (exit code, result line or None, stderr lines).
    on_card=False runs on the CPU (the tests' tiny runs), and
    traffic_override replaces traffic parameters."""
    import numpy as np
    import torch

    from benchmark import drive
    from benchmark.model import trace as trace_mod
    from benchmark.reference import check

    man = harness.manifest()
    w = harness.cell(man, workload)
    cfg = harness.config_of(man, w)
    tr = dict(harness.traffic_of(w), **(traffic_override or {}))
    if on_card:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(w["chips"]):
            return 2, None, ["the cell needs %d card(s); "
                             "torch.cuda.is_available() is %s, %d found"
                             % (w["chips"], torch.cuda.is_available(),
                                torch.cuda.device_count())]
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cpu")
    limits = check.load_limits(tr["client"])
    rng = np.random.default_rng(seed & ((1 << 64) - 1))
    spans = harness.Spans(tracing=trace)
    card_clock = on_card and not trace and any(
        m["source"] == "device_trace"
        for m in harness.metrics_of(man, workload, False))
    run = harness.Run(workload=workload, config=cfg, traffic=tr)
    client = drive.client(tr["client"])(cfg, tr, dev, rng, spans)
    try:
        client.warm()
        _sync(dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        run.setup_s = time.perf_counter() - T_START
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            with profile(activities=acts) as prof:
                with record_function("bench.window"):
                    client.window(seconds, run)
                    _sync(dev)
        elif card_clock:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                client.window(seconds, run)
                _sync(dev)
            run.card_busy_s = trace_mod.device_busy_s(
                prof.profiler.kineto_results.events())
            del prof
        else:
            client.window(seconds, run)
            _sync(dev)
        if on_card:
            run.peak_bytes = torch.cuda.max_memory_allocated(dev)
            run.card = torch.cuda.get_device_name(dev)
        run.spans_s = dict(spans.host_s)
        run.plan = client.plan_info
        if trace:
            run.trace = trace_mod.from_kineto(
                prof.profiler.kineto_results.events())
            del prof
        ins, outs = client.samples()
        client.release()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        st = check.Setting(cfg, tr["ingest"], dev)
        numbers = check.judge(st, ins, outs, limits)
    finally:
        client.close()
    correct = check.verdict(numbers, limits) and run.failed == 0
    metrics = {}
    for m in harness.metrics_of(man, workload, trace):
        v = harness.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": run.card or "cpu", "count": int(w["chips"]),
              "memory_peak_bytes": int(run.peak_bytes)}
    if on_card:
        device["power_limit"] = power_limit()
    breakdown = None
    if run.trace is not None:
        device["busy_s"] = trace_mod.busy_s(run.trace)
        device["window_s"] = run.trace.window_s
        breakdown = {"device_ops": trace_mod.top_ops(run.trace),
                     "idle_gaps": trace_mod.idle_gaps(run.trace)}
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in limits.items()}
    checks["failed_clips"] = {"value": run.failed, "limit": 0}
    lines = ["check %s: %r (limit %r)" % (k, v["value"], v["limit"])
             for k, v in checks.items()]
    if run.trace is not None:
        lines.insert(0, "trace: %d device activities, %.4f of their time "
                     "launched inside a benchmark span"
                     % (len(run.trace.device),
                        trace_mod.attributed_share(run.trace)))
    lines.insert(0, "reference: %s" % ", ".join(
        "%s %.3f s" % kv for kv in st.seconds.items()))
    if run.timings:
        lines.insert(0, "encoders: %s" % ", ".join(
            "%s %d" % kv for kv in sorted(Counter(
                x["encoder"] for x in run.timings).items())))
    bad = forbidden_modules()
    if bad:
        return 3, None, ["loaded after the window: %s" % ", ".join(bad)]
    return 0, harness.result_line(correct, run, metrics, device, checks,
                                  breakdown), lines


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    steady_host()
    import torch

    torch.set_num_threads(1)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    code, line, lines = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace))
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    if line is not None:
        print(line, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
