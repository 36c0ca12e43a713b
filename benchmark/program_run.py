"""One run of one cell, made by `benchmark.run` as its command line makes it,
that also reads the program's own spans and launch counters:

    python3 -m benchmark.program_run --workload NAME --seed N --seconds S \\
        --trace 0|1

It prints what `benchmark.run` prints, then three lines on standard error:

- `program: {...}` (traced runs): per `iiv.` span of
  `iivision_tpu_torch.trace`, [name, host_s, device_s, launches, idle_s]
  (`model/program.py`), the share of the window's idle device time that
  fell while a program span was the innermost open on the main thread,
  and for batch cells device ingest's totals (`iiv.ingest` and its
  sub-spans) and the share of the idle time inside the benchmark's
  `ingest` span that fell inside an `iiv.ingest.*` sub-span, and the
  number of device activities in the benchmark's own reduction that bear
  a program range's name (its device mirror: 0 unless that reduction
  counts them);
- `counters: {...}`: the kernel launch counters' change over the window
  (`iivision_tpu_torch.trace.counters`), those that moved;
- `layer: {...}`: the per-layer metrics `LAYER`, read from this run's
  record whether traced or not (an untraced run reads
  `encode.host_us_per_launch` without the profiler's callbacks).

`benchmark.run` keeps neither the kineto events past its own reduction
nor a counter.  For the one call, this entry has `model.trace.from_kineto`
also reduce the events with `model.program`, and the cell's client take
the counters around its window; both are put back after it.  Once
`benchmark.run` keeps both itself (`Run.program`, `Run.counters`) and
prints these lines, this entry and its lending go.
"""

import json
import sys

from benchmark import run

LAYER = ("encode.host_us_per_launch", "encode.wait_ms_per_movie_s",
         "ingest.launches_per_movie", "ingest.idle_ms_per_movie_s")


def _lend(kept: dict):
    """Replace `trace.from_kineto` and `drive.client` for one run; returns
    the function that puts them back."""
    from benchmark import drive
    from benchmark.model import program, trace

    reduce, client = trace.from_kineto, drive.client

    def both(events, window_span="bench.window"):
        events = list(events)
        kept["program"] = program.by_span(
            program.from_kineto(events, window_span, reduce))
        kept["trace"] = tr = reduce(events, window_span)
        return tr

    def counted(name, directory=None):
        base = client(name, directory)

        class Counted(base):
            def window(self, seconds, record):
                from iivision_tpu_torch.trace import counters

                c0 = counters()
                base.window(self, seconds, record)
                c1 = counters()
                kept["counters"] = {k: c1[k] - c0[k] for k in c1
                                    if c1[k] != c0[k]}
                kept["run"] = record

        return Counted

    trace.from_kineto, drive.client = both, counted

    def restore():
        trace.from_kineto, drive.client = reduce, client

    return restore


def summary(kept: dict) -> list:
    """The `program:`, `counters:` and `layer:` lines of a finished run."""
    from benchmark import harness
    from benchmark.model import program

    lines = []
    if "program" in kept:
        stats = kept["program"]
        ingest = program.within(stats, "iiv.ingest")
        sub = sum(st.idle_s for n, st in stats.items()
                  if n.startswith("iiv.ingest."))
        inside = program.idle_by_span(kept["trace"]).get("ingest")
        out = {"spans": program.table(stats),
               "idle_share_in_iiv": program.idle_share(stats, "iiv."),
               "none": vars(stats.get("none", program.SpanStats())),
               # device activities of the benchmark's trace named as a
               # program range (its mirror): none, or the trace counts them
               "iiv_named_device_activities": sum(
                   1 for d in kept["trace"].device
                   if d[2].startswith(program.PROGRAM_PREFIX))}
        if ingest.host_s:
            out["iiv.ingest_total"] = vars(ingest)
            out["bench.ingest_idle_s"] = inside
            out["ingest_idle_share_in_substages"] = (
                sub / inside if inside else None)
        lines.append("program: " + json.dumps(out))
    lines.append("counters: " + json.dumps(kept.get("counters")))
    if "run" in kept:
        lines.append("layer: " + json.dumps(
            {m: harness.reader(m)(kept["run"]) for m in LAYER}))
    return lines


def main(argv=None) -> int:
    run.steady_host()  # before numpy loads, as `run.main` has it
    kept = {}
    restore = _lend(kept)
    try:
        code = run.main(argv)
    finally:
        restore()
    for ln in summary(kept):
        print(ln, file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
