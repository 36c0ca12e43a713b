"""The benchmark of the PyTorch and CUDA port, `iivision_tpu_torch`, driven by
BENCHMARK.json at the repository's root:

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

`run` (one run of one cell), `harness` (the manifest, the run's record,
the spans, the result line), `drive` (the traffic generator's general
part), `clients/` (one loop a file, named by a mix), `configs/` and
`traffic/` (data, one file a configuration or mix), `metrics/` (one
reader a metric), `gen/` (the inputs from the seed), `model/` (the work
count and the trace arithmetic), `reference/` (the plain reference and
the check that decides `correct`), `control` (the check's control) and
`tests/` (`python -m pytest benchmark/tests -q`).
"""
