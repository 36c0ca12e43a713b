"""BENCHMARK.json against the rules its format follows, and
the files it names."""

import math
import os
import re

import pytest

from benchmark import drive, harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"] for m in MAN["end_to_end"]}
CELLS = {w["name"] for w in MAN["workloads"]}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(MAN["command"]) <= 32
    assert all(not a.startswith("/") and ".." not in a
               for a in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p)
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(harness.json.dumps(MAN)) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[key]:
            yield key, e["name"]


@pytest.mark.parametrize("key,name", list(_names()))
def test_names(key, name):
    assert NAME.match(name), name
    assert sum(1 for k, n in _names() if k == key and n == name) == 1


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for w in m.get("workloads", ()):
        assert w in CELLS, w
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics",
                                       m["name"] + ".py"))
    harness.reader(m["name"])  # loads
    if m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in E2E
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_setup_s():
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] <= 0.25
    assert "workloads" not in setup[0]


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200
    cfg = harness.config_of(MAN, w)
    tr = harness.traffic_of(w)
    assert cfg["video_mode"] in ("DHGR", "HGR")
    assert os.path.isfile(os.path.join(drive.CLIENTS_DIR,
                                       tr["client"] + ".py"))
    assert callable(drive.client(tr["client"]))
    e2e = harness.metrics_of(MAN, w["name"], trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.metrics_of(MAN, w["name"], trace=True)
    assert layer
    for m in MAN["per_layer"]:
        if w["name"] in m.get("workloads", ()):
            # a cell that reports a layer metric reports what it moves
            assert m["moves"] in names, (m["name"], w["name"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(1 for w in MAN["workloads"] if w["chips"] == 4)
    assert four <= max(1, math.floor(0.25 * len(MAN["workloads"])))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert any(w["config"] == c["name"] for w in MAN["workloads"])
    assert c["file"].startswith(MAN["paths"][0] + "/")
    assert len(c["reduced"]) <= 16
    cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert 1 <= len(c["source"]) <= 200


def test_limits_cover_every_client():
    from benchmark.reference import check

    for w in MAN["workloads"]:
        limits = check.load_limits(harness.traffic_of(w)["client"])
        assert "stream_bad_bytes" in limits and limits["stream_bad_bytes"] == 0
