"""Whole runs at tiny sizes on the CPU (the harness's look for a card
skipped): a sound run is correct; the control, and each fault that a cell
can have planted under the timed path, is not.  On a card (`-m card`): the
control at the cells' own sizes on three seeds, and a short run of each
cell."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, harness, run

TINY = {
    "batch_pipelined": dict(clip_seconds=0.2, batch=2, pool=1,
                            sample_span=1, sample_rounds=1, sample_movies=2),
    "solo_closed": dict(clip_seconds=0.2, pool=2, sample_span=1,
                        sample_clips=1),
}
MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


STREAM_READERS = ("stream.frames_ms_per_movie_s",
                  "stream.encode_ms_per_movie_s")


def _tiny(cell):
    return TINY[harness.traffic_of(harness.cell(MAN, cell))["client"]]


def _run(cell, seed=2 ** 31 + 3, trace=False):
    code, line, lines = run.run_cell(cell, seed, 0.3, trace, on_card=False,
                                     traffic_override=_tiny(cell))
    assert code == 0, lines
    return json.loads(line), lines


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out, lines = _run(cell)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert lines[-1].startswith("check failed_clips")
    e2e = harness.metrics_of(MAN, cell, False)
    # every end-to-end metric read but those from the device's trace,
    # which a run on the CPU has not (test_short_run_on_card reads them)
    assert set(out["metrics"]) == {m["name"] for m in e2e
                                   if m["source"] != "device_trace"}
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]


def test_traced_run_reads_layer_metrics():
    out, lines = _run("dhgr_solo_10s", trace=True)
    assert out["correct"] is True
    assert "host_ingest.ms_per_movie_s" in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert any(ln.startswith("trace:") for ln in lines)


def test_traced_long_clip_run_reads_the_streaming_encoder(monkeypatch):
    """The long-clip cell with the program's streaming threshold lowered
    to its tiny clips: every clip takes the streaming encoder, as every 80 s
    clip does at the cell's size, the run is correct and the streaming
    readers read."""
    from iivision_tpu_torch import movie

    monkeypatch.setattr(movie, "STREAM_MIN_FRAMES", 4)
    code, line, lines = run.run_cell(
        "dhgr_solo_80s", 2 ** 31 + 5, 0.3, True, on_card=False,
        traffic_override=dict(_tiny("dhgr_solo_80s"), clip_seconds=0.1))
    assert code == 0, lines
    out = json.loads(line)
    assert out["correct"] is True
    enc = [ln for ln in lines if ln.startswith("encoders:")]
    assert len(enc) == 1 and enc[0].split()[1::2] == ["streaming"], enc
    for name in STREAM_READERS:
        assert out["metrics"][name]["value"] > 0


def test_a_new_client_file_is_found_by_name(tmp_path, monkeypatch):
    """A loop that only a new file under clients/ (and its limits file)
    defines drives a whole run, with no edit to drive.py."""
    import shutil

    from benchmark import drive
    from benchmark.reference import check

    (tmp_path / "clients").mkdir()
    (tmp_path / "limits").mkdir()
    shutil.copy(f"{drive.CLIENTS_DIR}/solo_closed.py",
                tmp_path / "clients" / "solo_copy.py")
    shutil.copy(f"{check.LIMITS_DIR}/solo_closed.json",
                tmp_path / "limits" / "solo_copy.json")
    monkeypatch.setattr(drive, "CLIENTS_DIR", str(tmp_path / "clients"))
    monkeypatch.setattr(check, "LIMITS_DIR", str(tmp_path / "limits"))
    with pytest.raises(KeyError):
        drive.client("solo_copy", directory=str(tmp_path))
    assert drive.client("solo_copy").__module__.endswith("solo_copy")
    code, line, lines = run.run_cell(
        "dhgr_solo_10s", 2 ** 31 + 9, 0.3, False, on_card=False,
        traffic_override=dict(_tiny("dhgr_solo_10s"), client="solo_copy"))
    assert code == 0, lines
    assert json.loads(line)["correct"] is True


@pytest.mark.parametrize("cell", ["dhgr_batch32_10s", "dhgr_solo_10s"])
def test_control_is_not_correct(cell):
    tr = dict(_tiny(cell), clip_seconds=0.4)
    out = control.control_numbers(cell, 2 ** 31 + 7, torch.device("cpu"), tr)
    assert out["correct"] is False


def _fault_state_unchanged(monkeypatch):
    """Every body returns its state unchanged (records stay padding)."""
    from iivision_tpu_torch import encoder

    monkeypatch.setattr(encoder.body, "encode_body",
                        lambda *a, **k: None)


def _fault_answer_altered(monkeypatch):
    """Each stream's 100th byte altered where the stream is produced."""
    from iivision_tpu_torch import movie
    from iivision_tpu_torch.stream import emit_fast

    real = emit_fast.emit_stream_fast

    def emit(*a, **k):
        data = bytearray(real(*a, **k))
        data[100] ^= 0x01
        return bytes(data)

    monkeypatch.setattr(emit_fast, "emit_stream_fast", emit)
    monkeypatch.setattr(movie, "emit_stream_fast", emit)


def _fault_half_batch(monkeypatch):
    """The second half of each batch left out: its movies get the first
    half's targets."""
    from iivision_tpu_torch.parallel import mesh

    real = mesh.ingest_movies_batch

    def ingest(rgb, *a, **k):
        h = (rgb.shape[0] + 1) // 2
        lanes, by = real(rgb[:h], *a, **k)
        idx = torch.arange(rgb.shape[0]) % h
        return lanes[idx], by[idx]

    monkeypatch.setattr(mesh, "ingest_movies_batch", ingest)


FAULTS = [(c, f) for c in CELLS for f in (
    _fault_state_unchanged, _fault_answer_altered)] + [
    (c, _fault_half_batch) for c in CELLS
    if harness.traffic_of(harness.cell(MAN, c))["client"]
    == "batch_pipelined"]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out, _ = _run(cell)
    assert out["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell):
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        assert control.control_numbers(cell, seed, card)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_card(card, cell):
    # a clip of `copies` copies takes about as many times as long: the
    # window still reaches the sampled clips
    copies = harness.traffic_of(harness.cell(MAN, cell)).get("copies", 1)
    code, line, lines = run.run_cell(cell, 2 ** 31 + 21, 3.0 * copies,
                                     False)
    assert code == 0, lines
    out = json.loads(line)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    names = {m["name"] for m in harness.metrics_of(MAN, cell, False)}
    assert set(out["metrics"]) == names
    assert all(np.isfinite(v["value"]) for v in out["metrics"].values())

