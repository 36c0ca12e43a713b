"""Whole runs at tiny sizes on the CPU (the harness's look for a card
skipped): a sound run is correct; the control, and each fault that a cell
can have planted under the timed path, is not.  On a card (`-m card`): the
control at the cells' own sizes on three seeds, and a short run of each
cell."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, drive, harness, run

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
MIXED = "t_mixed"  # the tests' own mixed-length cell (fixture `mixed_cell`)
RUN_CELLS = CELLS + [MIXED]


STREAM_READERS = ("stream.frames_ms_per_movie_s",
                  "stream.encode_ms_per_movie_s")


def _client(cell):
    return harness.traffic_of(harness.cell(harness.manifest(), cell))["client"]


def _use(cell, request):
    """Add the tests' own mixed-length cell where a case takes it."""
    if cell == MIXED:
        request.getfixturevalue("mixed_cell")


def _tiny(cell):
    """The tiny-run overrides that the cell's client declares."""
    return dict(drive.client(_client(cell)).TINY)


def _run(cell, seed=2 ** 31 + 3, trace=False):
    code, line, lines = run.run_cell(cell, seed, 0.3, trace, on_card=False,
                                     traffic_override=_tiny(cell))
    assert code == 0, lines
    return json.loads(line), lines


@pytest.mark.parametrize("cell", RUN_CELLS)
def test_sound_run_is_correct(cell, request):
    _use(cell, request)
    out, lines = _run(cell)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert lines[-1].startswith("check failed_clips")
    # the mixed client keeps no final screens: its padded encode's hold
    # the padding
    assert ("finals_bad_bytes" in out["checks"]) == (cell != MIXED)
    e2e = harness.metrics_of(harness.manifest(), cell, False)
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

    from benchmark.reference import check

    tiny = _tiny("dhgr_solo_10s")
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
        traffic_override=dict(tiny, client="solo_copy"))
    assert code == 0, lines
    assert json.loads(line)["correct"] is True


def test_a_new_client_brings_its_own_tiny_run(tmp_path, monkeypatch,
                                             mixed_cell):
    """A new client file declares its own tiny-run overrides (`TINY`): a
    cell on it runs tiny through these tests with no edit to them."""
    import shutil

    from benchmark.reference import check

    (tmp_path / "clients").mkdir()
    (tmp_path / "limits").mkdir()
    text = open(f"{drive.CLIENTS_DIR}/batch_mixed.py").read()
    tiny = "TINY = dict(lengths_s=[0.2, 0.3, 0.5],"
    assert tiny in text
    (tmp_path / "clients" / "mixed_copy.py").write_text(text.replace(
        tiny, "TINY = dict(lengths_s=[0.2, 0.3, 0.4, 0.5],"))
    shutil.copy(f"{check.LIMITS_DIR}/batch_mixed.json",
                tmp_path / "limits" / "mixed_copy.json")
    monkeypatch.setattr(drive, "CLIENTS_DIR", str(tmp_path / "clients"))
    monkeypatch.setattr(check, "LIMITS_DIR", str(tmp_path / "limits"))
    real = harness.traffic_of
    monkeypatch.setattr(harness, "traffic_of",
                        lambda w: dict(real(w), client="mixed_copy"))
    assert len(_tiny(mixed_cell)["lengths_s"]) == 4
    out, _ = _run(mixed_cell, seed=2 ** 31 + 19)
    assert out["correct"] is True and out["attempted"] == 4


def test_a_window_shorter_than_a_round_reaches_the_sampled_round(
        mixed_cell):
    """The mixed client with its sample in the second round (seed
    2 ** 31 + 5 draws round 1 of 2) and a window that ends within the
    first: the window runs on through the sampled round, and the run is
    correct."""
    code, line, lines = run.run_cell(
        mixed_cell, 2 ** 31 + 5, 0.0, False, on_card=False,
        traffic_override=dict(_tiny(mixed_cell), sample_span=2))
    assert code == 0, lines
    out = json.loads(line)
    assert out["correct"] is True and out["attempted"] == 6


@pytest.mark.parametrize("cell", ["dhgr_batch32_10s", "dhgr_solo_10s",
                                  MIXED])
def test_source_size_is_the_configurations(cell, monkeypatch, request):
    """Each client makes its frames at the configuration's source size,
    and a run at another size is judged correct."""
    from benchmark.gen import clips as gen

    real_cfg, real_synth = harness.config_of, gen.synth_movies_device
    sizes = set()

    def config_of(man, w):
        return dict(real_cfg(man, w), source_height=96, source_width=200)

    def synth(*a, **k):
        out = real_synth(*a, **k)
        sizes.add(tuple(out.shape[2:4]))
        return out

    _use(cell, request)
    monkeypatch.setattr(harness, "config_of", config_of)
    monkeypatch.setattr(gen, "synth_movies_device", synth)
    out, _ = _run(cell, seed=2 ** 31 + 23)
    assert out["correct"] is True
    assert sizes == {(96, 200)}


@pytest.mark.parametrize("cell", ["dhgr_batch32_10s", "dhgr_solo_10s",
                                  MIXED])
def test_control_is_not_correct(cell, request):
    _use(cell, request)
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


def _fault_half_batch_mixed(monkeypatch):
    """The second half of each mixed batch left out: its movies get the
    first half's padded targets."""
    from iivision_tpu_torch import encoder

    real = encoder.prepare_targets

    def prepare(*a, **k):
        lanes, by = real(*a, **k)
        h = (lanes.shape[0] + 1) // 2
        idx = torch.arange(lanes.shape[0]) % h
        return lanes[idx], by[idx]

    monkeypatch.setattr(encoder, "prepare_targets", prepare)


def _fault_not_cut(monkeypatch):
    """Each stream of a mixed batch left at the batch's longest, not cut
    to its own clip's ops."""
    from iivision_tpu_torch.parallel import mesh

    real = mesh.encode_movies_mixed

    def mixed(dist, movies, *a, **k):
        nf = max(m[2] for m in movies)
        nt = max(m[3] for m in movies)
        return real(dist, [(m[0], m[1], nf, nt) for m in movies], *a, **k)

    monkeypatch.setattr(mesh, "encode_movies_mixed", mixed)


def _fault_swapped(monkeypatch):
    """The streams of a mixed batch's first two clips swapped."""
    from iivision_tpu_torch.parallel import mesh

    real = mesh.encode_movies_mixed

    def mixed(*a, **k):
        flats, plan, n_ops = real(*a, **k)
        flats[0], flats[1] = flats[1], flats[0]
        return flats, plan, n_ops

    monkeypatch.setattr(mesh, "encode_movies_mixed", mixed)


# the faults that only one client's timed path can have
CLIENT_FAULTS = {
    "batch_pipelined": (_fault_half_batch,),
    "batch_mixed": (_fault_half_batch_mixed, _fault_not_cut, _fault_swapped),
}
FAULTS = [(c, f) for c in RUN_CELLS for f in (
    (_fault_state_unchanged, _fault_answer_altered) + CLIENT_FAULTS.get(
        "batch_mixed" if c == MIXED else _client(c), ()))]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch, request):
    _use(cell, request)
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



@pytest.mark.card
def test_mixed_short_run_on_card(card, mixed_cell):
    """The mixed client on the card, clips of 5 to 40 s in one batch: the
    window runs on through its sampled round and the run is correct."""
    code, line, lines = run.run_cell(
        mixed_cell, 2 ** 31 + 25, 3.0, False,
        traffic_override=dict(lengths_s=[5.0, 10.0, 20.0, 40.0],
                              pattern_seconds=10))
    assert code == 0, lines
    out = json.loads(line)
    assert out["correct"] is True and out["attempted"] >= 4
    assert out["device"]["platform"] == "gpu"
