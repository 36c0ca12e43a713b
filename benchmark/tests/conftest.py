"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
repository's root.  Cases that need a card carry the `card` marker and
take the `card` fixture, which skips them without one; run them on a
card with `python -m pytest benchmark/tests -q -m card`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


@pytest.fixture
def mixed_cell(monkeypatch):
    """A cell of the tests alone on the `batch_mixed` client (clips of
    different lengths in one batch) at that client's tiny sizes, added to
    the manifest that the harness reads: its name."""
    from benchmark import drive, harness

    man = harness.manifest()
    man["workloads"].append(dict(name="t_mixed", config="dhgr_ntsc_k16_j4",
                                 traffic="t_mixed", chips=1, why="tests"))
    tr = dict(client="batch_mixed", ingest="host",
              **drive.client("batch_mixed").TINY)
    real = harness.traffic_of
    monkeypatch.setattr(harness, "manifest", lambda *a, **k: man)
    monkeypatch.setattr(harness, "traffic_of", lambda w: dict(tr)
                        if w["traffic"] == "t_mixed" else real(w))
    return "t_mixed"
