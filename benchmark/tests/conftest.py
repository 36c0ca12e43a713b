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
