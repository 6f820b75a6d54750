"""pytest settings of the benchmark's own tests (`python -m pytest
stereobench/tests -q`).  Tests that need a CUDA card carry the `card`
marker and take the `card` fixture, which skips them here; whether there
is a card is decided inside the fixture, never while a module is
imported.  On the card: `python -m pytest stereobench/tests -m card`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
