"""Tests of the benchmark.  They run on the CPU at tiny sizes; a test that
needs the card carries the ``card`` marker and asks for the ``card``
fixture, which skips it where no CUDA card is visible.  On the card:
``python -m pytest benchmark/tests -m card``."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where none is visible)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")
