"""Test settings of the benchmark's own tests (`python -m pytest
portbench/tests`).  Tests that need a CUDA card carry the `card` marker
and take the `card` fixture, which skips them where there is none; the
rest run on the CPU at small sizes."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
