"""Settings of the benchmark's own tests (``python -m pytest
perfbench/tests``): the ``card`` marker, and the ``card`` fixture that
decides inside a test whether a CUDA device exists."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    return torch.device("cuda", 0)
