"""Tests of the benchmark (benchgpu/), on the CPU at toy sizes; a test that
needs the CUDA card carries the `card` marker and skips without one.

    python -m pytest benchgpu/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
