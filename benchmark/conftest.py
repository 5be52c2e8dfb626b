"""pytest settings of the benchmark's own tests (python -m pytest benchmark/tests).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where torch sees no card: the decision is made
when the test runs, never when a module is imported."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
