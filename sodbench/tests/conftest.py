"""Tests of the benchmark harness.  Run from the checkout's root:

    python -m pytest sodbench/tests -q

Tests marked ``card`` need an NVIDIA card and skip without one; whether
there is one is decided inside the ``card`` fixture, never at import."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100 only")
    return torch.device("cuda")
