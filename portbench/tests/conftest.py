"""The benchmark's tests import the harness from the checkout's root; the
``gpu`` marker is for tests that need a CUDA device (decided in the
``cuda`` fixture, never while a module is imported)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the benchmark at the cells' "
        "own sizes); skipped without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
