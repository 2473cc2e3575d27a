"""Tests of the benchmark's own code. Those marked `card` need a CUDA
device and skip without one; the rest run on the CPU at small sizes.

    python -m pytest portbench/tests -q            # CPU
    python3 -m pytest portbench/tests -q -m card   # on the card
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device; decided when it runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
