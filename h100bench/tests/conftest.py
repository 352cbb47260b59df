"""CPU tests of the benchmark (h100bench/). Run from the repository's root:

    python -m pytest h100bench/tests -q

Tests marked `card` need an NVIDIA card and skip without one; run them on
the card with the same command there.
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))
sys.path.insert(2, str(HERE.parents[1]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (CUDA); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda", 0)
