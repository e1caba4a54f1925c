"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that run on the card and skip elsewhere.

    python -m pytest port_bench/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with CUDA; skips with a reason where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the correctness control is read on the card")
    return torch.device("cuda")
