"""Fixtures of the benchmark's tests."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import rtbench_helpers  # noqa: E402,F401  (puts the benchmark on sys.path)


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's card path")
    return torch.device("cuda")
