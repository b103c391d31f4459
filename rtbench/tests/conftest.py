"""Fixtures of the benchmark's tests."""
import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import rtbench_helpers  # noqa: E402,F401  (puts the benchmark on sys.path)


def pytest_configure(config):
    """Under several test workers, each gets its share of the cores: the
    reference and the program make many small operations, which threads
    beyond that share only slow."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's card path")
    return torch.device("cuda")
