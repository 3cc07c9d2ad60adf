"""The benchmark's CPU tests: the harness and the port on the host at
small sizes. Run from the root of the checkout:

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need the card and skip where there is none."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
