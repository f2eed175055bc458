"""Tests of the benchmark harness.  Run from the repository's root:

    python -m pytest benchmark/tests -q

CPU tests drive the harness at tiny sizes on the CPU.  Tests marked
`card` need a CUDA card and skip without one (decided in the `card`
fixture, never at import): on the card machine,

    python -m pytest benchmark/tests -q -m card
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
    return "cuda"


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
