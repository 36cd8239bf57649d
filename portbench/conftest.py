"""pytest settings of the benchmark's own tests (portbench/tests): the
`card` marker, for tests that need the CUDA card and skip without one,
and the import paths of the harness (pb) and of the program."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
for p in (BENCH_DIR, BENCH_DIR.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card (run on the card with "
        "`python -m pytest portbench/tests -m card`); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")
