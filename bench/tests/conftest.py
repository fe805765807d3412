"""The benchmark's own tests (``python -m pytest -q bench/tests`` from the
repository root).  Tests that need the card carry the ``chip`` marker and
skip, with a reason, where no CUDA device is visible; the look happens in
the ``card`` fixture, at run time, never while a module is imported."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")
