"""Settings of the benchmark's own tests (run them from the root of the
checkout: ``python -m pytest benchmark/tests -q``; on a card, the ones
marked ``cuda`` too: ``python -m pytest benchmark/tests -m cuda -q``).

The ``cuda`` marker is for tests that need a CUDA device; the ``card``
fixture decides at run time whether there is one and skips otherwise."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The card's device name; skips the test where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda:0"
