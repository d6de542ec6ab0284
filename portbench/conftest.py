"""pytest settings of the benchmark's own tests (portbench/tests/)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skips the test where this machine has no CUDA device (decided when
    the test runs, never when a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card, python -m pytest "
                    "portbench/tests -m card --confcutdir=portbench")
