"""The benchmark's own tests: ``python -m pytest benchmark/tests``.  Tests
that need a CUDA card carry the ``card`` marker and skip without one; run
them on the card with ``python -m pytest benchmark/tests -m card``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs the cell at its own size)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
