"""The benchmark's tests: on the CPU at tiny sizes, from the repository's
root: ``python -m pytest benchmark/tests -q``.  Tests marked ``cuda``
need a card and skip without one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the kernels have no CPU mode)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never while a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())
