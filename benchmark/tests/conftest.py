"""The benchmark's tests: on the CPU at tiny sizes, from the repository's
root: ``python -m pytest benchmark/tests -q``.  Tests marked ``cuda``
need a card and skip without one.

The tests' own process sees one card, the first it would otherwise see,
as a one-chip cell's run does (``benchmark.cards``); a test of a cell of
several cards starts a process of its own with ``every_card_env``."""

import os

import pytest
import torch

from benchmark import cards

#: ``CUDA_VISIBLE_DEVICES`` as the test process found it (None: unset)
_FOUND = {}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the kernels have no CPU mode)")
    _FOUND.setdefault("visible", os.environ.get(cards.ENV))
    cards.narrow(1)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never while a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def every_card_env():
    """The environment of a process that sees every card the test process
    would have seen."""
    env = dict(os.environ)
    if _FOUND["visible"] is None:
        env.pop(cards.ENV, None)
    else:
        env[cards.ENV] = _FOUND["visible"]
    return env
