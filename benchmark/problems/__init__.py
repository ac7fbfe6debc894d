"""Drivers of the program, one module per problem (``config["problem"]``).

Each module has a ``Problem(config, traffic, seed, device)`` with:
``flops_per_pass``; ``tasks_per_pass()`` and ``k1_tasks_per_pass()``
(tasks of each class); ``k1_work(cls)`` ((flops, bytes) of one task);
``place(devs)`` (operands made from the seed on the cell's device
modules, the list ``devs``: one a card, in card order); ``restore()``,
``make_pool()`` and ``pass_failed(tp)`` (one pass); ``outputs()`` (the
last pass's output tiles, on whichever card holds each) and
``release()``.  ``device`` is the first card's ``torch.device``.  The
program is imported inside the methods that drive it.

The cell's cards reach every side of a run alike: the problem gets the
list of device modules, the reference (``benchmark.reference``) the list
of their ``torch.device``s, in the harness, ``benchmark.calibrate`` and
``benchmark.spancheck``.  A problem or reference that uses one card takes
the first.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def newest(M, t: Tuple[int, int]) -> torch.Tensor:
    """The newest payload of tile ``t`` of the collection ``M``."""
    c = M.data_of(*t).newest_copy()
    if c is None or c.payload is None:
        raise RuntimeError(f"{M.name}{t}: no valid copy to read")
    return c.payload


def discard_device_copies(M, tiles: Iterable[Tuple[int, int]]) -> None:
    """Drop the device copies of ``M``'s tiles without writing them home:
    the data is the benchmark's, and the Context's exit would otherwise
    copy every dirty tile to the host (as the port's bench does)."""
    from parsec_tpu_torch.data.data import Coherency
    for t in tiles:
        d = M.data_of(*t)
        with d._lock:
            for sp, c in list(d.copies().items()):
                if sp != 0 and c.payload is not None:
                    d.detach_copy(sp)
                    c.payload = None
                    c.coherency = Coherency.INVALID


def outputs_of(M, tiles: Iterable[Tuple[int, int]]
               ) -> Dict[Tuple[int, int], torch.Tensor]:
    return {t: newest(M, t) for t in tiles}
