"""The cards a cell runs on: exactly as many as it asks for.

A run attaches one device module a card it can see, so before anything
initialises CUDA the run narrows what CUDA shows the process to the first
``chips`` cards it would otherwise see (``narrow``).  On a host with more
cards a one-chip cell then runs exactly as on a host with one.  Every
per-card reading names its card by the index the process sees (0 up to
``chips`` - 1), and ``nvidia-smi`` reads the same card by its UUID.
"""

from __future__ import annotations

import os
from typing import List, MutableMapping, Optional

ENV = "CUDA_VISIBLE_DEVICES"


def visible(chips: int, value: Optional[str]) -> str:
    """The value of ``CUDA_VISIBLE_DEVICES`` that shows the first ``chips``
    of the cards ``value`` (the variable as it is set, or None) shows."""
    if chips < 1:
        raise ValueError(f"a cell needs 1 card or more, not {chips}")
    if value is None:
        return ",".join(str(i) for i in range(chips))
    return ",".join([v.strip() for v in value.split(",")][:chips])


def narrow(chips: int, environ: MutableMapping[str, str] = os.environ
           ) -> str:
    """Show this process only the first ``chips`` cards it can see; call
    before anything initialises CUDA.  Returns the value set."""
    environ[ENV] = visible(chips, environ.get(ENV))
    return environ[ENV]


def smi_ids(count: int) -> List[str]:
    """``nvidia-smi -i`` names of the process's cards 0 to ``count`` - 1:
    their UUIDs, which ``nvidia-smi`` reads whatever ``CUDA_VISIBLE_DEVICES``
    says (its own indices ignore it), else the index."""
    import torch
    out = []
    for i in range(count):
        uuid = getattr(torch.cuda.get_device_properties(i), "uuid", None)
        out.append(f"GPU-{uuid}" if uuid is not None else str(i))
    return out
