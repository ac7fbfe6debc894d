"""The run loads neither JAX nor the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot): ``parsec_tpu_torch`` begins with ``parsec_tpu`` but is not it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "parsec_tpu"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    if names is None:
        names = list(sys.modules)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
