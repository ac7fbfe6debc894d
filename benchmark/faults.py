"""Faults planted in the timed path, for the readings that correctness
limits are set from (``benchmark.calibrate``) and for the tests: K1
(``gemm_tile`` and ``gemm_tile_grouped`` as the apps call them) made to
do the wrong thing.  The benchmark's own runs never plant one.

* ``unchanged``: every call returns C as it was;
* ``half``: every other call does (half the updates left out);
* ``altered``: one entry of every seventh call's result is moved by the
  largest magnitude in that result (a fixed amount such as 1.0 is under
  the rounding of a long GEMM chain's entries, whose size grows with k).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterator, Tuple

KINDS = ("unchanged", "half", "altered")

#: the apps whose K1 calls are replaced
APPS = ("parsec_tpu_torch.apps.gemm", "parsec_tpu_torch.apps.potrf")


def faulty(kind: str, real: Callable) -> Tuple[Callable, Callable]:
    """(single, grouped) K1 with the fault ``kind``, over ``real``."""
    if kind not in KINDS:
        raise ValueError(f"no fault {kind!r}; faults are {KINDS}")
    calls = [0]

    def tile(A, B, C, alpha=1.0, trans_b=False, out=None):
        calls[0] += 1
        if kind == "unchanged" or (kind == "half" and calls[0] % 2):
            return C if out is None else out.copy_(C)
        O = real(A, B, C, alpha, trans_b, out=out)
        if kind == "altered" and calls[0] % 7 == 1:
            O.view(-1)[0] += O.abs().max()
        return O

    def grouped(As, Bs, Cs, alpha=1.0, trans_b=False, out=None):
        outs = [None] * len(Cs) if out is None else list(out)
        return [tile(a, b, c, alpha, trans_b, out=o)
                for a, b, c, o in zip(As, Bs, Cs, outs)]
    return tile, grouped


@contextmanager
def planted(kind: str) -> Iterator[None]:
    """K1 with the fault ``kind`` in every app while the block runs."""
    import importlib
    saved = []
    for name in APPS:
        mod = importlib.import_module(name)
        saved.append((mod, mod.gemm_tile, mod.gemm_tile_grouped))
        mod.gemm_tile, mod.gemm_tile_grouped = faulty(kind, mod.gemm_tile)
    try:
        yield
    finally:
        for mod, tile, grouped in saved:
            mod.gemm_tile, mod.gemm_tile_grouped = tile, grouped
