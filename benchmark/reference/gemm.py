"""Plain reference of C = C0 + A @ B: float64 products of the regenerated
operands, ``ROWS`` rows of C at a time.

The two numbers (worst over C's tiles):

* ``c_rms_gap``: the Frobenius norm of a tile's gap over the reference
  tile's;
* ``c_max_gap``: the widest single gap over the reference tile's root
  mean square.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from benchmark import operands
from benchmark.reference import no_tf32, round_fp8, worse

Tiles = Dict[Tuple[int, int], torch.Tensor]

#: the numbers ``check`` and ``control`` give
NUMBERS = ("c_rms_gap", "c_max_gap")


def _operands(config: dict, seed: int, device, tile: int):
    m, n, k = (int(config[x]) for x in ("m", "n", "k"))
    ab = getattr(torch, config["ab_type"])
    c = getattr(torch, config["c_type"])
    return (operands.gaussian_matrix(m, k, ab, seed, operands.STREAM_A,
                                     device, tile),
            operands.gaussian_matrix(k, n, ab, seed, operands.STREAM_B,
                                     device, tile),
            operands.gaussian_matrix(m, n, c, seed, operands.STREAM_C,
                                     device, tile))


#: rows of C worked out at a time (divides every tile the cells use)
ROWS = 1024


def _compare(mb: int, rows: int, got: Callable[[slice, slice], torch.Tensor],
             ref_rows: Callable[[slice], torch.Tensor]) -> Dict[str, float]:
    """Gaps of ``got(rows, cols)`` from the reference, ``ROWS`` rows of C at
    a time (``ref_rows(rows)``, float64), summed up tile by tile."""
    step = min(ROWS, mb)
    acc: Dict[Tuple[int, int], list] = {}
    for r0 in range(0, rows, step):
        r = slice(r0, r0 + step)
        ref = ref_rows(r)
        for j in range(ref.shape[1] // mb):
            c = slice(j * mb, (j + 1) * mb)
            d = got(r, c).double() - ref[:, c]
            a = acc.setdefault((r0 // mb, j), [0.0, 0.0, 0.0])
            a[0] += float(d.square().sum())
            a[1] += float(ref[:, c].square().sum())
            a[2] = worse(a[2], float(d.abs().max()))
    rms_gap = max_gap = 0.0
    for dd, rr, mx in acc.values():
        rms_gap = worse(rms_gap, (dd / rr) ** 0.5)
        max_gap = worse(max_gap, mx / (rr / (mb * mb)) ** 0.5)
    return {"c_rms_gap": rms_gap, "c_max_gap": max_gap}


def check(config: dict, traffic: dict, seed: int, devices: List,
          outputs: Tiles) -> Dict[str, float]:
    """On the first of ``devices``."""
    no_tf32()
    mb = int(traffic["tile"])
    A, B, C0 = _operands(config, seed, devices[0], mb)
    B = B.double()

    def got(r: slice, c: slice) -> torch.Tensor:
        i, off = divmod(r.start, mb)
        return outputs[(i, c.start // mb)][off:off + r.stop - r.start]

    return _compare(mb, A.shape[0], got,
                    lambda r: C0[r].double() + A[r].double() @ B)


def control(config: dict, traffic: dict, seed: int, devices: List
            ) -> Dict[str, float]:
    """A and B through fp8 storage (one scale a matrix) in the program's
    place, against the reference, on the first of ``devices``."""
    no_tf32()
    mb = int(traffic["tile"])
    A, B, C0 = _operands(config, seed, devices[0], mb)
    A8, B8 = round_fp8(A), round_fp8(B).double()
    B = B.double()
    low = {}

    def ref_rows(r: slice) -> torch.Tensor:
        low["rows"] = C0[r].double() + A8[r].double() @ B8
        return C0[r].double() + A[r].double() @ B

    return _compare(mb, A.shape[0], lambda r, c: low["rows"][:, c],
                    ref_rows)
