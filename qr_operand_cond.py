"""Condition numbers of ``chip_smoke.py``'s two QR operands, on the CPU.

    python3 qr_operand_cond.py               # (mb, nt) = (192, 8), (768, 8)
    python3 qr_operand_cond.py MB NT [MB NT ...]

Each operand is built tile by tile as ``chip_smoke.py`` builds it
(``qr_tile_maker``: bf16 tile storage, per-tile seeded generators, here on
the CPU), widened to float64, and its singular values taken with
``torch.linalg.svdvals``.  The least-squares ladder (corrected
semi-normal equations on a bf16-storage R) contracts only while
cond^2 * eps_bf16 < 1; the script prints cond and that product for the
geqrf bench operand (0.05 * N(0, 1) + I in every tile) and for the
conditioned operand (I + (0.25 / sqrt(n)) * N(0, 1)).
"""

from __future__ import annotations

import sys
import time

import torch

from chip_smoke import SEED, qr_tile_maker
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

EPS_BF16 = torch.finfo(torch.bfloat16).eps


def operand_cond(mb: int, nt: int, conditioned: bool) -> float:
    """sigma_max / sigma_min of the operand at n = mb * nt, as bf16 tiles
    widened to float64."""
    n = mb * nt
    A = TwoDimBlockCyclic(mb, mb, n, n, dtype=torch.bfloat16, name="A")
    tile = qr_tile_maker(A, torch.device("cpu"),
                         SEED + (4 if conditioned else 3), conditioned)
    full = torch.empty((n, n), dtype=torch.float64)
    for m, k in A.local_tiles():
        full[m * mb:(m + 1) * mb, k * mb:(k + 1) * mb] = tile(m, k)
    s = torch.linalg.svdvals(full)
    return float(s[0] / s[-1])


def main(argv) -> int:
    nums = [int(a) for a in argv] or [192, 8, 768, 8]
    for mb, nt in zip(nums[::2], nums[1::2]):
        for conditioned in (False, True):
            t0 = time.perf_counter()
            cond = operand_cond(mb, nt, conditioned)
            name = "conditioned" if conditioned else "bench"
            print(f"n={mb * nt} (mb={mb}, nt={nt}) {name} operand: cond "
                  f"{cond:.4e}, cond^2 * eps_bf16 {cond ** 2 * EPS_BF16:.4e}"
                  f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
