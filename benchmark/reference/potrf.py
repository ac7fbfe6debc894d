"""Plain reference of the tiled Cholesky, in the configuration's stated
precision.

The configuration states the arithmetic: tiles stored in bf16, each
task's result rounded once to the tile's type, products accumulated in f32,
the diagonal factor in f32 and the panel solved against that f32 factor.
This reference computes the same right-looking factorization from the same
operand, tile by tile in that precision, but with plain PyTorch calls: the
f32 Cholesky of the symmetrized diagonal tile, a triangular solve for the
panel (not the program's product with an inverse), f32 products for the
trailing update.  So a sound program differs from it only where two f32
sums in another order round to different bf16 neighbours.

Over several cards the reference keeps row m of tiles on card m mod the
number of cards: each card updates its own rows, the panel is solved on
its diagonal tile's card and sent to the others.  Every tile sees the same
operations on any card, so the numbers do not depend on the cards.

The two numbers (worst over tiles, off-diagonal entries against the tile's
root mean square, diagonal entries against themselves):

* ``l_rms_gap``: the root mean square gap of a tile;
* ``l_max_gap``: the widest single gap.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from benchmark import operands
from benchmark.reference import no_tf32, round_fp8, worse

Tiles = Dict[Tuple[int, int], torch.Tensor]

#: the numbers ``check`` and ``control`` give
NUMBERS = ("l_rms_gap", "l_max_gap")


def factor(tiles: Tiles, nt: int, store: Callable[[torch.Tensor],
                                                  torch.Tensor]) -> Tiles:
    """Right-looking tiled Cholesky of the lower ``tiles`` (replaced in the
    dict by the factor's tiles); ``store`` rounds an f32 result to the
    storage precision.  Each row of tiles stays on the device of its
    diagonal tile."""
    no_tf32()
    A = tiles
    mb = A[(0, 0)].shape[0]
    for k in range(nt):
        T = A[(k, k)].float()
        L = torch.linalg.cholesky((T + T.mT) / 2)
        A[(k, k)] = store(L)
        if k == nt - 1:
            break
        home = L.device
        below = range(k + 1, nt)
        P = torch.cat([A[(m, k)].to(home).float() for m in below], dim=0)
        P = torch.linalg.solve_triangular(L.mT, P, upper=True, left=False)
        for i, m in enumerate(below):
            A[(m, k)] = store(P[i * mb:(i + 1) * mb])
        del P
        Q = torch.cat([A[(m, k)].float() for m in below], dim=0)
        for m in below:
            A[(m, k)] = A[(m, k)].to(A[(m, m)].device)
        sent = {home: Q}
        for i, m in enumerate(below):
            here = A[(m, m)].device
            if here not in sent:
                sent[here] = Q.to(here)
            Qh = sent[here]
            rows = torch.cat([A[(m, j)].float() for j in range(k + 1, m + 1)],
                             dim=1)
            rows -= Qh[i * mb:(i + 1) * mb] @ Qh[:(i + 1) * mb].mT
            for jj, j in enumerate(range(k + 1, m + 1)):
                A[(m, j)] = store(rows[:, jj * mb:(jj + 1) * mb])
        del Q, Qh, sent
    return A


def compare(got: Tiles, ref: Tiles) -> Dict[str, float]:
    """The gaps of ``got`` from ``ref``, tile by tile."""
    rms_gap = max_gap = 0.0
    for t, r in ref.items():
        r = r.float()
        d = got[t].to(r.device).float() - r
        n = d.numel()
        if t[0] == t[1]:
            dd = d.diagonal()
            max_gap = worse(max_gap, float((dd.abs() / r.diagonal().abs())
                                           .max()))
            d = d - torch.diag(dd)
            n -= dd.numel()
            strict = torch.tril(r, -1)
            scale = float(strict.norm()) / (n / 2) ** 0.5
        else:
            scale = float(r.norm()) / n ** 0.5
        rms_gap = worse(rms_gap, float(d.norm()) / n ** 0.5 / scale)
        max_gap = worse(max_gap, float(d.abs().max()) / scale)
    return {"l_rms_gap": rms_gap, "l_max_gap": max_gap}


def _setup(config: dict, traffic: dict, seed: int, devices: List):
    """The operand's lower tiles, row m on ``devices[m % len(devices)]``."""
    n, mb = int(config["n"]), int(traffic["tile"])
    nt = n // mb
    dtype = getattr(torch, config["storage"])
    homes = None if len(devices) == 1 else \
        {(m, k): devices[m % len(devices)]
         for m in range(nt) for k in range(m + 1)}
    tiles = operands.spd_lower_tiles(n, mb, dtype, seed, devices[0],
                                     float(config["diagonal"]), homes)
    return tiles, nt, dtype


def reference(config: dict, traffic: dict, seed: int, devices: List
              ) -> Tiles:
    tiles, nt, dtype = _setup(config, traffic, seed, devices)
    return factor(tiles, nt, lambda x: x.to(dtype))


def check(config: dict, traffic: dict, seed: int, devices: List,
          outputs: Tiles) -> Dict[str, float]:
    return compare(outputs, reference(config, traffic, seed, devices))


def control(config: dict, traffic: dict, seed: int, devices: List
            ) -> Dict[str, float]:
    """The reference with fp8 storage (one scale a tile) in the program's
    place, against the reference.  fp8 values with a power-of-two scale are
    bf16 values, so the control's tiles are held in the storage type."""
    ref = reference(config, traffic, seed, devices)
    tiles, nt, dtype = _setup(config, traffic, seed, devices)

    def store(x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x).to(dtype)
    for t, x in tiles.items():
        tiles[t] = store(x)
    return compare(factor(tiles, nt, store), ref)
