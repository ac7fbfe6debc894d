"""Seeded operands, made on the device in row panels.

Each matrix comes from its own ``torch.Generator`` seeded from the run's
seed and the matrix's stream number, and is drawn panel by panel in a
fixed order: ``panel_rows(tile)`` rows a call, which is ``PANEL_ROWS`` for
every tile that is a multiple of it, so two cells of one configuration at
different full-size tiles factor or multiply the same matrix.  The
reference calls the same functions again with the cell's tile; nothing
here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch

#: rows drawn per generator call at every tile that is a multiple of it
PANEL_ROWS = 1024

#: stream numbers of the matrices drawn from one seed
STREAM_SPD, STREAM_A, STREAM_B, STREAM_C = 0, 1, 2, 3

Tiles = Dict[Tuple[int, int], torch.Tensor]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of matrix ``stream`` under ``seed`` (any whole number
    from 0 up; distinct (seed, stream) pairs get distinct seeds)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + stream) % (1 << 63))
    return g


def panel_rows(tile: int) -> int:
    """Rows drawn per generator call for a cell of ``tile``: they divide the
    tile, and so every size the tile divides."""
    return math.gcd(PANEL_ROWS, int(tile))


def _check_tile(size: int, tile: int) -> None:
    if size % tile:
        raise ValueError(f"tile {tile} does not divide {size}")


def gaussian_panels(rows: int, cols: int, seed: int, stream: int, device,
                    tile: int) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first row, f32 N(0, 1) panel) of a rows x cols matrix, in order."""
    _check_tile(rows, tile)
    panel = panel_rows(tile)
    g = generator(seed, stream, device)
    for r0 in range(0, rows, panel):
        yield r0, torch.randn((panel, cols), generator=g, device=device)


def gaussian_tiles(rows: int, cols: int, mb: int, dtype: torch.dtype,
                   seed: int, stream: int, device) -> Tiles:
    """The rows x cols N(0, 1) matrix of ``stream`` as (mb, mb) tiles in
    ``dtype`` (one rounding from f32)."""
    tiles = {(m, n): torch.empty((mb, mb), dtype=dtype, device=device)
             for m in range(rows // mb) for n in range(cols // mb)}
    for r0, P in gaussian_panels(rows, cols, seed, stream, device, mb):
        m, off = divmod(r0, mb)
        for n in range(cols // mb):
            tiles[(m, n)][off:off + P.shape[0]].copy_(
                P[:, n * mb:(n + 1) * mb])
    return tiles


def gaussian_matrix(rows: int, cols: int, dtype: torch.dtype, seed: int,
                    stream: int, device, tile: int) -> torch.Tensor:
    """The same matrix as ``gaussian_tiles`` at ``tile``, whole."""
    out = torch.empty((rows, cols), dtype=dtype, device=device)
    for r0, P in gaussian_panels(rows, cols, seed, stream, device, tile):
        out[r0:r0 + P.shape[0]].copy_(P)
    return out


def spd_lower_tiles(n: int, mb: int, dtype: torch.dtype, seed: int, device,
                    diag: float,
                    homes: Optional[Dict[Tuple[int, int], object]] = None
                    ) -> Tiles:
    """The lower (mb, mb) tiles (m >= k) of a symmetric n x n operand:
    off-diagonal entries uniform in [-0.5, 0.5), ``diag`` added to the
    diagonal, stored in ``dtype``.  Row panel p draws the columns up to its
    own diagonal block; a diagonal tile takes its lower triangle and
    mirrors it, so the operand is symmetric bit for bit.  The panels are
    drawn on ``device``; each tile is kept there, or on the device
    ``homes`` names for it (the same values wherever a tile is kept)."""
    _check_tile(n, mb)
    panel = panel_rows(mb)
    nt = n // mb
    tiles = {(m, k): torch.zeros((mb, mb), dtype=dtype,
                                 device=device if homes is None
                                 else homes[(m, k)])
             for m in range(nt) for k in range(m + 1)}
    g = generator(seed, STREAM_SPD, device)
    for r0 in range(0, n, panel):
        width = r0 + panel
        P = torch.rand((panel, width), generator=g, device=device) - 0.5
        m, off = divmod(r0, mb)
        for k in range(m + 1):
            c0, c1 = k * mb, min((k + 1) * mb, width)
            tiles[(m, k)][off:off + panel, :c1 - c0].copy_(P[:, c0:c1])
    for k in range(nt):
        T = torch.tril(tiles[(k, k)].float())
        T = T + torch.tril(T, -1).mT
        T.diagonal().add_(float(diag))
        tiles[(k, k)].copy_(T)
    return tiles
