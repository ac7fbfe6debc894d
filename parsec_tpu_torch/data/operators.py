"""Map / apply / reduce operator taskpools over tiled matrices.

Rebuild of the reference's collection operators
(reference: parsec/data_dist/matrix/map_operator.c, apply_wrapper.c,
reduce_wrapper.c): generic taskpools applying a user operator to every
tile, mapping one collection onto another, and reducing all tiles through
a binary combination tree.  Built on the PTG front-end, so they inherit
owner-computes placement and run on any scheduler/device.  The operators
are CPU bodies: tiles reach them as CPU tensors.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg import DATA, IN, NEW, OUT, PTG, Range, TASK


def apply_op(A: TiledMatrix, op: Callable[[torch.Tensor, int, int], Any],
             name: str = "apply") -> ParameterizedTaskpool:
    """In-place ``op(tile, m, n)`` on every stored tile
    (reference: parsec_apply / apply_wrapper.c)."""
    g = PTG(name)
    g.task("APPLY", m=Range(0, A.mt - 1), n=Range(0, A.nt - 1)) \
     .affinity(lambda m, n: A(m, n)) \
     .flow("T", "RW",
           IN(DATA(lambda m, n: A(m, n))),
           OUT(DATA(lambda m, n: A(m, n)))) \
     .body(lambda T, m, n: (op(T, m, n), None)[1])
    tp = g.build()
    if hasattr(A, "tile_exists"):
        tc = tp.task_classes["APPLY"]
        orig = tc.iter_space

        def filtered(globals_):
            for loc in orig(globals_):
                if A.tile_exists(loc["m"], loc["n"]):
                    yield loc
        tc.iter_space = filtered
    return tp


def map_op(A: TiledMatrix, B: TiledMatrix,
           op: Callable[[torch.Tensor, torch.Tensor, int, int], Any],
           name: str = "map") -> ParameterizedTaskpool:
    """``op(a_tile, b_tile, m, n)`` reading A, writing B
    (reference: map_operator.c).  A and B must be tiled identically."""
    if (A.mt, A.nt) != (B.mt, B.nt):
        raise ValueError("map_op requires identical tilings")
    g = PTG(name)
    g.task("MAP", m=Range(0, A.mt - 1), n=Range(0, A.nt - 1)) \
     .affinity(lambda m, n: B(m, n)) \
     .flow("X", "READ", IN(DATA(lambda m, n: A(m, n)))) \
     .flow("Y", "RW",
           IN(DATA(lambda m, n: B(m, n))),
           OUT(DATA(lambda m, n: B(m, n)))) \
     .body(lambda X, Y, m, n: (op(X, Y, m, n), None)[1])
    return g.build()


def reduce_op(A: TiledMatrix,
              op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
              result: Optional[Dict[str, Any]] = None,
              name: str = "reduce"):
    """Binary-tree reduction of all tiles with ``op(acc, tile) -> acc``
    (reference: reduce_wrapper.c binary reduction col/row).

    Returns (taskpool, result_holder); after the pool completes,
    ``result_holder["value"]`` is the tile-shaped reduction of all tiles.
    Requires uniform tile shapes (lm % mb == 0 and ln % nb == 0).
    """
    if A.lm % A.mb or A.ln % A.nb:
        raise ValueError("reduce_op requires uniform (full) tiles")
    tiles = [(m, n) for m in range(A.mt) for n in range(A.nt)]
    T = len(tiles)
    holder = result if result is not None else {}
    if T == 0:
        holder["value"] = None
        return PTG(name).build(), holder
    L = max(1, math.ceil(math.log2(T))) if T > 1 else 1
    counts = {0: T}
    for lvl in range(1, L + 1):
        counts[lvl] = -(-counts[lvl - 1] // 2)

    def child_exists(l, i):
        return 2 * i + 1 < counts[l - 1]

    def tile_ref(i):
        return A(*tiles[i])

    g = PTG(name, L=L)
    tb = g.task("RED", l=Range(1, L),
                i=Range(0, lambda l: counts[l] - 1))
    # keep the whole tree on tile 0's rank — reductions are latency-bound;
    # smarter placement lands with the comm layer
    tb.affinity(lambda l, i: A(*tiles[0]))
    tb.flow("X", "READ",
            IN(DATA(lambda i: tile_ref(2 * i)), when=lambda l: l == 1),
            IN(TASK("RED", "P", lambda l, i: dict(l=l - 1, i=2 * i)),
               when=lambda l: l > 1))
    tb.flow("Y", "READ",
            IN(DATA(lambda i: tile_ref(2 * i + 1)),
               when=lambda l, i: l == 1 and child_exists(1, i)),
            IN(TASK("RED", "P", lambda l, i: dict(l=l - 1, i=2 * i + 1)),
               when=lambda l, i: l > 1 and child_exists(l, i)))
    tb.flow("P", "WRITE",
            IN(NEW("acc")),
            OUT(TASK("RED", "X", lambda l, i: dict(l=l + 1, i=i // 2)),
                when=lambda l, i, L=L: l < L and i % 2 == 0),
            OUT(TASK("RED", "Y", lambda l, i: dict(l=l + 1, i=i // 2)),
                when=lambda l, i, L=L: l < L and i % 2 == 1))

    def body(X, Y, P, l, i, L=L):
        acc = X.clone() if Y is None else op(X, Y)
        P.copy_(acc)
        if l == L:
            holder["value"] = P.clone()

    tb.body(body)
    g.arena("acc", (A.mb, A.nb), A.dtype)
    return g.build(), holder
