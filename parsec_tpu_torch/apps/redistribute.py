"""Redistribution: move a tiled matrix between two distributions.

Rebuild of the reference's generic redistribution (reference:
parsec/data_dist/matrix/redistribute/redistribute_dtd.c — a DTD-driven
copy of every tile from a source collection/distribution to a target
one; tests/collections/redistribute).  Same tile grid, arbitrary rank
mappings: a reader task at each source owner ships the tile through a
dataflow edge to a writer task at the target owner.  Host bodies.
"""

from __future__ import annotations

from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.api import DATA, IN, OUT, PTG, Range, TASK


def redistribute_taskpool(S: TiledMatrix,
                          T: TiledMatrix) -> ParameterizedTaskpool:
    """Copy S into T (matching tile grids, any rank mappings)."""
    if (S.mt, S.nt) != (T.mt, T.nt) or (S.mb, S.nb) != (T.mb, T.nb):
        raise ValueError("redistribute requires matching tile grids")
    p = PTG("redistribute", MT=S.mt, NT=S.nt)
    p.task("R", m=Range(0, S.mt - 1), n=Range(0, S.nt - 1)) \
        .affinity(lambda m, n, S=S: S(m, n)) \
        .flow("X", "READ",
              IN(DATA(lambda m, n, S=S: S(m, n))),
              OUT(TASK("W", "X", lambda m, n: dict(m=m, n=n)))) \
        .body(lambda: None)
    p.task("W", m=Range(0, S.mt - 1), n=Range(0, S.nt - 1)) \
        .affinity(lambda m, n, T=T: T(m, n)) \
        .flow("X", "READ", IN(TASK("R", "X", lambda m, n: dict(m=m, n=n)))) \
        .flow("O", "RW",
              IN(DATA(lambda m, n, T=T: T(m, n))),
              OUT(DATA(lambda m, n, T=T: T(m, n)))) \
        .body(lambda X: {"O": X})
    return p.build()
