"""Recursive sub-tiling of a single tile.

Reference: parsec/data_dist/matrix/subtile.c — wraps one tile of a parent
collection as its own tiled matrix so hierarchical/recursive algorithms
(the recursive device, SURVEY.md §2.3) can run an inner taskpool on it.
The inner tiles are views of the parent's host tensor.
"""

from __future__ import annotations

from parsec_tpu_torch.data.data import ACCESS_RW, Data, to_host
from parsec_tpu_torch.data.matrix import TiledMatrix


class SubtileMatrix(TiledMatrix):
    """View one parent tile as an mb x nb tiled matrix (always rank-local).

    Construction claims the parent for host-side read-write: the newest
    copy is pulled home first (it may be device-resident) and other copies
    are invalidated, so the inner taskpool's in-place writes through the
    backing views cannot be shadowed by a stale device copy.  Call
    ``commit()`` when the inner taskpool completes to publish the inner
    tiles into the parent (the recursive-completion hook does this).
    """

    def __init__(self, parent_tile: Data, mb: int, nb: int, name: str = "sub"):
        copy = parent_tile.pull_to_host()
        if copy is None or copy.payload is None:
            raise ValueError("parent tile has no materialized copy")
        parent_tile.transfer_ownership(0, ACCESS_RW)
        a = to_host(copy.payload)
        super().__init__(mb, nb, a.shape[0], a.shape[1], dtype=a.dtype,
                         nodes=1, myrank=0, name=name)
        self.parent = parent_tile
        self.from_array(a)

    def commit(self) -> None:
        """Publish the inner writes: pull home the inner tiles whose
        newest copy an inner device pool left on its device (the JAX
        package bumps the version alone, which publishes host writes
        only), then bump the parent's host version."""
        self._sync_backing()
        self.parent.complete_write(0)

    def rank_of(self, m: int, n: int = 0) -> int:
        return 0
