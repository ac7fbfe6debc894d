"""Data-collection base: the owner-computes mapping vtable.

Rebuild of the reference's data distribution base
(reference: include/parsec/data_distribution.h:26-66, data_distribution.c):
a collection maps a global key to ``rank_of`` (which process owns it),
``vpid_of`` (which NUMA domain / local partition), and ``data_of`` (the
local Data handle).  Task affinity follows these answers — that is the
distributed "owner computes" parallelism of the runtime.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from parsec_tpu_torch.data.data import Data


class DataCollection:
    """Abstract collection (reference: parsec_data_collection_t)."""

    #: recovery re-mapping (core/recovery.py): {dead rank -> adopting
    #: survivor} for THIS collection's partition, or None.  A class
    #: default keeps ``owner_of`` at one attribute load + None check
    #: when no recovery is active; installed per collection so pools
    #: over untouched collections never see a re-mapped owner.
    _recovery_translate = None
    #: re-runnable source: ``fn(*indices) -> tensor`` regenerating a
    #: tile's INITIAL payload — the lineage walk's base version for
    #: tiles whose live copies died with their rank (the "re-runnable
    #: source task" of the recovery plane; see core/recovery.py).  A
    #: payload on a card lands there as the tile's device copy
    init_fn = None

    def __init__(self, nodes: int = 1, myrank: int = 0, name: str = "dc"):
        self.nodes = nodes
        self.myrank = myrank
        self.name = name
        self.dc_id = None        # registered id (taskpool serialization)

    # -- the vtable -------------------------------------------------------
    def data_key(self, *indices) -> Any:
        """Flatten index tuple to a canonical key."""
        raise NotImplementedError

    def rank_of(self, *indices) -> int:
        raise NotImplementedError

    def owner_of(self, *indices) -> int:
        """The rank currently SERVING these indices: ``rank_of`` routed
        through the recovery translation (a dead rank's partition is
        re-balanced onto survivors; core/recovery.py).  Runtime rank
        decisions — task placement, activation routing, local-tile
        materialization — go through here; ``rank_of`` stays the pure
        distribution function."""
        r = self.rank_of(*indices)
        t = self._recovery_translate
        return t.get(r, r) if t else r

    def set_init(self, fn) -> "DataCollection":
        """Register a re-runnable tile source: ``fn(*indices)`` returns
        the INITIAL payload of a tile.  Recovery reconstructs a dead
        rank's lost tiles from it when no snapshot survives."""
        self.init_fn = fn
        return self

    def set_rank_translation(self, table: Optional[Dict[int, int]]) -> None:
        """Install (or clear, with None/{}) the recovery re-mapping for
        this collection.  Written by the RecoveryCoordinator only."""
        self._recovery_translate = dict(table) if table else None

    def tile_key(self, *indices) -> tuple:
        """The LINEAGE identity of one tile: the key its ``Data`` is
        created with and the key the recovery lineage log records for
        reads/writes (core/recovery.py) — one source of truth, so the
        minimal-replay planner can map a recorded tile back to
        ``(collection, indices)`` without guessing the construction."""
        return (self.name,) + tuple(indices)

    def vpid_of(self, *indices) -> int:
        return 0

    def data_of(self, *indices) -> Data:
        """The local Data for these indices (only valid on the owner rank)."""
        raise NotImplementedError

    def rank_of_key(self, key: Any) -> int:
        return self.rank_of(*self.key_to_indices(key))

    def data_of_key(self, key: Any) -> Data:
        return self.data_of(*self.key_to_indices(key))

    def key_to_indices(self, key: Any) -> Tuple:
        raise NotImplementedError

    def refresh_backing(self, datum: Data) -> None:
        """Re-link a datum whose host copy was detached from user-visible
        backing storage (no-op for collections without a backing array)."""

    # -- convenience ------------------------------------------------------
    @property
    def super(self):
        """C struct-embedding shim: the reference reaches the tiled-matrix
        base as ``desc->super`` and the collection as ``desc->super.super``
        (two_dim_rectangle_cyclic.h:24); Python flattens the embedding, so
        the chain terminates on the object itself — JDF expressions like
        ``dA->super.mt`` (kcyclic.jdf:111) read through unchanged."""
        return self

    def is_local(self, *indices) -> bool:
        return self.owner_of(*indices) == self.myrank

    def __call__(self, *indices) -> "DataRef":
        """``A(k)`` in flow specifications resolves through here."""
        return DataRef(self, indices)


class DataRef:
    """A symbolic reference to a collection element (``A(m, n)``), used by
    flow endpoint expressions before resolution."""

    __slots__ = ("dc", "indices")

    def __init__(self, dc: DataCollection, indices: Tuple):
        self.dc = dc
        self.indices = indices

    @property
    def rank(self) -> int:
        return self.dc.rank_of(*self.indices)

    def resolve(self) -> Data:
        return self.dc.data_of(*self.indices)

    def __repr__(self):
        return f"{self.dc.name}{self.indices}"


_dc_registry_lock = threading.Lock()
_dc_registry: Dict[int, DataCollection] = {}
_dc_next_id = [1]


def dc_register(dc: DataCollection) -> int:
    """Register for cross-rank identification
    (reference: parsec_dc_register_id)."""
    with _dc_registry_lock:
        dc_id = _dc_next_id[0]
        _dc_next_id[0] += 1
        dc.dc_id = dc_id
        _dc_registry[dc_id] = dc
        return dc_id


def dc_lookup(dc_id: int) -> Optional[DataCollection]:
    with _dc_registry_lock:
        return _dc_registry.get(dc_id)


def dc_unregister(dc_id: int) -> None:
    with _dc_registry_lock:
        dc = _dc_registry.pop(dc_id, None)
        if dc is not None:
            dc.dc_id = None
