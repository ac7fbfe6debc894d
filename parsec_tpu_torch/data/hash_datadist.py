"""Hash-based irregular data distribution.

Reference: parsec/data_dist/hash_datadist.c — arbitrary key -> (rank, data)
mapping for irregular applications (trees, graphs, sparse problems).
``set_data`` takes a numpy array or a tensor; the payload is the CPU
tensor ``to_host`` makes of it (an alias of a CPU tensor or array).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from parsec_tpu_torch.data.collection import DataCollection
from parsec_tpu_torch.data.data import Data, new_data, to_host


class HashDatadist(DataCollection):
    def __init__(self, nodes: int = 1, myrank: int = 0, name: str = "H"):
        super().__init__(nodes=nodes, myrank=myrank, name=name)
        self._lock = threading.Lock()
        self._entries: Dict[Any, Tuple[int, int, Optional[Data]]] = {}

    def set_rank(self, key: Any, rank: int, vpid: int = 0) -> None:
        """Declare ownership of a key (all ranks declare the full map)."""
        with self._lock:
            old = self._entries.get(key)
            data = old[2] if old else None
            self._entries[key] = (rank, vpid, data)

    def set_data(self, key: Any, payload: Any) -> Data:
        """Attach the local payload for an owned key."""
        with self._lock:
            rank, vpid, _ = self._entries.get(key, (self.myrank, 0, None))
            d = new_data(to_host(payload), key=(self.name, key),
                         collection=self)
            self._entries[key] = (rank, vpid, d)
            return d

    def data_key(self, key: Any) -> Any:
        return key

    def key_to_indices(self, key: Any) -> Tuple:
        return (key,)

    def rank_of(self, key: Any) -> int:
        with self._lock:
            e = self._entries.get(key)
        if e is None:
            raise KeyError(f"{self.name}: unknown key {key!r}")
        return e[0]

    def vpid_of(self, key: Any) -> int:
        with self._lock:
            e = self._entries.get(key)
        return e[1] if e else 0

    def data_of(self, key: Any) -> Data:
        with self._lock:
            e = self._entries.get(key)
        if e is None or e[2] is None:
            raise KeyError(f"{self.name}: no local data for {key!r}")
        return e[2]
