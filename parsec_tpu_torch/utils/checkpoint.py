"""Checkpoint / restore of collection state.

The reference has NO runtime checkpointing (taskpool state is never
serialized; the closest mechanisms are completion callbacks and data
flush).  This layer quiesces (pools complete, device pipelines drained,
comm settled), flushes every authoritative device copy home, then
snapshots the collections' local tiles — one file per rank, restorable
into freshly built collections of the same shape/distribution.

The port's shards are the JAX package's format: one ``.npz`` per rank,
numpy arrays keyed ``<name>:<m>:<n>`` with a ``v:`` version stamp each.
Tiles are torch tensors here, and numpy has no bf16: a bf16 tile is
stored as its raw 16-bit words, with its dtype name under a ``t:`` key,
and comes back as a bf16 tensor bit for bit.

Usage::

    ctx.wait()                                   # quiesce the DAGs
    checkpoint(ctx, [A, B, C], "/path/ckpt")     # rank-local snapshot
    ...
    restore(ctx, [A, B, C], "/path/ckpt")        # tiles + versions back

Checkpoint/restore are collective when a comm engine is attached: every
rank writes/reads its own shard and a barrier delimits the snapshot so
no rank can race ahead into mutating state another rank still saves.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from parsec_tpu_torch.data.data import to_host
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose

#: format 2 adds per-tile version stamps ("v:" keys) so a shard can
#: serve as an exact-version replay cut for the recovery lineage
#: planner; format-1 shards (no stamps) still restore
FORMAT_VERSION = 2

params.register("recovery_checkpoint_interval_s", 0.0,
                "periodic incremental tile checkpoints for the recovery "
                "lineage planner (core/recovery.py): > 0 captures a "
                "version-stamped host copy of each dirty tile at most "
                "once per interval, riding the write-flow version bumps "
                "the lineage log already observes — the minimal-replay "
                "cut then lands on the most recent captured version "
                "instead of walking back to the pool-attach snapshot.  "
                "0 (default) disables the capture plane")
params.register("recovery_checkpoint_keep", 2,
                "captured versions retained per tile by the incremental "
                "checkpoint store (older captures evict; memory bound = "
                "keep x tile bytes per dirty tile)")


class TileCheckpointStore:
    """In-memory incremental tile checkpoints: version-stamped host
    copies captured on the write-flow completion path (the recovery
    lineage hook calls :meth:`note_write`), at most one capture per
    tile per ``recovery_checkpoint_interval_s``.

    This is the checkpoint-as-lineage tier: the minimal-replay planner
    (core/recovery.py) treats every captured ``(tile, version)`` as a
    MATERIALIZABLE cut, so a backward walk stops at the newest capture
    at-or-below the needed version instead of replaying from the
    pool-attach snapshot — bounded replay depth for long version
    chains.  Captures are torn-free by construction: they run after
    ``complete_write`` bumped the version and before any later writer
    of the same tile can start (the DAG serializes writers).
    """

    def __init__(self, interval_s: float, keep: int = 2):
        self.interval = float(interval_s)
        self.keep = max(1, int(keep))
        #: tile key -> [(version, host tensor)] newest-last
        #: (guarded-by: _lock)
        self._tiles: Dict[Tuple, List[Tuple[int, torch.Tensor]]] = {}
        self._last: Dict[Tuple, float] = {}      # guarded-by: _lock
        self._lock = threading.Lock()
        self.captures = 0

    def note_write(self, key: Tuple, version: int, payload) -> None:
        """Capture ``payload`` (already host-resident) at ``version``
        when the tile's interval elapsed; cheap no-op otherwise."""
        now = time.monotonic()
        last = self._last.get(key)
        if last is not None and now - last < self.interval:
            return
        if not isinstance(payload, torch.Tensor) or \
                payload.device.type != "cpu":
            return
        arr = payload.clone()
        with self._lock:
            self._last[key] = now
            lst = self._tiles.setdefault(key, [])
            lst.append((int(version), arr))
            del lst[:-self.keep]
            self.captures += 1

    def versions(self, key: Tuple) -> Tuple[int, ...]:
        with self._lock:
            return tuple(v for v, _ in self._tiles.get(key, ()))

    def get(self, key: Tuple, version: int) -> Optional[torch.Tensor]:
        with self._lock:
            for v, arr in self._tiles.get(key, ()):
                if v == version:
                    return arr
        return None

    def drop(self, key: Tuple) -> None:
        with self._lock:
            self._tiles.pop(key, None)
            self._last.pop(key, None)

    def drop_owner(self, owner) -> None:
        """Evict every capture of one owning collection (keys are
        ``(owner, tile_key)`` — the recovery sweep calls this when a
        collection's recovery spec retires, so a later job's
        same-named tiles can never be served a previous job's bytes
        and a resident service does not accumulate captures forever)."""
        with self._lock:
            for k in [k for k in self._tiles if k[0] == owner]:
                del self._tiles[k]
            for k in [k for k in self._last if k[0] == owner]:
                del self._last[k]

    def clear(self) -> None:
        with self._lock:
            self._tiles.clear()
            self._last.clear()


#: torch dtypes numpy has no counterpart of: stored as raw words of the
#: same width, re-viewed on restore (bf16 without ml_dtypes)
_RAW_WORDS = {torch.bfloat16: np.int16}


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A tile's host tensor as a numpy array, plus the torch dtype name
    when it travels as raw words."""
    raw = _RAW_WORDS.get(t.dtype)
    if raw is None:
        return t.numpy(), None
    return t.view(torch.int16).numpy(), str(t.dtype).rpartition(".")[2]


def _from_shard(zf, key: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(zf[key]))
    tk = "t:" + key
    if tk in zf.files:
        t = t.view(getattr(torch, str(zf[tk])))
    return t


def _rank_path(context, path: str) -> str:
    rank = context.rank if context is not None else 0
    return f"{path}.r{rank}.npz"


def _check_degraded(context, op: str) -> list:
    """Fail FAST under a degraded comm topology: the quiesce/barrier
    discipline below assumes every rank alive, and a checkpoint
    attempted with a dead peer used to wedge in the collective barrier
    until its timeout.  Dead peers a recovery EXCUSED (their partition
    re-mapped onto survivors) are fine — the barrier itself narrowed to
    the survivor set — but their absence is recorded in the shard
    metadata as an explicit marker.  Returns the excused ranks."""
    comm = getattr(context, "comm", None)
    if comm is None:
        return []
    ce = comm.ce
    excused = set(getattr(ce, "excused_peers", ()) or ())
    fatal = set(ce.dead_peers) - excused
    if fatal:
        from parsec_tpu_torch.core.errors import CheckpointDegradedError
        raise CheckpointDegradedError(
            f"rank {context.rank}: {op} with dead peer(s) "
            f"{sorted(fatal)} — the collective barrier cannot complete "
            "(recover or rebuild the gang first)", ranks=fatal)
    return sorted(excused & set(ce.dead_peers))


def checkpoint(context, collections: Iterable, path: str) -> str:
    """Snapshot every local tile of ``collections`` (host-authoritative:
    device copies are flushed home first).  Returns the rank-local file.
    Call after ``context.wait()`` — a checkpoint of a running DAG is a
    torn checkpoint."""
    excused = _check_degraded(context, "checkpoint")
    # drain device pipelines and push authoritative copies home
    for d in context.device_registry.accelerators:
        dsync = getattr(d, "sync", None)
        if dsync is not None:
            dsync()
    context.device_registry.flush_all()
    arrays = {}
    meta = {"format": FORMAT_VERSION, "rank": context.rank,
            "nranks": context.nranks}
    for dc in collections:
        for idx in dc.local_tiles():
            datum = dc.data_of(*idx)
            copy = datum.pull_to_host()
            key = ":".join([dc.name] + [str(i) for i in idx])
            arrays[key], tname = _to_numpy(to_host(copy.payload))
            if tname is not None:
                arrays["t:" + key] = np.array(tname)
            # per-tile version stamp (format 2): the shard doubles as
            # an exact-version replay cut for the lineage planner
            arrays["v:" + key] = np.int64(datum.newest_version())
    out = _rank_path(context, path)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    # excused dead ranks write no shard of their own; their adopted
    # tiles land in THIS shard (local_tiles routes through owner_of)
    # and the marker makes the absence explicit at restore time
    np.savez(out, __meta__=np.array([meta["format"], meta["rank"],
                                     meta["nranks"]]),
             __excused__=np.array(excused, dtype=np.int64), **arrays)
    if context.comm is not None:
        context.comm.ce.barrier()    # the snapshot is collective
    debug_verbose(3, "checkpoint: %d tiles -> %s", len(arrays), out)
    return out


def restore(context, collections: Iterable, path: str) -> int:
    """Load a snapshot back into ``collections`` (same shapes and
    distribution as at checkpoint time).  Host copies become the newest
    authoritative version; stale device copies invalidate.  Returns the
    number of tiles restored.

    Degraded topologies: under a recovery re-mapping, ``local_tiles``
    includes tiles ADOPTED from an excused dead rank — those were
    written to the DEAD rank's shard of a pre-death checkpoint, so
    missing keys fall back to the shard of the tile's original owner
    (``rank_of``, the pure distribution) before failing.  This is the
    checkpoint-as-lineage-base story: a survivor restores the whole
    re-mapped partition from the collective snapshot."""
    _check_degraded(context, "restore")
    src = _rank_path(context, path)
    sibling: dict = {}   # original-owner shards opened on demand

    def _sibling(rank: int):
        zf = sibling.get(rank)
        if zf is None:
            zf = sibling[rank] = np.load(
                f"{path}.r{rank}.npz", allow_pickle=False)
        return zf

    try:
        with np.load(src, allow_pickle=False) as zf:
            meta = zf["__meta__"]
            if int(meta[0]) not in (1, FORMAT_VERSION):
                raise ValueError(f"{src}: unsupported checkpoint format "
                                 f"{int(meta[0])}")
            if int(meta[2]) != context.nranks:
                raise ValueError(
                    f"{src}: checkpoint was taken on {int(meta[2])} "
                    f"ranks, restoring on {context.nranks} (elastic "
                    "restore is not supported — match the layout)")
            n = 0
            for dc in collections:
                for idx in dc.local_tiles():
                    key = ":".join([dc.name] + [str(i) for i in idx])
                    source = zf
                    if key not in zf:
                        owner = dc.rank_of(*idx)
                        if owner != context.rank:
                            try:
                                source = _sibling(owner)
                            except OSError:
                                raise KeyError(
                                    f"{src}: missing tile {key} (and "
                                    f"no shard of original owner rank "
                                    f"{owner})")
                        if key not in source:
                            raise KeyError(f"{src}: missing tile {key}")
                    datum = dc.data_of(*idx)
                    datum.overwrite_host(_from_shard(source, key))
                    n += 1
    finally:
        for zf in sibling.values():
            zf.close()
    if context.comm is not None:
        context.comm.ce.barrier()
    debug_verbose(3, "restore: %d tiles <- %s", n, src)
    return n


def shard_versions(path: str, rank: int) -> Dict[str, int]:
    """The per-tile version stamps of one rank's shard (format 2;
    empty for format-1 shards) — the replay-cut metadata the recovery
    cookbook reads when bounding replay depth against a collective
    checkpoint."""
    out: Dict[str, int] = {}
    with np.load(f"{path}.r{rank}.npz", allow_pickle=False) as zf:
        for key in zf.files:
            if key.startswith("v:"):
                out[key[2:]] = int(zf[key])
    return out
