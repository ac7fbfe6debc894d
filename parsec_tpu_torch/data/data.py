"""Canonical data + per-memory-space copies with coherency.

Rebuild of the reference's data substrate (reference: parsec/data.c,
parsec/data_internal.h:35-81, parsec/data.h:28-31): a ``Data`` is one logical
datum (a matrix tile, say); it owns ``DataCopy`` instances, one per memory
space holding a version of the payload.  Coherency follows the reference's
MOESI-flavored protocol:

    INVALID    copy exists but its payload is stale
    SHARED     valid for reading; other valid copies may exist
    OWNED      valid, authoritative; other SHARED copies may exist
    EXCLUSIVE  valid and the only valid copy (a write makes it so)

Memory space 0 is host RAM (CPU ``torch.Tensor`` payloads) and spaces >=1
are device memory (CUDA tensors); actual movement is delegated to the
device layer's transfer hooks, so this module stays device-agnostic.
"""

from __future__ import annotations

import itertools
import threading
from enum import IntEnum
from typing import Any, Dict, Optional

import numpy as np
import torch

# Flow access modes (reference: parsec/flow modes FLOW_ACCESS_*)
ACCESS_NONE = 0x0
ACCESS_READ = 0x1
ACCESS_WRITE = 0x2
ACCESS_RW = ACCESS_READ | ACCESS_WRITE

# DataCopy.flags bits
FLAG_COW = 0x1   # payload is shared with readers: duplicate before writing
FLAG_SCRATCH = 0x2   # NEW-flow arena buffer: content undefined until the
                     # first writer runs (device stage-in may materialize
                     # it on device instead of shipping host bytes)


class Coherency(IntEnum):
    INVALID = 0
    OWNED = 1
    EXCLUSIVE = 2
    SHARED = 4


_data_keygen = itertools.count()

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}


def torch_dtype(dtype: Any) -> torch.dtype:
    """Coerce a dtype spec (torch dtype, numpy dtype or its name) to a
    torch dtype.  ``"bfloat16"`` maps to ``torch.bfloat16``: numpy has no
    bf16 of its own, so bf16 data lives only as torch tensors."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in ("bfloat16", "bf16"):
        return torch.bfloat16
    if getattr(dtype, "__name__", None) == "bfloat16" or \
            str(np.dtype(dtype)) == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(dtype)]


def materialize(payload: Any) -> Any:
    """``payload`` itself, or — for the deferred output of a chain-held
    device task (devices/cuda.py ``Deferred``) — the tensor it resolves
    to, running the held chain on its device first.  Every host reader of
    a payload comes through here."""
    if getattr(payload, "parsec_deferred", False):
        return payload.force()
    return payload


def host_read_fence(t: torch.Tensor) -> None:
    """Before a synchronous copy of the CUDA tensor ``t`` to the host:
    order the current stream after the launch streams of every device
    module on its card (devices/cuda.py ``host_read_fence``; a no-op
    unless several modules share the card)."""
    from parsec_tpu_torch.devices.cuda import host_read_fence as fence
    fence(t)


def to_host(payload: Any) -> torch.Tensor:
    """``payload``'s values as a CPU tensor.  A CPU tensor or a numpy
    array comes back as an alias of its storage; a device tensor is
    copied down (on the current stream, synchronously, after the device
    modules' launches: ``host_read_fence``)."""
    payload = materialize(payload)
    if isinstance(payload, torch.Tensor):
        if payload.device.type == "cpu":
            return payload
        host_read_fence(payload)
        return payload.to("cpu")
    return torch.as_tensor(np.asarray(payload))


def private_host(payload: Any) -> torch.Tensor:
    """A CPU tensor with storage of its own — never an alias of
    ``payload`` (``torch.from_numpy``, a same-device ``.to()`` and
    ``.contiguous()`` all alias, so writers must come through here)."""
    payload = materialize(payload)
    if isinstance(payload, torch.Tensor) and payload.device.type != "cpu":
        return to_host(payload)
    return to_host(payload).clone()


class DataCopy:
    """One version of a datum in one memory space
    (reference: parsec_data_copy_t)."""

    __slots__ = ("data", "device", "payload", "coherency", "version",
                 "readers", "flags", "arena", "arena_refs", "dtt",
                 "__weakref__")

    def __init__(self, data: "Data", device: int, payload: Any = None,
                 coherency: Coherency = Coherency.INVALID, version: int = 0):
        self.data = data
        self.device = device
        self.payload = payload
        self.coherency = coherency
        self.version = version
        #: device tasks that read this copy and are not launched yet: an
        #: in-place write (buffer donation) of the datum waits them out
        self.readers = 0
        self.flags = 0
        self.arena = None         # owning arena, if arena-allocated
        #: repo-entry holds on an arena copy: a NEW-flow buffer chained
        #: through several tasks is registered in EVERY producer's repo
        #: entry, and may only return to the freelist when the LAST
        #: entry retires (reference: refcounted copies in repo entries,
        #: datarepo.h:50-58)
        self.arena_refs = 0
        self.dtt = None           # datatype/layout tag (reshape engine)

    def is_pinned_snapshot(self, pinned: bool) -> bool:
        """True when this bound copy must be read as a version-pinned
        snapshot rather than through the datum's coherency protocol:
        either a writeback replacement detached it, or — for a task-fed
        (pinned) input — a concurrent writeback invalidated it in place.
        (A detached copy with payload None was merely evicted and should
        re-stage from the datum's newest valid copy instead.)"""
        if self.payload is None or self.data is None:
            return False
        attached = self.data.copy_on(self.device) is self
        return (not attached) or \
            (pinned and self.coherency == Coherency.INVALID)

    def __repr__(self):
        return (f"<DataCopy dev={self.device} v={self.version} "
                f"{self.coherency.name} of {self.data}>")


class Data:
    """One logical datum with per-device copies (reference: parsec_data_t)."""

    def __init__(self, key: Any = None, collection: Any = None,
                 nb_elts: int = 0, owner_device: int = 0):
        self.key = key if key is not None else next(_data_keygen)
        self.collection = collection
        self.nb_elts = nb_elts
        self.owner_device = owner_device
        self.preferred_device = -1
        self._lock = threading.RLock()
        self._copies: Dict[int, DataCopy] = {}
        self._version_clock = 0   # monotonic; never regresses on invalidation

    def __repr__(self):
        return f"<Data key={self.key}>"

    # -- copy management -------------------------------------------------
    def attach_copy(self, copy: DataCopy) -> DataCopy:
        with self._lock:
            if copy.device in self._copies:
                raise ValueError(f"device {copy.device} already has a copy")
            self._copies[copy.device] = copy
            self._version_clock = max(self._version_clock, copy.version)
            return copy

    def detach_copy(self, device: int) -> Optional[DataCopy]:
        with self._lock:
            return self._copies.pop(device, None)

    def copy_on(self, device: int) -> Optional[DataCopy]:
        with self._lock:
            return self._copies.get(device)

    def copies(self) -> Dict[int, DataCopy]:
        with self._lock:
            return dict(self._copies)

    def create_copy(self, device: int, payload: Any = None,
                    coherency: Coherency = Coherency.INVALID,
                    version: int = 0) -> DataCopy:
        return self.attach_copy(DataCopy(self, device, payload, coherency,
                                         version))

    # -- coherency protocol ----------------------------------------------
    def newest_version(self) -> int:
        with self._lock:
            return max((c.version for c in self._copies.values()
                        if c.coherency != Coherency.INVALID), default=0)

    def newest_copy(self, prefer_device: Optional[int] = None) -> Optional[DataCopy]:
        """The authoritative valid copy (highest version, OWNED/EXCLUSIVE
        preferred, then prefer_device)."""
        with self._lock:
            best = None
            v = self.newest_version()
            for c in self._copies.values():
                if c.coherency == Coherency.INVALID or c.version != v:
                    continue
                if best is None:
                    best = c
                elif (c.coherency in (Coherency.OWNED, Coherency.EXCLUSIVE)
                      and best.coherency == Coherency.SHARED):
                    best = c
                elif prefer_device is not None and c.device == prefer_device \
                        and best.device != prefer_device:
                    if best.coherency == Coherency.SHARED or \
                       c.coherency != Coherency.SHARED:
                        best = c
            return best

    def transfer_ownership(self, device: int, access: int) -> Optional[DataCopy]:
        """Update coherency for an upcoming access on ``device``; returns the
        source copy a transfer must pull from (None if the local copy is
        already valid).  Mirrors parsec_data_transfer_ownership_to_copy
        (reference: parsec/data.h:115-126, data.c).
        """
        with self._lock:
            target = self._copies.get(device)
            if target is None:
                raise KeyError(f"no copy of {self} on device {device}")
            newest = self.newest_copy(prefer_device=device)
            source = None
            # A pull is only needed when the access actually reads the datum
            # (WRITE-only flows overwrite it entirely).
            if (access & ACCESS_READ) and (
                    target.coherency == Coherency.INVALID or
                    (newest is not None and target.version < newest.version)):
                source = newest if newest is not target else None
            if access & ACCESS_WRITE:
                for c in self._copies.values():
                    if c is not target:
                        c.coherency = Coherency.INVALID
                target.coherency = Coherency.EXCLUSIVE
            else:
                if target.coherency == Coherency.INVALID:
                    target.coherency = Coherency.SHARED
                    if newest is not None and newest.coherency == Coherency.EXCLUSIVE:
                        newest.coherency = Coherency.OWNED
                # valid copies stay as they are on read
            return source

    def complete_write(self, device: int) -> None:
        """Version bump after a write completes on ``device``.  Uses the
        monotonic clock, not max-over-valid-copies, so invalidated stale
        copies can never out-version the authoritative one."""
        with self._lock:
            c = self._copies[device]
            self._version_clock += 1
            c.version = self._version_clock

    def overwrite_on(self, space: int, payload) -> "DataCopy":
        """Land ``payload`` (an already-materialized buffer — e.g. a
        device array) as the NEW authoritative copy on ``space``: every
        other copy invalidates, the version clock bumps.  The device-
        space sibling of :meth:`overwrite_host`, keeping the write
        transition in Data rather than in every caller."""
        with self._lock:
            dc = self._copies.get(space)
            if dc is None:
                dc = self.create_copy(space, payload=payload)
            else:
                dc.payload = payload
            for c in self._copies.values():
                if c is not dc:
                    c.coherency = Coherency.INVALID
            self._version_clock += 1
            dc.version = self._version_clock
            dc.coherency = Coherency.EXCLUSIVE
            return dc

    def overwrite_host(self, arr) -> "DataCopy":
        """Land ``arr`` as the NEW authoritative host value: write in
        place when the host buffer matches (collection backing views
        stay linked), invalidate every other copy, bump the version
        clock.  The one sanctioned externally-sourced write, so the
        coherency transition lives here, not in every caller."""
        a = to_host(arr)
        with self._lock:
            host = self._copies.get(0)
            if host is None:
                host = self.create_copy(0, payload=a.clone())
            elif isinstance(host.payload, torch.Tensor) and \
                    host.payload.shape == a.shape and \
                    host.payload.dtype == a.dtype:
                host.payload.copy_(a)
            else:
                host.payload = a.clone()
            for c in self._copies.values():
                if c is not host:
                    c.coherency = Coherency.INVALID
            self._version_clock += 1
            host.version = self._version_clock
            host.coherency = Coherency.EXCLUSIVE
            return host

    def pull_to_host(self) -> Optional[DataCopy]:
        """Make the host copy current WITHOUT stealing ownership: the
        newest device copy stays valid (EXCLUSIVE degrades to OWNED) so
        device-resident data is readable on the host yet needs no re-stage
        on its next device use.  This is the read path of collections
        (to_array & friends); tasks use transfer_ownership instead."""
        with self._lock:
            host = self._copies.get(0)
            newest = self.newest_copy(prefer_device=0)
            if newest is None or newest is host or (
                    host is not None and
                    host.coherency != Coherency.INVALID and
                    host.version >= newest.version):
                pass   # already current: no D2H transfer
            else:
                src = materialize(newest.payload)
                if host is None:
                    host = self.create_copy(0, payload=private_host(src),
                                            coherency=Coherency.SHARED,
                                            version=newest.version)
                else:
                    dst = host.payload
                    if isinstance(dst, torch.Tensor) and \
                            dst.device.type == "cpu" and \
                            dst.shape == src.shape and dst.dtype == src.dtype:
                        if src.is_cuda:
                            host_read_fence(src)
                        dst.copy_(src)
                    else:
                        host.payload = private_host(src)
                    host.version = newest.version
                    host.coherency = Coherency.SHARED
                if newest.coherency == Coherency.EXCLUSIVE:
                    newest.coherency = Coherency.OWNED
            # NOTE: no backing re-link here — pull_to_host runs mid-run
            # (eviction write-back) while pinned snapshot readers may
            # still hold the old backing view; re-linking happens only at
            # quiescent points (taskpool termination, to_array, device
            # flush at fini) via collection.refresh_backing.
            return host

    def start_read(self, device: int) -> None:
        with self._lock:
            self._copies[device].readers += 1

    def end_read(self, device: int) -> None:
        with self._lock:
            self._copies[device].readers -= 1


def new_data(payload: Any, key: Any = None, device: int = 0,
             collection: Any = None) -> Data:
    """Wrap an existing host payload as an OWNED datum (the common path for
    collection-backed tiles)."""
    nb = getattr(payload, "nbytes", 0)
    d = Data(key=key, collection=collection, nb_elts=nb, owner_device=device)
    d.create_copy(device, payload=payload, coherency=Coherency.OWNED, version=1)
    return d
