"""ICI transport: payload movement as device-to-device copies between the
device modules of one process.

The port of the JAX package's comm/ici.py, the second comm-engine module
(reference seam: the transport-neutral ``parsec_comm_engine_t`` vtable,
parsec/parsec_comm_engine.h:161-183).  There, dataflow payload edges
between the runtime's XLA devices lower to XLA collective programs over
the ICI mesh; here the devices are the context's CUDA device modules
(``device="cuda*N"``: N modules over one card, or one per card) or
their CPU-backed stand-ins (``"cpu:N"``), and each XLA program becomes
copies between them, with control (activation bookkeeping) on the host:

- ``put``      — one point-to-point tile edge: a device-to-device copy
                 into fresh storage on the destination module, never an
                 alias of the source.
- ``bcast``    — one producer tile copied onto every requested module in
                 one call (the dataflow-broadcast primitive of
                 remote_dep.c:334-357).  Its first customer is the GEMM
                 panel broadcast (apps/gemm.py ``panel_bcast``):
                 release_deps calls ``prebroadcast`` when one copy fans
                 out to consumers on several modules.
- ``permute``  — a batch of same-shaped tile edges.  The batch is split
                 into permutation rounds (each module sends and receives
                 at most once a round, the CollectivePermute rule of the
                 JAX package's ``lax.ppermute``), and each round is
                 issued as one batch of copies and counts as one permute
                 — the per-wavefront batched schedule of SURVEY §5.8.

Ordering on CUDA.  Each copy is ``CudaDevice.copy_from`` of the
destination module: enqueued on the SOURCE module's launch stream, behind
the producing launch (deps release once it is enqueued) and ahead of
anything that stream runs later — an in-place write of the same storage
by a donating launch among them — with the destination's stream waiting
on an event recorded after the copy, and the placed tensor recorded as
used on the destination stream for the caching allocator.  The
destination module's launches then read it in stream order, and a host
reader waits through ``data.host_read_fence``.  Nothing blocks the
calling thread.  (Issued on the destination's stream, a copy would be
ordered after the producing launch but not before the source module's
next in-place write, which eager completion may enqueue first.)

Versions.  A placed copy carries the version its payload had when the
copy was issued, read with it under the datum's lock, and a deferred
edge whose source copy moved on while it waited (a later write or a
re-placed tile re-using the same copy) is dropped: its bytes are no
longer the edge's.

What differs from the JAX package's module:

- ``mesh()`` returns the ordered list of modules; there is no jax
  ``Mesh`` and no program cache.
- A failed copy is not swallowed.  The JAX package's
  ``flush_placements`` and ``_flush_edges`` catch an XLA failure and
  fall back to puts (placement there is a best-effort prefetch); here a
  copy that raises fails the pool it was placing a tile for, and no
  other.  From ``release_deps`` (``preplace``/``prebroadcast``) it is
  the producing task's error.  A deferred edge carries the taskpool
  that queued it; a batch of edges (one engine-wide window, so edges of
  several pools) that raises is retried edge by edge, and an edge whose
  own copy raises again fails its taskpool through
  ``Context.record_pool_error``, while the other pools' edges are
  placed — so under a JobService one job's failed placement does not
  fail another job.  Dropping an edge whose consumer already staged in
  stays: that is the prefetch's semantics, not a fallback.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch

from parsec_tpu_torch.data.data import Coherency, DataCopy, to_host
from parsec_tpu_torch.devices.cuda import CudaDevice, _nbytes
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose

params.register("comm_ici_enabled", 1,
                "move multi-device payload edges between the device "
                "modules proactively (comm/ici.py: broadcasts, puts and "
                "batched permute rounds)")
params.register("comm_ici_bcast_min", 2,
                "minimum distinct consumer devices to trigger a collective "
                "panel broadcast")
params.register("comm_ici_permute_window_ms", 2.0,
                "how long a deferred point-to-point placement may wait for "
                "same-wavefront siblings before an idle worker flushes the "
                "batch as permute rounds")
params.register("comm_ici_permute_min", 2,
                "minimum batched edges to issue a flush as permute rounds; "
                "smaller flushes go as per-edge puts")


class IciStats:
    __slots__ = ("puts", "put_bytes", "bcasts", "bcast_bytes",
                 "permutes", "permute_edges", "permute_bytes")

    def __init__(self):
        self.puts = 0
        self.put_bytes = 0
        self.bcasts = 0
        self.bcast_bytes = 0
        self.permutes = 0
        self.permute_edges = 0
        self.permute_bytes = 0

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}


def _deferred(payload) -> bool:
    """A chain-held placeholder (devices/cuda.py ``Deferred``): its value
    does not exist yet."""
    return getattr(payload, "parsec_deferred", False)


class IciEngine:
    """Payload transport between the device modules of one process."""

    def __init__(self, registry):
        self.modules = [d for d in registry.devices
                        if isinstance(d, CudaDevice) and d.enabled]
        self._dev = {d.space: d for d in self.modules}
        self.stats = IciStats()
        self._stats_lock = threading.Lock()
        #: deferred single-consumer placements awaiting same-wavefront
        #: siblings: (produced copy, destination space, enqueue time, the
        #: copy's version then, the taskpool that queued it).
        #: Flushed as permute rounds (SURVEY §5.8's "batched per DAG
        #: wavefront" schedule) when a full round accumulates or an idle
        #: worker drains the window
        self._pending_edges: List[Tuple[DataCopy, int, float, int,
                                        Any]] = []
        self._pending_lock = threading.Lock()
        #: when the last single-consumer edge was seen: a fresh edge after
        #: a quiet spell is treated as a chain hop (placed immediately),
        #: one arriving inside the window as a wavefront sibling (batched)
        self._last_edge = float("-inf")

    # ------------------------------------------------------------------
    @property
    def ndev(self) -> int:
        return len(self.modules)

    def mesh(self) -> list:
        """The 1D mesh: every attached module, in memory-space order."""
        return list(self.modules)

    def _count(self, **inc) -> None:
        with self._stats_lock:
            for k, v in inc.items():
                setattr(self.stats, k, getattr(self.stats, k) + v)

    # lint: alias-wrapper
    def _copy(self, payload, src_space: int, dst_space: int):
        """One copy of ``payload`` (held in ``src_space``; -1 when it was
        made outside the modules, on the card's default stream) into fresh
        storage on module ``dst_space`` (see the module docstring)."""
        dst = self._dev[dst_space]
        src = payload if isinstance(payload, torch.Tensor) \
            else to_host(payload)
        if dst.is_cuda and src.is_cuda:
            return dst.copy_from(src, src_space)
        if not dst.is_cuda:
            out = torch.empty(tuple(src.shape), dtype=src.dtype)
            out.copy_(src)
            return out
        with torch.cuda.stream(dst.stream):     # from the host
            out = torch.empty(tuple(src.shape), dtype=src.dtype,
                              device=dst.tdev)
            out.copy_(src, non_blocking=src.is_pinned())
        return out

    @staticmethod
    def _snapshot(copy: DataCopy):
        """(payload, version) of a produced copy, read together."""
        with copy.data._lock:
            return copy.payload, copy.version

    # ------------------------------------------------------------------
    # point-to-point: the put of the CE vtable
    # ------------------------------------------------------------------
    def put(self, payload, dst_space: int, src_space: int = -1):
        """Move one tile to module ``dst_space``, device to device
        (reference: CE put with registered memory,
        parsec_mpi_funnelled.c:793).  ``src_space`` names the module
        holding ``payload`` (-1: made outside the modules).  The placed
        copy is private storage: a later donation of either side cannot
        reach the other."""
        out = self._copy(payload, src_space, dst_space)
        self._count(puts=1, put_bytes=_nbytes(payload))
        return out

    # ------------------------------------------------------------------
    # broadcast: one producer tile -> many modules, one call
    # ------------------------------------------------------------------
    def bcast(self, payload, dst_spaces: Sequence[int],
              src_space: int = -1) -> Dict[int, Any]:
        """Copy ``payload`` onto every requested module of the mesh in one
        call; return {space: tensor on that module} (reference: the
        dataflow bcast trees, remote_dep.c:334-357).  Counts one bcast."""
        out = {sp: self._copy(payload, src_space, sp)
               for sp in sorted(set(dst_spaces)) if sp in self._dev}
        self._count(bcasts=1, bcast_bytes=_nbytes(payload) * len(out))
        return out

    # ------------------------------------------------------------------
    # batched permute: one batch of copies per wavefront round
    # ------------------------------------------------------------------
    def permute(self, edges: Iterable[Tuple[int, int, Any]]
                ) -> Dict[Tuple[int, int], Any]:
        """Execute a batch of (src_space, dst_space, payload) tile edges.
        Same-shaped edges forming a partial permutation ride ONE round;
        the batch is split into permutation rounds and (shape, dtype)
        groups as needed.  Returns {(src_space, dst_space): tensor on
        dst}."""
        groups: Dict[Tuple, List[Tuple[int, int, Any]]] = {}
        results: Dict[Tuple[int, int], Any] = {}
        for s, d, payload in edges:
            if s == d:
                results[(s, d)] = payload
                continue
            arr_shape = tuple(getattr(payload, "shape", ()))
            dt = str(getattr(payload, "dtype", "f4"))
            groups.setdefault((arr_shape, dt), []).append((s, d, payload))
        for (shape, _dt), group in groups.items():
            for round_edges in self._rounds(group):
                results.update(self._permute_round(shape, round_edges))
        return results

    @staticmethod
    def _rounds(group: List[Tuple[int, int, Any]]
                ) -> List[List[Tuple[int, int, Any]]]:
        """Split edges into rounds where each device sends at most once
        and receives at most once (CollectivePermute is a partial
        permutation)."""
        rounds: List[List[Tuple[int, int, Any]]] = []
        for edge in group:
            for r in rounds:
                if all(edge[0] != e[0] and edge[1] != e[1] for e in r):
                    r.append(edge)
                    break
            else:
                rounds.append([edge])
        return rounds

    def _permute_round(self, shape, round_edges):
        """One permutation round: every edge's copy issued back to back,
        each on its destination module's stream; one permute."""
        out: Dict[Tuple[int, int], Any] = {}
        nbytes = 0
        for s, d, payload in round_edges:
            out[(s, d)] = self._copy(payload, s, d)
            nbytes += _nbytes(payload)
        self._count(permutes=1, permute_edges=len(round_edges),
                    permute_bytes=nbytes)
        return out

    # ------------------------------------------------------------------
    # runtime hook: collective panel broadcast on dataflow fan-out
    # ------------------------------------------------------------------
    def prebroadcast(self, copy: DataCopy, target_spaces: Sequence[int]
                     ) -> int:
        """Replicate a produced copy onto the consumer modules in one
        call, attaching SHARED device copies to its datum so each
        consumer's stage-in finds the tile resident (zero further
        movement).  Returns the number of modules the tile landed on."""
        datum = copy.data
        if datum is None:
            return 0
        payload, version = self._snapshot(copy)
        if payload is None or _deferred(payload):
            # chain-held placeholder: the value does not exist yet —
            # consumers lazily stage (and force) it
            return 0
        spaces = sorted({s for s in target_spaces if s in self._dev})
        with datum._lock:
            missing = [s for s in spaces
                       if (c := datum.copy_on(s)) is None or
                       c.coherency == Coherency.INVALID or
                       c.version < version]
        if len(missing) < int(params.get("comm_ici_bcast_min", 2)):
            return 0
        replicas = self.bcast(payload, missing, copy.device)
        attached = 0
        adopt = []
        with datum._lock:
            for sp, arr in replicas.items():
                existing = datum.copy_on(sp)
                if existing is None:
                    dc = DataCopy(datum, sp, payload=arr,
                                  coherency=Coherency.SHARED,
                                  version=version)
                    datum.attach_copy(dc)
                    adopt.append((sp, dc))
                    attached += 1
                elif existing.coherency == Coherency.INVALID or \
                        existing.version < version:
                    existing.payload = arr
                    existing.coherency = Coherency.SHARED
                    existing.version = version
                    adopt.append((sp, existing))
                    attached += 1
        self._adopt(datum, adopt)
        debug_verbose(7, "ici prebroadcast: %d replicas of %s", attached,
                      datum)
        return attached

    def preplace(self, copy: DataCopy, space: int) -> bool:
        """Single-consumer counterpart of :meth:`prebroadcast`: move one
        produced device-resident tile onto the consumer's module NOW —
        overlapping the transfer with scheduling — instead of lazily
        inside the consumer's stage-in (reference: the CE put of a
        point-to-point dep edge, parsec_mpi_funnelled.c:793)."""
        datum = copy.data
        if datum is None or space not in self._dev:
            return False
        if copy.device == space or copy.device not in self._dev:
            return False      # host-resident payloads stage in normally
        payload, version = self._snapshot(copy)
        if payload is None or _deferred(payload):
            return False
        with datum._lock:
            existing = datum.copy_on(space)
            if existing is not None and \
                    existing.coherency != Coherency.INVALID and \
                    existing.version >= version:
                return False  # already resident
        arr = self.put(payload, space, copy.device)
        return self._attach_placed(copy, space, arr, version)

    def _attach_placed(self, copy: DataCopy, space: int, arr,
                       version: int) -> bool:
        """Attach a freshly-moved replica of ``version`` to the datum as a
        SHARED copy on ``space`` (version-guarded: a copy there that is
        valid at that version or newer — the consumer staged it in, or
        wrote a newer one — wins) and register it with the module's
        memory ledger."""
        datum = copy.data
        placed = None
        with datum._lock:
            existing = datum.copy_on(space)
            if existing is None:
                placed = DataCopy(datum, space, payload=arr,
                                  coherency=Coherency.SHARED,
                                  version=version)
                datum.attach_copy(placed)
            elif existing.coherency == Coherency.INVALID or \
                    existing.version < version:
                existing.payload = arr
                existing.coherency = Coherency.SHARED
                existing.version = version
                placed = existing
        if placed is not None:
            self._adopt(datum, [(space, placed)])
        return True

    # ------------------------------------------------------------------
    # deferred placement: batch single-consumer edges per DAG wavefront
    # into permute rounds (SURVEY §5.8; reference counterpart: the
    # per-peer aggregation of the comm thread, remote_dep_mpi.c — here
    # aggregation happens across DEVICE edges of one wavefront)
    # ------------------------------------------------------------------
    def defer_place(self, copy: DataCopy, space: int, taskpool) -> bool:
        """Queue a device-resident single-consumer placement for
        ``taskpool``; when the batch completes a permutation round (every
        module sends/receives at most once) — or an idle worker drains
        the window (:meth:`flush_placements`) — the whole wavefront rides
        one permute instead of N separate puts.  Placement is purely a
        prefetch: consumers that stage in before the flush win the version
        race and the late replica is dropped.  A batch flushed here fails
        only the pools whose own copies raise (:meth:`_flush_batch`)."""
        datum = copy.data
        if datum is None or not self.device_resident(copy) \
                or space not in self._dev or copy.device == space \
                or self.ndev < 2:
            return False
        with datum._lock:
            version = copy.version
            existing = datum.copy_on(space)
            if existing is not None and \
                    existing.coherency != Coherency.INVALID and \
                    existing.version >= version:
                return False  # already resident
        now = time.monotonic()
        window = float(params.get("comm_ici_permute_window_ms", 2.0)) / 1e3
        immediate = False
        flush_now = None
        with self._pending_lock:
            if not self._pending_edges and now - self._last_edge > window:
                # a lone edge after a quiet spell is a serialized chain
                # hop until proven otherwise: place it NOW so the
                # transfer overlaps scheduling.  It also opens the wave
                # window: siblings arriving within it DO defer, so a
                # k-edge wavefront costs one put plus one (k-1)-edge
                # permute — within the "k edges ride <= 2 launches"
                # contract
                immediate = True
            else:
                self._pending_edges.append((copy, space, now, version,
                                            taskpool))
                # flush when the batch completes a permutation round —
                # OR when the oldest deferred edge has already outlived
                # the window (under load the gaps between wavefront
                # siblings stretch past it)
                full_round = any(
                    e[0].device == copy.device or e[1] == space
                    for e in self._pending_edges[:-1]) \
                    or len(self._pending_edges) >= self.ndev - 1 \
                    or now - self._pending_edges[0][2] >= window
                if full_round:
                    flush_now, self._pending_edges = self._pending_edges, []
            self._last_edge = now
        if immediate:
            return self.preplace(copy, space)
        if flush_now:
            self._flush_batch(flush_now)
        return True

    def flush_placements(self, force: bool = False) -> int:
        """Drain deferred placements older than the batching window (all
        of them when ``force``).  Called from idle workers and quiescence
        points (``Context.flush_ici``).  A copy that raises fails its own
        pool only (:meth:`_flush_batch`)."""
        if not self._pending_edges:
            return 0
        window = float(params.get("comm_ici_permute_window_ms", 2.0)) / 1e3
        take = None
        with self._pending_lock:
            if self._pending_edges and (
                    force or time.monotonic() - self._pending_edges[0][2]
                    >= window):
                take, self._pending_edges = self._pending_edges, []
        if not take:
            return 0
        self._flush_batch(take)
        return len(take)

    def _flush_batch(self, edges) -> None:
        """``_flush_edges``, contained per pool: a batch that raises is
        retried edge by edge (an edge the batch did place is skipped as
        resident), and an edge whose own copy raises again fails the
        taskpool that queued it; the batch's other edges are placed."""
        try:
            self._flush_edges(edges)
        except Exception:
            for edge in edges:
                try:
                    self._flush_edges([edge])
                except Exception as exc:
                    tp = edge[4]
                    tp.context.record_pool_error(tp, exc)

    def _flush_edges(self, edges) -> None:
        live = []
        for copy, space, _t, version, _tp in edges:
            datum = copy.data
            with datum._lock:
                payload = copy.payload
                if payload is None or _deferred(payload) or \
                        copy.version != version:
                    # evicted, or moved on to a later version, since: the
                    # edge's bytes are gone; a consumer stages lazily
                    continue
                existing = datum.copy_on(space)
                if existing is not None and \
                        existing.coherency != Coherency.INVALID and \
                        existing.version >= version:
                    # the consumer staged in (or wrote) while the edge sat
                    # in the window: a copy for it would move bytes nobody
                    # reads
                    continue
            live.append((copy, space, payload, version))
        if not live:
            return
        if len(live) < int(params.get("comm_ici_permute_min", 2)):
            for copy, space, _p, _v in live:
                self.preplace(copy, space)
            return
        # unique (src, dst) keys per permute() call: duplicate pairs would
        # collide in its result map, so they go in follow-up calls
        calls: List[list] = []
        for item in live:
            key = (item[0].device, item[1])
            for c in calls:
                if all((e[0].device, e[1]) != key for e in c):
                    c.append(item)
                    break
            else:
                calls.append([item])
        for c in calls:
            results = self.permute([(copy.device, space, payload)
                                    for copy, space, payload, _v in c])
            for copy, space, _p, version in c:
                arr = results.get((copy.device, space))
                if arr is not None:
                    self._attach_placed(copy, space, arr, version)

    def device_resident(self, copy: DataCopy) -> bool:
        """Cheap hot-path gate: only device-resident produced copies are
        candidates for placement (chain-held placeholders are not: the
        value does not exist)."""
        return copy.device in self._dev and copy.payload is not None \
            and not _deferred(copy.payload)

    def _adopt(self, datum, placed) -> None:
        """Register externally-attached copies with their module's memory
        ledger so eviction/budget accounting can see them (the copies were
        made on that module's own stream)."""
        for sp, dc in placed:
            self._dev[sp].adopt(datum, dc, space=sp)

    def consumer_spaces(self, taskpool, deliveries) -> List[int]:
        """Best-effort device targets for a list of local deliveries:
        each successor's affinity datum names its preferred/resident
        accelerator (reference: parsec_get_best_device's data-affinity
        rule, device.c:79-140)."""
        spaces: List[int] = []
        for succ_tc, succ_locals, _dflow in deliveries:
            if succ_tc.affinity is None:
                continue
            try:
                ref = succ_tc.affinity(succ_locals)
                datum = ref.resolve()
            except Exception:
                continue
            pref = datum.preferred_device
            if pref is not None and pref in self._dev:
                spaces.append(pref)
                continue
            v = datum.newest_version()
            for sp, c in datum.copies().items():
                if sp in self._dev and c.version == v \
                        and c.coherency != Coherency.INVALID:
                    spaces.append(sp)
                    break
        return spaces
