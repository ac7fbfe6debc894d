"""Recovery plane: lineage re-execution, partition re-mapping, rejoin.

The second exit from every containment path — RECOVER instead of
failing the pools a dead peer touched:

  1. **Lineage re-execution.**  When ``declare_peer_dead`` fires, the
     surviving ranks reconstruct the dead rank's lost tiles instead of
     failing the pool.  Each survivor deterministically computes the
     same recovery decision (coordinator = lowest surviving rank, with
     an AGREEMENT ROUND below converging the dead-set view), rewinds
     the affected pool's termdet counters (``taskpool_reset``),
     restores what the replay needs — the registration-time snapshot,
     an incremental tile checkpoint
     (``utils/checkpoint.TileCheckpointStore``), or the collection's
     re-runnable source (``DataCollection.set_init``) for tiles whose
     only copy died with their rank — and re-inserts the re-execution
     sub-DAG on the survivors (``ParameterizedTaskpool.startup``
     re-enumeration with translated owner-computes, or the pool's
     ``recovery_replay`` for insert-driven DTD pools).

     **Minimal replay** (``recovery_minimal``, default on): every pool
     with the lineage plane armed keeps a RECORDED per-task lineage
     ring (``Taskpool._lineage``: task key, write-flow tile versions,
     read versions, remote activation dests — recorded at
     ``complete_execution`` off the release path), and the restart
     re-executes only the LOST SET: the whole adopted dead partition
     (its log died with it), the survivor's not-yet-completed tasks,
     and the recorded backward closure of everything that must re-feed
     the dead partition's replay — ``minimal_plan`` below computes it
     from the RECORDED (not re-derived) edges, with the replay cut
     always landing on a checkpointed, snapshotted, or live-intact
     version.  Skipped tasks' deliveries are synthesized from those
     materialized versions; cross-survivor re-feeds negotiate over the
     TAG_RECOVER control lane (a peer that cannot honor a need nacks
     and both sides fall back).  Replay-from-restore-point stays the
     fallback — taken whenever the lineage ring evicted the cut, the
     pool is dynamic, a DTD skip could not be agreed, or a need was
     refused — counted in ``parsec_recovery_full_replays_total``.
     Insert-driven (DTD) pools agree a skippable prefix of their SPMD
     insert stream instead (``dtd_skip_prefix``, ``_plan_dtd_skip``):
     the replay ghost-tracks the agreed prefix and re-executes the
     rest, and a designated holder rank serves each tile's cut value.

  2. **Partition re-mapping.**  The dead rank's key range re-balances
     onto survivors through a rank-translation table installed PER
     COLLECTION (``DataCollection.set_rank_translation``): ``rank_of``
     stays the pure distribution function while ``owner_of`` — which
     task placement, activation routing, and local-tile materialization
     consult — routes around the hole.  Pools over untouched
     collections never observe a re-mapped owner.

  3. **Elastic rejoin.**  A restarted rank comes back with a bumped
     incarnation epoch (``--mca comm_epoch`` / ``PARSEC_MCA_COMM_EPOCH``),
     re-dials the transports, and performs a TAG_REJOIN handshake: the
     survivors validate the epoch against the fence recorded at death
     (stale frames of the previous incarnation are dropped before they
     can touch the Safra balance — see RemoteDepEngine), clear the dead
     mark, hand back the current translation table, and the rank takes
     its partition back for every subsequently attached pool.  On shm
     the survivor re-creates its inbound ring for the dead rank when
     the death is declared, so the restarted incarnation's handshake
     finds a fresh, empty ring (comm/shm.py).  A JobService attached to
     the plane (``attach_service``) is told of each start, completion,
     failure and rejoin (``note_recovery``).

Safra/termdet reconciliation: the remote-dep engine keeps per-peer send
and receive counters next to the global balance; a recovery subtracts
the dead rank's whole contribution in one critical section (the same
contract ``faultinject.on_frame_fault`` established for injected drops)
and fences later frames from the dead incarnation, so the token sees
exactly the in-flight traffic among survivors and termination converges
after re-insertion.

Everything here is OPT-IN (``recovery_enable``, default 0): disabled,
every path reproduces the containment behavior exactly.

Agreement round (TAG_RECOVER): before computing the translation table,
every survivor converges its dead-set view with the coordinator —
non-coordinators report their observed deaths and wait (bounded,
``recovery_agree_timeout_s``) for the coordinator's CONFIRMED excusal
broadcast; the coordinator coalesces reports for
``recovery_agree_window_s`` and broadcasts the union, and a receiver
learning of a death it has not detected yet declares it immediately.

The port's copy of the JAX package's core/recovery.py.  Its deliberate
differences:

* tiles are torch tensors: snapshots and checkpoint captures are host
  clones, and a re-runnable source may return a tensor on a card, which
  then lands there as the tile's device copy (no host round trip);
* the drain before a restore also empties the device modules: a stale
  task still queued in a device module completes through the epoch
  fence without launching, and every module's launch stream is
  synchronized, so no in-place kernel (K1 with ``out=C``) can land on
  restored bytes.  A drain that times out aborts the recovery.  A DTD
  task the drain drops unlaunched claims no landed write in the skip
  evidence (core/scheduling.complete_execution ``ran``);
* the minimal planner takes every desc-read tile of the instance space
  as live before it plans (the JAX package's loses desc rewinds when no
  task has completed yet);
* an attached service hears a recovery's ``start`` before the event is
  queued (the JAX package's can hear it after the recovery thread's
  ``done``, and then stays degraded);
* a restart that ends while a later death's event for the same pool is
  queued leaves the pool marked recovering (the JAX package unmarks it,
  and its replay's sends to the second dead rank then fail the pool);
* a replay-driven (DTD) pool's restart first waits for the
  application's insert stream to end (``_await_insert_stream``), so the
  replay never inserts beside it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from parsec_tpu_torch.core.taskpool import (ParameterizedTaskpool, Taskpool,
                                            TaskpoolState)
from parsec_tpu_torch.data.data import to_host
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose, warning

params.register("recovery_max_attempts", 2,
                "per-taskpool budget of peer-death recoveries: one more "
                "rank dying after this many restarts fails the pool "
                "with the contained structured error instead of "
                "recovering again (survivor exhaustion stays a CLEAN "
                "failure, never a loop)")
params.register("recovery_snapshot", 1,
                "snapshot each registered pool's local collection tiles "
                "at attach — the lineage restore point for the pool's "
                "own partition (a dead rank's ADOPTED tiles restore "
                "from the collection's init_fn re-runnable source).  "
                "0 relies on init_fn alone")
params.register("recovery_drain_s", 10.0,
                "bound on waiting for in-flight stale-generation task "
                "bodies to leave the workers before tiles are restored "
                "(the run_epoch fence discards them at completion; this "
                "wait keeps their in-place writes off restored data)")
params.register("recovery_rejoin", 1,
                "accept TAG_REJOIN handshakes from restarted "
                "incarnations of dead ranks (needs recovery_enable; "
                "0 keeps the zombie-reconnect rejection)")
params.register("recovery_completed_grace_s", 30.0,
                "how long a LOCALLY-completed pool stays restartable "
                "after its termination: within the window a peer death "
                "still restarts it (another survivor may need its "
                "re-executed partition — local completion is not "
                "global), past it the pool's recovery spec and tile "
                "snapshots are evicted, so a resident service's job "
                "history is never resurrected or leaked")
params.register("recovery_lineage", 1,
                "record the per-task lineage ring (task key, write-flow "
                "tile versions, read versions, remote dests) at "
                "complete_execution for every registered pool — the "
                "recorded edges minimal replay walks.  0 disables "
                "recording AND minimal replay (needs recovery_enable)")
params.register("recovery_lineage_ring", 8192,
                "per-pool bound on lineage records and completed-key "
                "tracking; a pool whose completions exceed it falls "
                "back to replay-from-restore-point on the next death "
                "(counted in parsec_recovery_full_replays_total)")
params.register("recovery_minimal", 1,
                "re-execute only the recorded-lineage minimal set on a "
                "peer death (adopted partition + pending tasks + the "
                "backward closure re-feeding them) instead of the "
                "whole local partition.  Falls back to the full "
                "restore-point replay whenever the plan is infeasible "
                "(ring evicted, no snapshot for an exact-version cut, "
                "a peer nacked a re-feed need, dynamic/insert-driven "
                "pool)")
params.register("recovery_agree_window_s", 0.25,
                "coordinator-side coalescing window of the dead-set "
                "agreement round: death reports arriving within it "
                "merge into ONE confirmed excusal broadcast, so "
                "near-simultaneous multi-deaths cannot transiently "
                "diverge survivors' translation tables")
params.register("recovery_agree_timeout_s", 3.0,
                "how long a non-coordinator survivor waits for the "
                "confirmed dead-set broadcast (and a minimal-replay "
                "requester for its need acks, and a DTD skip-agreement "
                "participant for the frontier/prefix round) before "
                "proceeding with its local view / full replay — the "
                "bounded fallback when the coordinator itself died "
                "mid-round")
params.register("recovery_need_rounds", 2,
                "bound on minimal-replay need-negotiation rounds per "
                "pool restart: a merged seed closure that WIDENS the "
                "remote needs re-issues a second need->ack/nack round "
                "against the peers' frozen plans (acked when the "
                "resolved producers are already in the frozen replay "
                "set) instead of falling straight back to full replay; "
                "past the cap the fallback is taken, counted in "
                "parsec_recovery_need_rounds_total{outcome=exhausted}")
params.register("recovery_dtd_skip", 1,
                "cross-rank skip agreement for multi-rank DTD pools "
                "(needs recovery_enable + recovery_minimal): survivors "
                "agree on the largest common skippable insert-stream "
                "prefix and the replay ghost-tracks it instead of "
                "re-executing; 0 keeps the always-full DTD replay.  "
                "Round timeouts ride recovery_agree_timeout_s")


class RecoveryUnsupported(RuntimeError):
    """A pool or collection cannot be recovered (no snapshot, no
    re-runnable source, unsupported pool type); the peer death then
    takes the containment path with this as context."""


# ---------------------------------------------------------------------------
# lineage planning (pure; unit-tested on hand-built DAGs)
# ---------------------------------------------------------------------------

class LineageRecord:
    """One completed task in a lineage log: the tile versions it read
    and the tile versions it produced (versions are per-tile monotone,
    the datum version-clock discipline).  ``rmap``/``wmap`` key the
    same pairs by FLOW NAME (minimal replay synthesizes per-flow
    deliveries from them); ``dests`` are the remote ranks this task's
    activations reached (the minimal-plan seeds); ``seq`` is the
    recording order — for DTD pools the insert-stream position rides
    in the key's tid, so the record doubles as insert-stream lineage."""

    __slots__ = ("key", "reads", "writes", "dests", "rmap", "wmap",
                 "seq")

    def __init__(self, key: Any,
                 reads: List[Tuple[Any, int]] = (),
                 writes: List[Tuple[Any, int]] = (),
                 dests=(), rmap: Optional[Dict] = None,
                 wmap: Optional[Dict] = None, seq: int = -1):
        self.key = key
        self.reads = list(reads)
        self.writes = list(writes)
        self.dests = frozenset(dests)
        self.rmap = dict(rmap or {})
        self.wmap = dict(wmap or {})
        self.seq = seq


class LineageLog:
    """Ring-bounded per-pool lineage (``Taskpool._lineage``): appended
    by worker threads at ``complete_execution`` (deque append + set add
    under the GIL — no lock round-trips beyond what termdet already
    takes), read by the recovery thread AFTER the run_epoch fence
    drained every in-flight body.  ``overflow`` latches once the ring
    or the completed-key set exceeds its cap: the recorded view is no
    longer complete, so the next restart takes the full-replay
    fallback instead of planning from a truncated log."""

    __slots__ = ("cap", "records", "completed", "overflow", "_sends",
                 "ckpt")

    def __init__(self, cap: int, ckpt=None):
        self.cap = max(16, int(cap))
        self.records: deque = deque(maxlen=self.cap)
        self.completed: set = set()
        self.overflow = False
        #: id(task) -> remote dests noted by flush_activations while
        #: the task's release path runs (same worker thread records)
        self._sends: Dict[int, set] = {}
        #: incremental checkpoint store (utils/checkpoint.py), shared
        #: across the context's pools; None = capture plane off
        self.ckpt = ckpt

    def note_send(self, task, ranks) -> None:
        s = self._sends.get(id(task))
        if s is None:
            self._sends[id(task)] = s = set()
        s.update(ranks)

    def snap_reads(self, task) -> Dict[str, Tuple[Any, int]]:
        """Per-flow (tile, version) of every collection-backed input —
        taken BEFORE complete_write bumps the clocks, so an RW flow
        records the version the body actually consumed."""
        rmap: Dict[str, Tuple[Any, int]] = {}
        for flow in task.task_class._in_flows:
            copy = task.data.get(flow.name)
            if copy is None:
                continue
            d = copy.data
            if d is not None and d.collection is not None:
                rmap[flow.name] = (d.key, copy.version)
        return rmap

    def record(self, task, rmap) -> None:
        wmap: Dict[str, Tuple[Any, int]] = {}
        for flow in task.task_class._write_flows:
            copy = task.data.get(flow.name)
            if copy is None or copy.data is None:
                continue
            d = copy.data
            if d.collection is None:
                continue   # arena/NEW temporaries are not tile lineage
            ver = d.newest_version()
            wmap[flow.name] = (d.key, ver)
            ckpt = self.ckpt
            if ckpt is not None:
                host = d.copy_on(0)
                if host is not None and host.payload is not None \
                        and host.version == ver:
                    # captures key by (collection identity, tile): a
                    # later job's same-NAMED collection must never be
                    # served this job's bytes as a replay cut
                    ckpt.note_write((id(d.collection), d.key), ver,
                                    host.payload)
        dests = self._sends.pop(id(task), None)
        if len(self.completed) >= self.cap or \
                len(self.records) >= self.cap:
            self.overflow = True   # a truncated log cannot plan
            return
        self.completed.add(task.key)
        self.records.append(LineageRecord(
            task.key, reads=list((rmap or {}).values()),
            writes=list(wmap.values()), dests=dests or (),
            rmap=rmap, wmap=wmap, seq=task.seq))
        if len(self.records) < len(self.completed):
            # two workers raced the cap guard and the bounded deque
            # silently evicted a record: the log is incomplete — latch,
            # or the planner would trust a truncated view
            self.overflow = True

    def clear(self) -> None:
        self.records.clear()
        self.completed.clear()
        self._sends.clear()
        self.overflow = False


def lineage_plan(log: List[LineageRecord],
                 surviving: Dict[Any, int],
                 needed: Dict[Any, int]):
    """The minimal re-execution set: walk backward from the ``needed``
    (tile -> version) outputs to the last surviving version of every
    input.

    ``surviving`` maps tile -> highest version still materialized on a
    live rank (registration snapshots are version 0 of every tile).  A
    needed (tile, version) with ``surviving[tile] >= version`` costs
    nothing; otherwise its producer joins the plan and that producer's
    reads become needed.  Returns ``(tasks, base)``: the re-execution
    set in log (= valid topological) order, and the {tile: version}
    frontier the restore must materialize before replay starts.
    """
    producer: Dict[Tuple[Any, int], int] = {}
    for i, rec in enumerate(log):
        for tile, ver in rec.writes:
            producer[(tile, ver)] = i
    chosen: set = set()
    base: Dict[Any, int] = {}
    work = deque((t, v) for t, v in needed.items())
    seen: set = set()
    while work:
        tile, ver = work.popleft()
        if (tile, ver) in seen:
            continue
        seen.add((tile, ver))
        if surviving.get(tile, -1) >= ver:
            base[tile] = max(base.get(tile, -1), min(ver,
                                                     surviving[tile]))
            continue
        idx = producer.get((tile, ver))
        if idx is None:
            raise RecoveryUnsupported(
                f"lineage broken: no producer and no surviving copy of "
                f"{tile!r} v{ver}")
        if idx in chosen:
            continue
        chosen.add(idx)
        for r in log[idx].reads:
            work.append(r)
    return [log[i].key for i in sorted(chosen)], base


class ReplayPlan:
    """Output of :func:`minimal_plan`: the re-execution set, the tile
    versions the restore must rewind to, the deliveries to synthesize
    for edges whose producer is skipped, and the cross-survivor
    re-feed needs to negotiate."""

    __slots__ = ("tasks", "base", "synth", "needs")

    def __init__(self):
        self.tasks: set = set()
        #: tile -> version the restore rewinds it to (desc-read cuts)
        self.base: Dict[Any, int] = {}
        #: (consumer_key, consumer_flow, tile|None, version, producer_key)
        self.synth: List[Tuple] = []
        #: (peer_rank, consumer_key, consumer_flow)
        self.needs: List[Tuple[int, Any, str]] = []


def minimal_plan(records, *, dead_set, pending=(), adopted=(),
                 live=None, materializable=None, edges=None,
                 extra_seeds=()) -> ReplayPlan:
    """The recorded-lineage minimal re-execution set for ONE rank.

    Starts from the lost work — the whole adopted dead partition (its
    log died with it), the local not-yet-completed tasks, and every
    recorded task whose activations reached a dead rank (``dests`` —
    the dead partition's replay must be re-fed) — then walks the
    RECORDED edges backward: a task-fed input whose (tile, version) is
    still materializable (live-intact, checkpointed, or snapshotted —
    the replay cut) becomes a synthesized delivery; otherwise its
    recorded producer joins the set.  Soundness against in-place tile
    mutation: a re-run writer that would regress a tile below its live
    version pulls every recorded LATER writer in (their re-executed
    writebacks reproduce the final state), and a collection-direct
    (desc) read rewinds its tile to the pool-attach snapshot version.
    Cross-survivor edges become ``needs`` the caller negotiates.

    ``edges(key)`` yields the structural task-fed/desc input edges of
    one task (the coordinator derives them from the task classes; unit
    tests pass a dict lookup):

    * ``("task", producer_key, producer_flow, consumer_flow, where,
      is_ctl)`` with ``where`` in ``"local"`` / ``"dead"`` /
      ``("peer", rank)``
    * ``("desc", tile, snapshot_version)``

    Raises :class:`RecoveryUnsupported` when the recorded view cannot
    prove the plan sound (evicted producer record, unrecorded later
    writer, no exact-version cut) — the caller then takes the full
    restore-point replay.
    """
    live = dict(live or {})
    mat = {t: set(v) for t, v in (materializable or {}).items()}
    by_key = {r.key: r for r in records}
    writers: Dict[Any, List[Tuple[int, Any]]] = {}
    for r in records:
        for t, v in r.writes:
            writers.setdefault(t, []).append((v, r.key))
    for lst in writers.values():
        lst.sort(key=lambda p: p[0])

    plan = ReplayPlan()
    work: deque = deque()

    def join(key):
        if key not in plan.tasks:
            plan.tasks.add(key)
            work.append(key)

    for k in pending:
        join(k)
    for k in adopted:
        join(k)
    for k in extra_seeds:
        join(k)
    for r in records:
        if r.dests & dead_set:
            join(r.key)

    def usable(tile, ver) -> bool:
        return ver == live.get(tile) or ver in mat.get(tile, ())

    def join_later_writers(tile, after: int) -> None:
        """The tile's content will regress below its live version:
        every recorded later writer re-runs so the re-executed
        writeback chain reproduces the final state."""
        lst = writers.get(tile, ())
        lv = live.get(tile)
        if lv is not None and lv > after:
            covered = max((v for v, _k in lst), default=-1)
            if covered < lv:
                raise RecoveryUnsupported(
                    f"minimal replay: the writer of {tile!r} v{lv} is "
                    "not in the recorded lineage")
        for v, k in lst:
            if v > after:
                join(k)

    synth_seen: set = set()
    while work:
        key = work.popleft()
        rec = by_key.get(key)
        if rec is not None:
            for tile, ver in rec.writes:
                if live.get(tile, ver) > ver:
                    join_later_writers(tile, ver)
        if edges is None:
            continue
        for edge in edges(key):
            if edge[0] == "desc":
                _kind, tile, snap_ver = edge
                lv = live.get(tile)
                if lv is None:
                    continue   # tile not materialized here (external)
                if snap_ver is None:
                    raise RecoveryUnsupported(
                        f"minimal replay: no snapshot version for a "
                        f"desc read of {tile!r} (recovery_snapshot=0?)")
                if lv != snap_ver:
                    if snap_ver not in mat.get(tile, ()):
                        raise RecoveryUnsupported(
                            f"minimal replay: desc read of {tile!r} "
                            f"needs v{snap_ver}, which is not "
                            "materializable")
                    prev = plan.base.get(tile)
                    if prev is None or snap_ver < prev:
                        plan.base[tile] = snap_ver
                    join_later_writers(tile, snap_ver)
                continue
            _kind, pkey, pflow, cflow, where, ctl = edge
            if where == "dead":
                continue   # re-fed by the dead partition's replay
            if isinstance(where, tuple):
                plan.needs.append((where[1], key, cflow))
                continue
            if pkey in plan.tasks:
                continue   # natural re-delivery
            prec = by_key.get(pkey)
            if prec is None:
                # no record and not pending/planned: the ring evicted
                # the producer — the recorded view is incomplete
                raise RecoveryUnsupported(
                    f"minimal replay: producer {pkey!r} of {key!r} has "
                    "no lineage record (ring evicted?)")
            sk = (key, cflow, pkey)
            if ctl:
                if sk not in synth_seen:
                    synth_seen.add(sk)
                    plan.synth.append((key, cflow, None, 0, pkey))
                continue
            crec = by_key.get(key)
            tv = crec.rmap.get(cflow) if crec is not None else None
            if tv is None:
                tv = prec.wmap.get(pflow)
            if tv is not None and usable(*tv):
                if sk not in synth_seen:
                    synth_seen.add(sk)
                    plan.synth.append((key, cflow, tv[0], tv[1], pkey))
                continue
            join(pkey)

    # a producer that joined AFTER one of its edges chose synthesis
    # now re-delivers naturally: drop the synth twin or the consumer's
    # arrival count overshoots
    plan.synth = [s for s in plan.synth if s[4] not in plan.tasks]
    return plan


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------

def dtd_skip_prefix(frontiers: Dict[int, int],
                    landed: Dict[int, Dict[Any, int]],
                    writes) -> Tuple[int, Dict[Any, int], Dict[Any, int]]:
    """The largest common skippable DTD insert-stream prefix (pure;
    unit-tested on hand-built ladders).

    ``frontiers[rank]`` is each survivor's completion frontier (every
    LOCAL insert position below it completed); ``landed[rank][wire]``
    the whole-covering version whose bytes that rank's datum holds;
    ``writes`` the SPMD-identical ``(pos, wire)`` write ladder (the
    coordinator uses its own — the streams are identical by the DTD
    contract).

    A prefix ``K`` is honorable when, for every tile, the version the
    skipped prefix leaves it at (``vcut`` = number of writes below K)
    is HELD by some survivor (``landed == vcut``) — that rank becomes
    the tile's designated holder, serving the cut value in place of
    the skipped producers' deliveries.  Tiles the prefix never writes
    (``vcut == 0``) restore from the pool-attach snapshot / init_fn
    instead.  Returns ``(K, holders, vcut)``; ``K == 0`` means no
    common prefix is consistent with the survivors' materializable
    cuts and the gang takes the full replay."""
    from bisect import bisect_left
    if not frontiers:
        return 0, {}, {}
    top = min(frontiers.values())
    if top <= 0:
        return 0, {}, {}
    by_tile: Dict[Any, List[int]] = {}
    for pos, wire in writes:
        by_tile.setdefault(wire, []).append(pos)
    for lst in by_tile.values():
        lst.sort()
    ranks = sorted(landed)
    # feasibility only changes where a write enters/leaves the prefix,
    # so only the CLASS MAXIMA need testing: the frontier itself plus
    # each write position below it (any feasible K shares its class
    # maximum's vcuts, so the largest feasible K is always one of
    # these).  Bounds the scan by the write-ladder size (itself capped
    # by the lineage ring) instead of the raw insert count.
    cands = [top] + sorted({p for p, _w in writes if 0 < p < top},
                           reverse=True)
    for k in cands:
        holders: Dict[Any, int] = {}
        vcuts: Dict[Any, int] = {}
        ok = True
        for wire, poss in by_tile.items():
            vcut = bisect_left(poss, k)   # writes at positions < k
            if vcut == 0:
                continue
            holder = next((r for r in ranks
                           if landed[r].get(wire, 0) == vcut), None)
            if holder is None:
                ok = False
                break
            holders[wire] = holder
            vcuts[wire] = vcut
        if ok:
            return k, holders, vcuts
    return 0, {}, {}


class RecoveryCoordinator:
    """Per-context recovery coordinator (``Context.recovery``).

    Containment hands it peer deaths on the comm thread
    (``on_peer_dead``); the actual restart work runs on a dedicated
    recovery thread so the transport loop keeps beating hearts while
    tiles restore.  All mutable state is guarded by ``_lock``; the
    restart pipeline itself is serialized by the single worker thread.
    """

    def __init__(self, context):
        self.context = context
        self.enabled = True
        self.max_attempts = int(params.get("recovery_max_attempts", 2))
        self.snapshot_on = bool(int(params.get("recovery_snapshot", 1)))
        self.drain_s = float(params.get("recovery_drain_s", 10.0))
        self.completed_grace = float(
            params.get("recovery_completed_grace_s", 30.0))
        self.lineage_on = bool(int(params.get("recovery_lineage", 1)))
        self.lineage_cap = int(params.get("recovery_lineage_ring", 8192))
        self.minimal_on = bool(int(params.get("recovery_minimal", 1)))
        self.agree_window = float(
            params.get("recovery_agree_window_s", 0.25))
        self.agree_timeout = float(
            params.get("recovery_agree_timeout_s", 3.0))
        self.need_rounds_cap = int(params.get("recovery_need_rounds", 2))
        self.dtd_skip_on = bool(int(params.get("recovery_dtd_skip", 1)))
        #: incremental tile checkpoint store (utils/checkpoint.py),
        #: shared by every registered pool's lineage hook; None = the
        #: capture plane is off (interval 0, the default)
        self.ckpt = None
        ck_interval = float(
            params.get("recovery_checkpoint_interval_s", 0.0))
        if ck_interval > 0:
            from parsec_tpu_torch.utils.checkpoint import TileCheckpointStore
            self.ckpt = TileCheckpointStore(
                ck_interval,
                int(params.get("recovery_checkpoint_keep", 2)))
        self._lock = threading.Lock()
        #: TAG_RECOVER control-lane state: dead-set agreement reports/
        #: confirmations and minimal-replay need bookkeeping
        #: (guarded-by: _ctl_cond)
        self._ctl_cond = threading.Condition()
        self._agree_reports: Dict[int, set] = {}
        self._agree_confirmed: set = set()
        #: taskpool_id -> "open" | "frozen" | "full" (minimal-replay
        #: plan lifecycle; a need arriving on a frozen plan nacks)
        self._plan_state: Dict[int, str] = {}
        #: taskpool_id -> producer keys peers asked this rank to
        #: include in its replay set
        self._extra_seeds: Dict[int, set] = {}
        #: (taskpool_id, peer) -> ack verdict of our need request
        self._need_acks: Dict[Tuple[int, int], bool] = {}
        #: (taskpool_id, rank) -> (round, report) — DTD skip-agreement
        #: frontier/landed reports collected by the coordinator
        #: (guarded-by: _ctl_cond)
        self._skip_reports: Dict[Tuple[int, int], Tuple[int, dict]] = {}
        #: taskpool_id -> (round, skipset msg) — the coordinator's
        #: agreed-prefix broadcast (guarded-by: _ctl_cond)
        self._skip_set: Dict[int, Tuple[int, dict]] = {}
        #: (taskpool_id, peer) -> (round, mode) — the mode-agreement
        #: votes, stamped with the voter's restart-attempt round so a
        #: stale round's ballot can never satisfy (or poison) the
        #: current agreement
        self._peer_modes: Dict[Tuple[int, int], Tuple[int, str]] = {}
        #: taskpool_id -> (round, mode) this rank itself declared —
        #: replayed to late voters so an early committer's exit from
        #: the agreement wait cannot strand them into a timeout
        self._my_mode: Dict[int, Tuple[int, str]] = {}
        #: taskpool_id -> ranks that reported LOCAL completion — the
        #: retirement handshake's quorum; when every live rank is in,
        #: the coordinator broadcasts the retirement and the pool
        #: leaves restartable state (guarded-by: _ctl_cond)
        self._retire_reports: Dict[int, set] = {}
        #: taskpool_id -> this rank's FROZEN minimal replay set — a
        #: second-round need arriving against a frozen plan acks iff
        #: its resolved producers are already IN the set (no plan
        #: change needed), instead of an unconditional nack
        #: (guarded-by: _ctl_cond)
        self._frozen_tasks: Dict[int, set] = {}
        self._rde = None               # RemoteDepEngine (attach_comm)
        #: taskpool_id -> {"tp", "collections", "replay", "completed_at"}
        #: (guarded-by: _lock)
        self._specs: Dict[int, Dict[str, Any]] = {}
        #: collection snapshots: id(dc) -> {idx: (version, host tensor)}
        #: (guarded-by: _lock)
        self._snaps: Dict[int, Dict[Tuple, Tuple[int, torch.Tensor]]] = {}
        self._snap_dcs: Dict[int, Any] = {}      # keep dc alive w/ snap
        self._attempts: Dict[int, int] = {}      # guarded-by: _lock
        self._active: set = set()                # guarded-by: _lock
        self._events: deque = deque()            # guarded-by: _lock
        self._worker: Optional[threading.Thread] = None  # guarded-by: _lock
        #: dead rank -> adopting survivor, cluster-wide view
        #: (guarded-by: _lock)
        self._dead_map: Dict[int, int] = {}
        #: deaths accepted but not yet processed by the recovery thread
        #: — excused() must cover them, or the window between
        #: on_peer_dead and _process_event routes secondary send
        #: failures into containment and fails the very pool being
        #: rebuilt (guarded-by: _lock)
        self._pending_dead: set = set()
        self._translated: List[Any] = []         # guarded-by: _lock
        #: rejoined incarnation epochs (guarded-by: _lock)
        self._peer_epochs: Dict[int, int] = {}
        #: rejoins that landed while a restart was active: their
        #: translation entries clear once the restart pipeline drains
        #: (guarded-by: _lock)
        self._pending_untranslate: set = set()
        self._services: List[Any] = []           # guarded-by: _lock
        # observability (metrics plane reads these at scrape; the
        # counters move only on the recovery/comm threads)
        self.counts = {"started": 0, "completed": 0, "failed": 0}
        self.tasks_reexecuted = 0
        self.rejoins = 0
        #: restart-policy split: minimal (recorded-lineage plan OR an
        #: agreed DTD skip prefix) vs full (replay-from-restore-point
        #: fallback) pool restarts
        self.minimal_replays = 0
        self.full_replays = 0
        #: concluded DTD skip agreements (a nonzero prefix agreed AND
        #: committed through the mode round)
        self.skip_agreements = 0
        #: completed pools retired through the explicit handshake
        #: (coordinator confirmed every live rank locally complete)
        self.retirements = 0
        #: restored tiles by source: the registration snapshot or the
        #: collection's re-runnable source (init_fn)
        self.restored_tiles = {"snapshot": 0, "init": 0}
        #: pools whose retirement handshake never concluded and whose
        #: restartable state fell back to the grace-window eviction
        #: (coordinator died mid-handshake, lost report); journaled as
        #: retire_degraded
        self.retire_degraded = 0
        #: pools whose "retired" journal event already emitted (the
        #: auditor's exactly-one-retirement-outcome invariant; the
        #: handshake can apply twice when Context.wait's quiescence
        #: retire races the coordinator broadcast) guarded-by: _lock
        self._retired_emitted: set = set()
        #: need-negotiation rounds by outcome (acked / nacked /
        #: widened / exhausted) — a silent round is a failed gate
        self.need_round_counts = {"acked": 0, "nacked": 0,
                                  "widened": 0, "exhausted": 0}
        from parsec_tpu_torch.prof.metrics import Histogram
        self.duration_hist = Histogram()
        m = getattr(context, "metrics", None)
        if m is not None:
            m.register_collector(self._collect)

    # -- wiring ----------------------------------------------------------
    def attach_comm(self, rde) -> None:
        """Called by RemoteDepEngine at construction: wire the rejoin
        handshake and let the transport accept reconnections from dead
        ranks (the recovery knob gates it)."""
        self._rde = rde
        rde.ce.on_recover = self._on_recover_msg
        if int(params.get("recovery_rejoin", 1)):
            rde.ce.rejoin_allowed = True
            rde.ce.on_rejoin = self.on_rejoin_request

    def attach_service(self, service) -> None:
        with self._lock:
            self._services.append(service)

    def detach_service(self, service) -> None:
        with self._lock:
            if service in self._services:
                self._services.remove(service)

    def _notify_services(self, event: str, rank: int) -> None:
        with self._lock:
            services = list(self._services)
        for svc in services:
            try:
                svc.note_recovery(event, rank)
            except Exception as exc:
                debug_verbose(2, "recovery service notify: %s", exc)

    # -- registration ----------------------------------------------------
    def register_pool(self, tp: Taskpool) -> None:
        """Record a pool's recovery spec at attach and snapshot its
        collections' local tiles — the lineage restore point.  A pool
        without collections stays on the containment path."""
        collections = list(getattr(tp, "recovery_collections", ()) or ())
        spec = {"tp": tp, "collections": collections,
                "replay": getattr(tp, "recovery_replay", None),
                "completed_at": None}
        if collections:
            tp.on_complete(self._pool_done)
            if self.lineage_on:
                # arm the recorded lineage ring (the minimal-replay
                # evidence; complete_execution's hook is a None check
                # for every unregistered pool)
                tp._lineage = LineageLog(self.lineage_cap,
                                         ckpt=self.ckpt)
        snaps = []
        if collections and self.snapshot_on:
            for dc in collections:
                if not hasattr(dc, "local_tiles"):
                    continue
                #: idx -> (version at snapshot, host copy) — the
                #: version stamp names this cut in the lineage planner
                snap: Dict[Tuple, Tuple[int, torch.Tensor]] = {}
                try:
                    for idx in dc.local_tiles():
                        idx = tuple(idx) if isinstance(idx, (tuple, list)) \
                            else (idx,)
                        datum = dc.data_of(*idx)
                        copy = datum.pull_to_host()
                        if copy is not None and copy.payload is not None:
                            snap[idx] = (datum.newest_version(),
                                         to_host(copy.payload).clone())
                except Exception as exc:
                    warning("recovery: snapshot of %s failed (%s); "
                            "relying on init_fn", dc.name, exc)
                    snap = {}
                snaps.append((dc, snap))
        with self._lock:
            self._specs[tp.taskpool_id] = spec
            for dc, snap in snaps:
                # latest registration wins: for sequential pools over
                # one collection the snapshot must reflect the state at
                # THIS pool's attach (its replay base), not the first's
                self._snaps[id(dc)] = snap
                self._snap_dcs[id(dc)] = dc
            self._sweep_locked()

    def _pool_done(self, tp) -> None:
        """Completion callback: stamp the grace-window clock (a restart
        re-stamps it on re-termination) and start the RETIREMENT
        HANDSHAKE — report this rank's local completion to the
        coordinator, which confirms global quiescence (every live rank
        locally complete) before the pool leaves restartable state.
        The ``recovery_completed_grace_s`` window remains the bounded
        FALLBACK (dead coordinator, lost report): past it the spec
        evicts exactly as before."""
        with self._lock:
            spec = self._specs.get(tp.taskpool_id)
            if spec is not None:
                spec["completed_at"] = time.monotonic()
        if spec is None:
            return
        self._report_retire(tp)

    def _report_retire(self, tp) -> None:
        """Send (or locally record) this rank's local-completion report
        for one pool; called from the completion callback (worker
        thread) — never holds _lock across the send."""
        rde = self._rde
        ce = rde.ce if rde is not None else None
        if ce is None or ce.nranks <= 1:
            # single-rank context: local completion IS global
            self._apply_retired(tp.taskpool_id)
            return
        coord = rde.recovery_coordinator()
        jr = self.context.journal
        if jr is not None:
            jr.emit("retire_report", pool=tp.taskpool_id, coord=coord)
        if coord == ce.rank:
            self._note_retire_report(tp.taskpool_id, ce.rank)
            return
        from parsec_tpu_torch.comm.engine import TAG_RECOVER
        try:
            ce.send_am(TAG_RECOVER, coord,
                       {"k": "retire", "tp": tp.taskpool_id})
        except OSError:
            pass   # grace-window fallback bounds the miss

    def _note_retire_report(self, tpid: int, src: int) -> None:
        """Coordinator side: record one rank's local completion and,
        once EVERY live rank reported, broadcast the confirmed
        retirement.  Quorum membership is evaluated at report time —
        a rank dying mid-handshake shrinks the live set and its
        restart path clears the report state for replayed pools."""
        rde = self._rde
        ce = rde.ce if rde is not None else None
        if ce is None:
            return
        jr = self.context.journal
        if jr is not None:
            jr.emit("retire_recv", pool=tpid, src=src)
        with self._ctl_cond:
            reported = self._retire_reports.setdefault(tpid, set())
            reported.add(src)
            live = {r for r in range(ce.nranks)
                    if r not in ce.dead_peers}
            done = live <= reported
        if not done:
            return
        with self._lock:
            if tpid in self._active or self._events:
                return   # a restart owns this pool; quorum re-collects
        from parsec_tpu_torch.comm.engine import TAG_RECOVER
        for r in sorted(live - {ce.rank}):
            try:
                ce.send_am(TAG_RECOVER, r, {"k": "retired", "tp": tpid})
            except OSError:
                pass
        self._apply_retired(tpid)

    def _apply_retired(self, tpid: int) -> None:
        """Confirmed-retirement landing (both sides of the handshake):
        the pool is GLOBALLY done — it leaves restartable state now
        instead of dangling through the grace window, and a later peer
        death can never resurrect it (or re-fire its completion into
        the job service)."""
        emit = False
        with self._lock:
            spec = self._specs.get(tpid)
            tp = spec["tp"] if spec is not None else None
            if tp is None or tpid in self._active or not tp.completed:
                return
            tp.retired = True
            self.retirements += 1
            if tpid not in self._retired_emitted:
                # exactly ONE retirement-outcome journal event per pool
                # per rank — the auditor's invariant; a second apply
                # (quiescence-retire racing the broadcast) is absorbed
                self._retired_emitted.add(tpid)
                emit = True
        if emit:
            jr = self.context.journal
            if jr is not None:
                jr.emit("retired", pool=tpid)
            # no synchronous sweep: the retired flag already ends
            # restartability (on_peer_dead skips retired pools), and
            # the spec/snapshot/capture eviction rides the normal
            # sweep cadence (next registration / grace) so late
            # readers of the capture plane are not cut off mid-read
        debug_verbose(2, "rank %d: pool %d RETIRED (global quiescence "
                      "confirmed)", self.context.rank, tpid)

    def _sweep_locked(self) -> None:   # holds-lock: _lock
        """Evict specs (and the tile snapshots only they referenced) of
        pools that retired, were cancelled, or completed past the grace
        window — a resident service must not accumulate O(jobs served)
        pool objects and snapshot bytes, nor resurrect ancient jobs on
        a peer death.  Caller holds _lock."""
        now = time.monotonic()
        evicted: List[int] = []
        evicted_dcs: set = set()
        for tpid in list(self._specs):
            spec = self._specs[tpid]
            tp = spec["tp"]
            done_at = spec["completed_at"]
            stale = (getattr(tp, "retired", False) or tp.cancelled
                     or (done_at is not None
                         and now - done_at > self.completed_grace))
            if stale and tpid not in self._active:
                del self._specs[tpid]
                self._attempts.pop(tpid, None)
                evicted.append(tpid)
                evicted_dcs.update(id(dc) for dc in spec["collections"])
                if done_at is not None and not tp.cancelled \
                        and not getattr(tp, "retired", False):
                    # the pool completed but its retirement handshake
                    # never concluded (coordinator died mid-handshake,
                    # lost report) and no quiescence round retired it:
                    # the grace-window degradation, counted and
                    # journaled instead of silent
                    self.retire_degraded += 1
                    jr = self.context.journal
                    if jr is not None:
                        jr.emit("retire_degraded", pool=tpid)
        if evicted:
            # the TAG_RECOVER control state retires with the spec — a
            # resident service must not accumulate per-restart entries
            # (safe nesting: _ctl_cond is never held while taking _lock)
            self._retired_emitted.difference_update(evicted)
            with self._ctl_cond:
                for tpid in evicted:
                    self._plan_state.pop(tpid, None)
                    self._extra_seeds.pop(tpid, None)
                    self._skip_set.pop(tpid, None)
                    self._retire_reports.pop(tpid, None)
                    self._frozen_tasks.pop(tpid, None)
                    for kk in [kk for kk in self._need_acks
                               if kk[0] == tpid]:
                        del self._need_acks[kk]
                    for kk in [kk for kk in self._peer_modes
                               if kk[0] == tpid]:
                        del self._peer_modes[kk]
                    for kk in [kk for kk in self._skip_reports
                               if kk[0] == tpid]:
                        del self._skip_reports[kk]
        live_dcs = {id(dc) for spec in self._specs.values()
                    for dc in spec["collections"]}
        for key in [k for k in self._snaps if k not in live_dcs]:
            self._snaps.pop(key, None)
            self._snap_dcs.pop(key, None)
        if self.ckpt is not None:
            # the incremental captures retire WITH the spec — keyed on
            # the EVICTED specs' collections, not on _snaps, so the
            # recovery_snapshot=0 configuration still evicts: a
            # resident service must not accumulate captures, and a
            # gc-recycled collection identity must start clean
            for key in evicted_dcs - live_dcs:
                self.ckpt.drop_owner(key)

    # -- containment hand-off (comm thread; must not block) --------------
    def on_peer_dead(self, rank: int, exc: Exception,
                     pools: List[Taskpool]):
        """Decide, per pool, recovery vs containment.  Returns
        ``(handled, leftover)``: ``handled`` True when this death is
        excused (the service degrades-but-survives even with zero
        affected pools); ``leftover`` are pools recovery will NOT take
        — the caller contains them as before."""
        ce = self._rde.ce if self._rde is not None else None
        if not self.enabled or ce is None \
                or getattr(ce, "fault_killed", False) \
                or rank == self.context.rank:
            return False, pools
        take: List[Taskpool] = []
        leave: List[Taskpool] = []
        touching = {tp.taskpool_id for tp in pools}
        # the services hear the start BEFORE the event is queued: the
        # recovery thread may finish it (and report "done") before this
        # comm thread got past the queueing, and a "start" arriving after
        # its "done" would leave the rank degraded for good (a deliberate
        # difference: the JAX package notifies at the end of this method)
        self._notify_services("start", rank)
        with self._lock:
            # the restart set is GANG-WIDE per pool, not per-traffic:
            # the re-executed DAG is global, so every survivor must
            # restart a pool whose collections span the dead rank even
            # if ITS partition never exchanged a frame with it — a
            # survivor left on the old generation would park the new
            # generation's activations forever.  Registered pools whose
            # collections cannot contain the dead rank are genuinely
            # unaffected and stay untouched.
            candidates = list(pools)
            for spec in self._specs.values():
                tp = spec["tp"]
                # completed-but-not-RETIRED pools are candidates too:
                # local completion is not global completion, and a
                # survivor whose partition drained early must still
                # restart so the adopter's re-executed activations have
                # somewhere to land (retired = a quiescence round
                # proved the whole gang done; never resurrected)
                if tp.taskpool_id in touching \
                        or getattr(tp, "retired", False) \
                        or tp.cancelled or not spec["collections"]:
                    continue
                if tp.completed:
                    # locally complete: restartable only within the
                    # grace window — past it the gang has long since
                    # quiesced and a resident service's history must
                    # never be resurrected
                    done_at = spec["completed_at"]
                    if done_at is None or \
                            time.monotonic() - done_at \
                            > self.completed_grace:
                        continue
                if any(getattr(dc, "nodes", 1) > rank
                       for dc in spec["collections"]):
                    candidates.append(tp)
            for tp in candidates:
                spec = self._specs.get(tp.taskpool_id)
                # insert-driven pools (anything that is not a
                # parameterized enumeration) NEED a replay callable: a
                # base startup() re-enumerates nothing, and a restart
                # would restore the tiles, re-execute zero tasks, and
                # "complete" with silently reverted data
                replayable = spec is not None and (
                    spec["replay"] is not None
                    or isinstance(tp, ParameterizedTaskpool))
                # DynamicTaskpool pools (incl. distributed ones holding
                # a _dyn_hold) recover too: startup() re-seeds the
                # discovery roots and _restart_pool re-arms the hold
                ok = (spec is not None and spec["collections"]
                      and replayable
                      and not tp.cancelled
                      and not getattr(tp, "retired", False)
                      and not getattr(tp, "_compound_member", False)
                      and hasattr(tp.termdet, "taskpool_reset")
                      and self._attempts.get(tp.taskpool_id, 0)
                      < self.max_attempts)
                if ok:
                    self._attempts[tp.taskpool_id] = \
                        self._attempts.get(tp.taskpool_id, 0) + 1
                    self._active.add(tp.taskpool_id)
                    take.append(tp)
                elif tp.taskpool_id in touching:
                    leave.append(tp)   # containment, exactly as before
            self._events.append((rank, exc, take))
            self._pending_dead.add(rank)
            worker = self._worker
            if worker is None or not worker.is_alive():
                worker = threading.Thread(target=self._run,
                                          name="parsec-recovery",
                                          daemon=True)
                self._worker = worker
                worker.start()
        with self._ctl_cond:
            # a PREVIOUS restart left this pool's plan state "frozen":
            # reset it the moment the death is accepted, or a faster
            # peer's re-feed needs for THIS event get spuriously
            # nacked against the stale state (silently degrading every
            # death after the first to full replay).  Seeds promised
            # in an earlier event whose restart took the full path
            # (never popped) must not leak into this event's plan
            # either — a full replay honored them by re-running
            # everything
            for tp_ in take:
                tpid_ = tp_.taskpool_id
                self._plan_state.pop(tpid_, None)
                self._extra_seeds.pop(tpid_, None)
                self._frozen_tasks.pop(tpid_, None)
                # the restarted pool's retirement quorum re-collects
                # from its re-completions (stale reports must not
                # retire a pool a survivor is still replaying).  Skip
                # reports/broadcasts are NOT purged: like the mode
                # ballots they carry the restart-attempt round and
                # _plan_dtd_skip matches rounds — purging would delete
                # a FASTER peer's current-round report (a hang-detected
                # death lets peers report before we even declare) and
                # force a spurious full-replay fallback
                self._retire_reports.pop(tpid_, None)
        # excuse SYNCHRONOUSLY, on the declaring thread: a survivor
        # polling wait_quiescence every 50 ms must never observe
        # dead-but-not-yet-excused in the window before the recovery
        # worker gets scheduled (the fatal check would fail a run the
        # recovery is about to save); _process_event's excusal is then
        # a harmless repeat
        ce.excuse_peer(rank)
        self.counts["started"] += 1
        jr = self.context.journal
        if jr is not None:
            jr.emit("recovery_start", peer=rank,
                    pools=[tp.taskpool_id for tp in take],
                    contained=[tp.taskpool_id for tp in leave])
        self.context.telemetry_incident(
            f"recovery-start rank={rank} pools="
            f"{[tp.taskpool_id for tp in take]}")
        warning("rank %d: RECOVERY engaged for dead rank %d (%d pool(s) "
                "re-executing, %d contained)", self.context.rank, rank,
                len(take), len(leave))
        return True, leave

    def busy(self) -> bool:
        """A death was accepted, an event is queued, or a restart is
        mid-flight.  Global-quiescence deciders (Safra ring idle
        predicates, the sole-survivor short-circuits) consult this:
        declaring the gang done over a pool a queued restart is about
        to rewind would hand Context.wait back to the application
        while the restore overwrites the very tiles it then reads —
        the completed-pool-grace race."""
        with self._lock:
            return bool(self._events or self._active
                        or self._pending_dead)

    def recovering(self, tp) -> bool:
        """Is a recovery restart pending/active for this pool?  The
        containment paths consult it to swallow secondary errors of the
        torn generation (dead-child sends, parked pulls) instead of
        failing a pool that is already being rebuilt."""
        with self._lock:
            return tp is not None and tp.taskpool_id in self._active

    def excused(self, rank: int) -> bool:
        with self._lock:
            return rank in self._dead_map or rank in self._pending_dead

    # -- the recovery thread ---------------------------------------------
    def _apply_untranslate(self) -> None:
        """Clear translation entries of ranks that rejoined while a
        restart was active, once the restart pipeline drained — a
        deferred clear nobody applies would leave the rejoined rank's
        partition re-mapped forever."""
        with self._lock:
            if self._active or self._events \
                    or not self._pending_untranslate:
                return
            pend = set(self._pending_untranslate)
            self._pending_untranslate.clear()
            translated = list(self._translated)
        for dc in translated:
            table = dict(dc._recovery_translate or {})
            for r in pend:
                table.pop(r, None)
            dc.set_rank_translation(table)

    def _run(self) -> None:
        while True:
            with self._lock:
                if not self._events:
                    # retire INSIDE the lock: on_peer_dead appends and
                    # checks worker liveness under the same lock, so an
                    # event can never strand between our empty-check
                    # and exit
                    self._worker = None
                    break
                rank, exc, pools = self._events.popleft()
            try:
                self._process_event(rank, exc, pools)
            except Exception as run_exc:   # the thread must drain events
                warning("rank %d: recovery event for rank %d failed: %s",
                        self.context.rank, rank, run_exc)
                self.counts["failed"] += 1
                with self._lock:
                    self._pending_dead.discard(rank)
                for tp in pools:
                    with self._lock:
                        self._active.discard(tp.taskpool_id)
                    self.context.record_pool_error(tp, exc)
                self._notify_services("failed", rank)
        self._apply_untranslate()

    def _process_event(self, rank: int, exc: Exception,
                       pools: List[Taskpool]) -> None:
        ctx, rde = self.context, self._rde
        ce = rde.ce
        t0 = time.monotonic()
        # 1. excuse + fence + Safra reconcile: from here, barriers and
        # quiescence run over the survivors, stale frames of the dead
        # incarnation are dropped before crediting, and the message
        # balance reflects live traffic only
        ce.excuse_peer(rank)
        rde.recovery_reconcile(rank)
        # AGREEMENT ROUND (TAG_RECOVER): converge the dead-set view
        # with the coordinator before any table is computed, so
        # near-simultaneous multi-deaths land every survivor on the
        # same set instead of transiently divergent ones (the round is
        # bounded — a dead coordinator degrades to the local view)
        observed = (set(ce.dead_peers) | {rank}) - {ce.rank}
        agreed = self._agree_dead_set(observed)
        # the translation recomputes WHOLESALE from the dead SET (not
        # incrementally from event order): two survivors detecting two
        # near-simultaneous deaths in opposite order must still land on
        # the same table, and a chained adopter death (1->2, then 2
        # dies) must collapse onto a live rank
        dead_set = (set(ce.dead_peers) | observed | agreed) - {ce.rank}
        survivors = sorted(r for r in range(ce.nranks)
                           if r not in dead_set)
        if not survivors:
            raise RecoveryUnsupported("no survivors")
        with self._lock:
            self._dead_map = {d: survivors[d % len(survivors)]
                              for d in dead_set}
            target = self._dead_map[rank]
            self._pending_dead.discard(rank)
        debug_verbose(1, "rank %d: recovery re-maps rank %d -> %d "
                      "(survivors %s)", ctx.rank, rank, target, survivors)
        ok = True
        for tp in pools:
            try:
                n = self._restart_pool(tp, rank, target)
                self.tasks_reexecuted += n
                debug_verbose(1, "rank %d: pool %d re-executes %d "
                              "task(s)", ctx.rank, tp.taskpool_id, n)
            except Exception as restart_exc:
                ok = False
                warning("rank %d: recovery of pool %d failed (%s); "
                        "containing", ctx.rank, tp.taskpool_id,
                        restart_exc)
                with self._lock:
                    self._active.discard(tp.taskpool_id)
                ctx.record_pool_error(tp, exc)
        # COORDINATOR SUCCESSION for the retirement handshake: a rank
        # dying mid-handshake (the coordinator with collected reports,
        # or a member that never reported) would silently degrade
        # retirement to the grace window — re-run the round over the
        # shrunken live set so it completes without degradation
        self._succeed_retirements(rank)
        dt = time.monotonic() - t0
        self.duration_hist.observe(dt)
        self.counts["completed" if ok else "failed"] += 1
        jr = ctx.journal
        if jr is not None:
            jr.emit("recovery_done", peer=rank, ok=ok,
                    duration_s=round(dt, 4))
        self._notify_services("done" if ok else "failed", rank)
        warning("rank %d: recovery for dead rank %d %s in %.2fs",
                ctx.rank, rank, "completed" if ok else "FAILED", dt)

    def _succeed_retirements(self, dead: int) -> None:
        """Retirement-handshake succession after a death: every
        survivor re-reports its locally-complete, unretired,
        not-restarting pools.  When the dead rank was the handshake
        coordinator (every coordinator is ``min(live)``, so ``dead <
        new coordinator`` identifies exactly that case) the NEW
        coordinator re-collects quorum from scratch — the old one took
        the collected reports down with it.  When a non-coordinator
        member died before reporting, the re-reports force the
        coordinator to re-evaluate quorum over the SHRUNKEN live set
        (report-time evaluation alone would wait for a report that can
        never come).  Idempotent on the collector side: a re-added
        report is a set re-add."""
        rde = self._rde
        ce = rde.ce if rde is not None else None
        if ce is None or ce.nranks <= 1:
            return
        coord = rde.recovery_coordinator()
        succession = dead < coord      # the dead rank WAS coordinator
        with self._lock:
            pools = [spec["tp"] for tpid, spec in self._specs.items()
                     if spec["completed_at"] is not None
                     and not getattr(spec["tp"], "retired", False)
                     and not spec["tp"].cancelled
                     and tpid not in self._active]
        jr = self.context.journal
        for tp in pools:
            if succession and jr is not None:
                jr.emit("retire_succession", pool=tp.taskpool_id,
                        coord=coord, dead=dead)
            self._report_retire(tp)

    def _restart_pool(self, tp: Taskpool, dead: int, target: int) -> int:
        """Rewind + restore + re-execute one pool.  Returns the local
        re-execution task count."""
        from parsec_tpu_torch.core import scheduling
        ctx, rde = self.context, self._rde
        with self._lock:
            spec = self._specs[tp.taskpool_id]
        if getattr(tp, "retired", False):
            # globally done (a quiescence round proved the whole gang
            # finished): nothing left to re-execute anywhere
            with self._lock:
                self._active.discard(tp.taskpool_id)
            return 0
        if spec["replay"] is not None:
            self._await_insert_stream(tp)
        # partition re-mapping on THIS pool's collections (plus the
        # pool-level table DTD integer affinities consult).  The
        # pre-restore window is TRANSACTIONAL: a failed pre-flight must
        # roll the tables back, or owner_of would keep routing the dead
        # partition here with no restored payloads — a later pool over
        # the same collection would then materialize zero-filled
        # adopted tiles and silently compute garbage
        with self._lock:
            dead_map = dict(self._dead_map)
        prev_tables = [(dc, dict(dc._recovery_translate)
                        if dc._recovery_translate else None)
                       for dc in spec["collections"]]
        for dc in spec["collections"]:
            # the FULL normalized map, not just this event's entry: a
            # chained adopter death re-targets earlier entries too
            table = dict(dc._recovery_translate or {})
            table.update(dead_map)
            dc.set_rank_translation(table)
            with self._lock:
                if dc not in self._translated:
                    self._translated.append(dc)
        tp.rank_translation = dead_map
        dead_set = set(dead_map)
        tpid = tp.taskpool_id
        # minimal replay applies to enumerable PTG pools with a
        # complete lineage ring; insert-driven DTD pools take the
        # SKIP-AGREEMENT path instead (ghost-replay the agreed
        # prefix); everything else (dynamic discovery, evicted/
        # disabled ring) takes the restore-point fallback
        want_minimal = (self.minimal_on and self.lineage_on
                        and spec["replay"] is None
                        and not getattr(tp, "dynamic", False)
                        and isinstance(tp, ParameterizedTaskpool)
                        and tp._lineage is not None
                        and not tp._lineage.overflow)
        want_skip = (self.minimal_on and self.lineage_on
                     and self.dtd_skip_on
                     and spec["replay"] is not None
                     and callable(getattr(tp, "dtd_skip_report", None))
                     and tp._lineage is not None
                     and not tp._lineage.overflow)
        with self._ctl_cond:
            # (stale votes need no purge here: ballots carry the
            # restart-attempt round, and _agree_mode matches rounds —
            # purging instead would delete a FASTER peer's
            # current-round vote and split the gang's modes)
            self._plan_state[tpid] = "open" if want_minimal else "full"
        if not want_minimal and not want_skip:
            self._broadcast_mode(tpid, False)
        fallback_reason = None
        if not want_minimal and not want_skip:
            fallback_reason = self._static_fallback_reason(tp, spec)
        rplan = synth = base_restores = None
        skip = None
        try:
            # pre-flight: every tile this rank now owns must have a
            # restore source — check BEFORE tearing runtime state down
            plan = self._restore_plan(spec)
            # park inbound activations (state < RUNNING), then fence
            # stale generations (run_epoch) and wait their bodies out
            tp.state = TaskpoolState.ATTACHED
            tp.run_epoch += 1
            jr = self.context.journal
            if jr is not None:
                jr.emit("epoch_fence", pool=tpid, epoch=tp.run_epoch,
                        dead=dead_set)
            # belt only: correctness rides on claim-before-fence-check
            # in task_progress (the drain observes every claimed body);
            # this just skips one drain poll for tasks popped right at
            # the bump
            time.sleep(0.02)
            self._drain_inflight(tp)
            # comm: drop the torn generation's parked/queued state
            rde.forget_pool(tp)
            if want_minimal:
                # the lineage is stable now (fence + drain): compute
                # the recorded minimal plan, negotiate cross-survivor
                # re-feeds, and capture every synthesis/rewind payload
                # BEFORE any tile is overwritten
                try:
                    rplan = self._plan_minimal(tp, spec, dead_set)
                    synth, base_restores = \
                        self._materialize_plan(tp, spec, rplan)
                    # MODE AGREEMENT: commit to minimal only when every
                    # live survivor voted minimal too — a full-replaying
                    # peer sends no re-feed needs, and skipping its
                    # producers would strand its re-enumeration forever
                    self._broadcast_mode(tpid, True)
                    if not self._agree_mode(tpid):
                        debug_verbose(1, "rank %d: pool %d minimal "
                                      "replay fell back (a peer took "
                                      "full replay)", ctx.rank, tpid)
                        fallback_reason = "mode-vote full (a peer " \
                                          "took full replay)"
                        rplan = None
                        with self._ctl_cond:
                            self._plan_state[tpid] = "full"
                        self._broadcast_mode(tpid, False)
                except RecoveryUnsupported as why:
                    debug_verbose(1, "rank %d: pool %d minimal replay "
                                  "fell back to restore-point (%s)",
                                  ctx.rank, tpid, why)
                    fallback_reason = str(why)
                    rplan = None
                    with self._ctl_cond:
                        self._plan_state[tpid] = "full"
                    self._broadcast_mode(tpid, False)
            if want_skip:
                # DTD insert-stream skip agreement: evidence is stable
                # now (fence + drain), and the torn generation's comm
                # state is gone — agree the skippable prefix BEFORE
                # the reset discards the landed/seed evidence
                try:
                    skip = self._plan_dtd_skip(tp, spec, dead_set)
                    self._broadcast_mode(tpid, True)
                    if not self._agree_mode(tpid):
                        debug_verbose(1, "rank %d: pool %d DTD skip "
                                      "fell back (skip-vote full on a "
                                      "peer)", ctx.rank, tpid)
                        fallback_reason = "skip-vote full"
                        skip = None
                        self._broadcast_mode(tpid, False)
                except RecoveryUnsupported as why:
                    debug_verbose(1, "rank %d: pool %d DTD skip fell "
                                  "back to full replay (%s)",
                                  ctx.rank, tpid, why)
                    fallback_reason = str(why)
                    skip = None
                    self._broadcast_mode(tpid, False)
            # termdet rewind.  force_terminated: a pool that completed
            # LOCALLY (its partition drained before the kill) must
            # still restart — the adopter's re-executed activations
            # land here — and the returned TERMINATED tells us to
            # re-arm the completion bookkeeping its termination already
            # released
            was = tp.termdet.taskpool_reset(tp, force_terminated=True)
            if jr is not None:
                jr.emit("termdet_rewind", pool=tpid,
                        was=(was.name if was is not None else None),
                        epoch=tp.run_epoch)
            if was is None:
                tp.state = TaskpoolState.DONE
                with self._lock:
                    self._active.discard(tp.taskpool_id)
                return 0
            from parsec_tpu_torch.core.termdet import TermdetState
            if was == TermdetState.TERMINATED:
                with ctx._lock:
                    ctx._active_taskpools += 1
                tp._done_event.clear()
            tp.termdet.taskpool_addto_runtime_actions(tp, 1)  # startup
            if getattr(tp, "_dyn_hold", False):
                # a DynamicTaskpool's distributed termination hold was
                # zeroed with the counters: re-take it (and keep the
                # comm layer's registration) so the restarted pool
                # still resolves through the pool-scoped Safra round
                # instead of stranding resolve_dynamic_holds
                tp.termdet.taskpool_addto_runtime_actions(tp, 1)
                rde.rearm_dynamic_hold(tp)
            tp.recovery_reset()
            if rplan is not None:
                # minimal: restore the adopted partition (its versions
                # died with the rank) and the planned rewinds only —
                # every other local tile keeps its live final state
                tp._replay_filter = set(rplan.tasks)
                for dc, idx, arr, how in plan:
                    if dc.rank_of(*idx) in dead_set:
                        self._restore_tile(dc, idx, arr, how)
                for dc, idx, arr in base_restores:
                    self._restore_tile(dc, idx, arr, "snapshot")
            elif skip is not None:
                # DTD skip: restore ONLY tiles the agreed prefix never
                # writes (vcut 0 — pool-attach snapshot / init state);
                # every written tile's cut value is the designated
                # holder's live bytes, seeded/served during the replay
                vc = skip["vcut"]
                dcids = getattr(tp, "_dc_ids", {})
                for dc, idx, arr, how in plan:
                    wire = ("c", dcids.get(id(dc)),
                            dc.data_key(*idx))
                    if wire not in vc:
                        self._restore_tile(dc, idx, arr, how)
                tp.dtd_arm_skip(skip["prefix"], skip["holders"],
                                skip["seeds"], vc)
            else:
                # restore the last surviving version of every owned tile
                for dc, idx, arr, how in plan:
                    self._restore_tile(dc, idx, arr, how)
        except Exception:
            # anything failing BEFORE the restore finished leaves the
            # adopted partition unrestored: roll the translation back
            # so no later pool sees zero-filled adopted tiles as local
            # (the pool itself is contained by the caller)
            for dc, prev in prev_tables:
                dc.set_rank_translation(prev)
            raise
        # re-insert the re-execution sub-DAG
        if spec["replay"] is not None:
            spec["replay"](tp)
            if skip is not None:
                # covers the all-skipped stream (no post-prefix insert
                # triggered the finalize) and disarms the filter
                tp.dtd_skip_finish()
            n = max(int(tp.nb_tasks), 0)
        else:
            ready = tp.startup()
            if rplan is not None and synth:
                # deliveries whose producers are skipped: hand the
                # materialized versions straight to the dep countdown
                ready.extend(self._deliver_synth(tp, synth))
            n = max(int(tp.nb_tasks), 0)
            if ready:
                scheduling.schedule(ctx.streams[0], ready)
        jr2 = ctx.journal
        rnd = self._mode_round(tpid)
        if rplan is not None:
            self.minimal_replays += 1
            if jr2 is not None:
                jr2.emit("replay_mode", pool=tpid, mode="minimal",
                         round=rnd, tasks=n, synth=len(synth),
                         rewinds=len(base_restores))
            debug_verbose(1, "rank %d: pool %d MINIMAL replay: %d "
                          "task(s), %d synthesized edge(s), %d "
                          "rewound tile(s)", ctx.rank, tpid, n,
                          len(synth), len(base_restores))
        elif skip is not None:
            self.minimal_replays += 1
            self.skip_agreements += 1
            if jr2 is not None:
                jr2.emit("replay_mode", pool=tpid, mode="skip",
                         round=rnd, prefix=skip["prefix"],
                         seeds=len(skip["seeds"]), tasks=n)
            debug_verbose(1, "rank %d: pool %d DTD MINIMAL replay: "
                          "skipped the agreed insert prefix %d (%d "
                          "held cut payload(s)), %d task(s) re-run",
                          ctx.rank, tpid, skip["prefix"],
                          len(skip["seeds"]), n)
        else:
            self.full_replays += 1
            if jr2 is not None:
                jr2.emit("replay_mode", pool=tpid, mode="full",
                         round=rnd, reason=fallback_reason or "unknown",
                         tasks=n)
            # every full-replay fallback is DIAGNOSABLE from the
            # flight-recorder bundle (reason string: evicted ring /
            # nacked need / skip-vote full / unsupported pool / ...),
            # not inferred from counter deltas
            ctx.telemetry_incident(
                f"recovery-fallback pool={tpid} "
                f"reason={fallback_reason or 'unknown'}")
        tp.ready()
        with self._lock:
            # a later death's event still queued for this pool keeps it
            # recovering: this generation's sends to that rank (it may
            # be the adopter this restart just mapped to) are the torn
            # generation's, excused, not a failure of the pool (a
            # deliberate difference: the JAX package unmarks it here)
            if not any(tp in pools for _r, _e, pools in self._events):
                self._active.discard(tp.taskpool_id)
        # frames parked while the pool was down deliver into the new
        # generation now
        rde.retry_delayed()
        drain = getattr(ctx.comm, "dtd_drain_backlog", None)
        if drain is not None and hasattr(tp, "_dtd_incoming"):
            drain(tp)
        return n

    def _await_insert_stream(self, tp) -> None:
        """Wait (bounded by ``recovery_drain_s``) until the application
        has ended the insert stream of a replay-driven pool (``wait()``
        marks it, ``_finished``).  The replay re-inserts the whole
        stream from the recovery thread, so it must not overlap the
        application's own inserts: a death landing mid-stream would have
        both threads insert the same tasks (a deliberate difference: the
        JAX package restarts at once).  The application's inserts after
        the death run in the torn generation, which the fence below
        discards.  A stream that does not end in time (blocked on a full
        window behind the dead rank's tiles) aborts the recovery."""
        deadline = time.monotonic() + self.drain_s
        while not getattr(tp, "_finished", True):
            if time.monotonic() >= deadline:
                raise RecoveryUnsupported(
                    f"rank {self.context.rank}: the insert stream of pool "
                    f"{tp.taskpool_id} did not end within "
                    f"{self.drain_s:g}s of the death; its replay would "
                    "overlap it")
            time.sleep(0.005)

    def _restore_tile(self, dc, idx: Tuple, arr, how: str) -> None:
        """Land one restore payload as the tile's newest version.  A host
        tensor overwrites the host copy (device copies invalidate); a
        tensor on a card — a re-runnable source that makes tiles where
        the computation runs — becomes the tile's device copy on that
        card's module, with no host round trip.  ``how`` ("snapshot" or
        "init") is counted in ``restored_tiles``."""
        self.restored_tiles[how] = self.restored_tiles.get(how, 0) + 1
        if isinstance(arr, torch.Tensor) and arr.device.type != "cpu":
            dev = next((d for d in
                        self.context.device_registry.accelerators
                        if getattr(d, "tdev", None) == arr.device), None)
            if dev is None:
                raise RecoveryUnsupported(
                    f"{dc.name}{idx}: restore payload lives on "
                    f"{arr.device}, which no device module of this "
                    "context serves")
            # a private copy: kernels later write the tile in place, and
            # the source may hand out the same storage again
            payload = arr.clone()
            place = getattr(dc, "place_on_device", None)
            if place is not None:
                place(*idx, dev, payload)
            else:
                datum = dc.data_of(*idx)
                dev.adopt(datum, datum.overwrite_on(dev.space, payload))
            return
        dc.data_of(*idx).overwrite_host(arr)

    def _static_fallback_reason(self, tp, spec) -> str:
        """Why a pool never even attempts a minimal/skip plan — the
        reason string every full-replay fallback's flight-recorder
        incident carries."""
        if not (self.minimal_on and self.lineage_on):
            return "minimal replay disabled by configuration"
        lin = tp._lineage
        if lin is None:
            return "unsupported pool (no lineage ring armed)"
        if lin.overflow:
            return "evicted ring"
        if spec["replay"] is not None:
            if not self.dtd_skip_on:
                return "dtd skip agreement disabled by configuration"
            return "unsupported pool (replay-driven, no skip report)"
        if getattr(tp, "dynamic", False):
            return "unsupported pool (dynamic discovery)"
        return "unsupported pool"

    # -- dead-set agreement + replay-need negotiation (TAG_RECOVER) ------
    def _agree_dead_set(self, observed: set) -> set:
        """Converge this survivor's dead-set view with the coordinator
        (lowest live rank).  The coordinator coalesces reports for
        ``recovery_agree_window_s`` and broadcasts the CONFIRMED union;
        everyone else reports and waits (bounded) for a broadcast
        covering its observation.  Returns the agreed set; on timeout
        (coordinator died mid-round) the local view — bounded, never
        silent."""
        rde = self._rde
        if rde is None:
            return set(observed)
        ce = rde.ce
        me = ce.rank
        live = [r for r in range(ce.nranks)
                if r != me and r not in ce.dead_peers
                and r not in observed]
        if not live:
            return set(observed)   # sole survivor: nothing to agree
        from parsec_tpu_torch.comm.engine import TAG_RECOVER
        coord = min([me] + live)
        if coord == me:
            deadline = time.monotonic() + self.agree_window
            with self._ctl_cond:
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._ctl_cond.wait(left)
                reported = set()
                for s in self._agree_reports.values():
                    reported |= s
            confirmed = (set(observed) | reported
                         | set(ce.dead_peers)) - {me}
            with self._ctl_cond:
                self._agree_confirmed.update(confirmed)
            jr = self.context.journal
            if jr is not None:
                jr.emit("deadset_bcast", peers=confirmed)
            for r in sorted(set(range(ce.nranks)) - confirmed - {me}):
                try:
                    ce.send_am(TAG_RECOVER, r,
                               {"k": "deadset",
                                "ranks": sorted(confirmed)})
                except OSError:
                    pass   # its death will get its own event
            return confirmed
        jr = self.context.journal
        if jr is not None:
            jr.emit("deadset_report", peers=observed, coord=coord)
        try:
            ce.send_am(TAG_RECOVER, coord,
                       {"k": "dead", "ranks": sorted(observed)})
        except OSError:
            return set(observed)
        deadline = time.monotonic() + self.agree_timeout
        with self._ctl_cond:
            while not (observed <= self._agree_confirmed):
                left = deadline - time.monotonic()
                if left <= 0:
                    warning("rank %d: dead-set agreement timed out "
                            "waiting for coordinator %d; proceeding "
                            "with the local view %s", me, coord,
                            sorted(observed))
                    if jr is not None:
                        # the bounded degradation, now on the record:
                        # the coordinator died mid-round and this
                        # survivor proceeds on its local view
                        jr.emit("deadset_timeout", peers=observed,
                                coord=coord)
                    return set(observed)
                self._ctl_cond.wait(left)
            return set(observed) | set(self._agree_confirmed)

    def _declare_reported(self, ranks: set, src: int) -> None:
        """A peer's report/broadcast names deaths this rank has not
        detected yet: declare them now so the local recovery event
        fires and every survivor converges on one dead set."""
        rde = self._rde
        if rde is None:
            return
        ce = rde.ce
        from parsec_tpu_torch.core.errors import PeerFailedError
        for r in ranks:
            if r == ce.rank or r == src or r in ce.dead_peers:
                continue
            ce.declare_peer_dead(r, PeerFailedError(
                r, f"rank {ce.rank}: rank {r} reported dead by rank "
                   f"{src} (dead-set agreement)", detector="agreement"))

    # lint: on-loop (TAG_RECOVER AM handler via CommEngine.on_recover)
    def _on_recover_msg(self, src: int, msg: dict) -> None:
        """Recovery control lane (comm thread: store, signal, reply —
        the heavy work stays on the recovery thread)."""
        k = msg.get("k")
        jr = self.context.journal
        if k == "dead":
            ranks = {int(r) for r in msg.get("ranks", ())}
            if jr is not None:
                jr.emit("deadset_recv", peers=ranks, src=src, kind=k)
            with self._ctl_cond:
                self._agree_reports.setdefault(src, set()).update(ranks)
                self._ctl_cond.notify_all()
            self._declare_reported(ranks, src)
        elif k == "deadset":
            ranks = {int(r) for r in msg.get("ranks", ())}
            if jr is not None:
                jr.emit("deadset_recv", peers=ranks, src=src, kind=k)
            with self._ctl_cond:
                self._agree_confirmed.update(ranks)
                self._ctl_cond.notify_all()
            self._declare_reported(ranks, src)
        elif k == "need":
            self._handle_need(src, msg)
        elif k == "need_ack":
            with self._ctl_cond:
                self._need_acks[(msg.get("tp"), src)] = \
                    bool(msg.get("ok"))
                self._ctl_cond.notify_all()
        elif k == "skipf":
            # DTD skip agreement: a survivor's frontier/landed report
            # (or its full vote) — store for the coordinator's round
            if jr is not None:
                jr.emit("skip_offer", pool=msg.get("tp"),
                        round=int(msg.get("round", 0)),
                        frontier=int(msg.get("frontier", -1)),
                        src=src, full=msg.get("full"))
            with self._ctl_cond:
                self._skip_reports[(msg.get("tp"), src)] = \
                    (int(msg.get("round", 0)), msg)
                self._ctl_cond.notify_all()
        elif k == "skipset":
            # the coordinator's agreed-prefix broadcast
            if jr is not None:
                jr.emit("skip_cut", pool=msg.get("tp"),
                        round=int(msg.get("round", 0)),
                        prefix=int(msg.get("prefix", 0)), src=src)
            with self._ctl_cond:
                self._skip_set[msg.get("tp")] = \
                    (int(msg.get("round", 0)), msg)
                self._ctl_cond.notify_all()
        elif k == "retire":
            # retirement handshake: a rank reports local completion
            self._note_retire_report(msg.get("tp"), src)
        elif k == "retired":
            # coordinator confirmed global quiescence for this pool
            self._apply_retired(msg.get("tp"))
        elif k == "mode":
            tpid = msg.get("tp")
            rnd = int(msg.get("round", 0))
            if jr is not None:
                jr.emit("mode_vote", pool=tpid, round=rnd,
                        mode="minimal" if msg.get("minimal") else "full",
                        src=src)
            reply = None
            with self._ctl_cond:
                self._peer_modes[(tpid, src)] = \
                    (rnd, "minimal" if msg.get("minimal") else "full")
                self._ctl_cond.notify_all()
                mine = self._my_mode.get(tpid)
                if mine is not None and mine[0] == rnd \
                        and not msg.get("re"):
                    # answer a late voter with our same-round ballot —
                    # we may have committed and left the agreement
                    # wait already ("re" marks replies: never reply to
                    # a reply, or two committed ranks ping-pong)
                    reply = {"k": "mode", "tp": tpid, "round": rnd,
                             "minimal": mine[1] == "minimal",
                             "re": True}
            if reply is not None and self._rde is not None:
                from parsec_tpu_torch.comm.engine import TAG_RECOVER
                try:
                    self._rde.ce.send_am(TAG_RECOVER, src, reply)
                except OSError:
                    pass

    def _handle_need(self, src: int, msg: dict) -> None:
        """A peer's minimal plan needs producers living here re-run so
        its re-executing consumers are re-fed.  Ack = a PROMISE: the
        resolved producer keys join this rank's replay set before its
        plan freezes.  Nack (plan already frozen, pool not restarting
        here, or unresolvable need) sends the requester to its full-
        replay fallback."""
        tpid = msg.get("tp")
        tp = self.context.taskpools.get(tpid)
        jr = self.context.journal
        if jr is not None:
            jr.emit("need_req", pool=tpid, src=src,
                    n=len(msg.get("needs", ())))
        ok = False
        if tp is not None and self.recovering(tp):
            seeds: List[Any] = []
            resolvable = True
            for ckey, cflow in msg.get("needs", ()):
                got = self._resolve_need(tp, tuple(ckey), cflow)
                if not got:
                    resolvable = False
                    break
                seeds.extend(got)
            if resolvable:
                with self._ctl_cond:
                    state = self._plan_state.get(tpid)
                    if state != "frozen":
                        # "open"/None: merged before the freeze;
                        # "full": everything re-runs anyway
                        self._extra_seeds.setdefault(
                            tpid, set()).update(seeds)
                        ok = True
                    else:
                        # SECOND-ROUND need against a frozen plan (the
                        # requester's merged seed closure widened): ack
                        # without modification iff every resolved
                        # producer is ALREADY in the frozen replay set
                        # — the promise costs nothing, and an
                        # unconditional nack would force a full replay
                        # for needs the plan was about to satisfy
                        frozen = self._frozen_tasks.get(tpid)
                        ok = frozen is not None \
                            and all(s in frozen for s in seeds)
        rde = self._rde
        if jr is not None:
            # the answered-or-degraded invariant's responder half:
            # every need_req this rank observed gets its need_ack on
            # the record (a missing pair is an unanswered negotiation)
            jr.emit("need_ack", pool=tpid, dst=src, ok=ok)
        if rde is not None:
            from parsec_tpu_torch.comm.engine import TAG_RECOVER
            try:
                rde.ce.send_am(TAG_RECOVER, src,
                               {"k": "need_ack", "tp": tpid, "ok": ok})
            except OSError:
                pass   # the requester died; its death routes elsewhere

    def _resolve_need(self, tp, ckey: Tuple, cflow: str) -> List[Any]:
        """Structurally invert a consumer's task-fed input edge to the
        producer instance(s) THIS rank owns (the requester only knows
        the consumer side).  Empty list = unresolvable (nack)."""
        from parsec_tpu_torch.core.task import FromTask
        tc = tp.task_classes.get(ckey[0]) if ckey else None
        if tc is None or tc.key_fn is not None:
            return []
        try:
            locals_ = tc.key_to_locals(ckey)
            fl = tc._flow_by_name.get(cflow)
            dep = fl.active_input(locals_) if fl is not None else None
            if dep is None or not isinstance(dep.end, FromTask):
                return []
            ptc = tp.task_classes.get(dep.end.task_class)
            if ptc is None or ptc.key_fn is not None:
                return []
            out = []
            myrank = self.context.rank
            for pl in dep.end.instances(locals_):
                pl = ptc.complete_locals(dict(pl))
                if ptc.rank_of(pl) == myrank:
                    out.append(ptc.make_key(pl))
            return out
        except Exception:
            return []

    def _negotiate_needs(self, tp, needs: List[Tuple[int, Any, str]]) \
            -> bool:
        """Ask each producing survivor to include our needed producers
        in ITS replay set; True only when every peer acked within the
        agreement timeout.  (The journal's ``need_send`` record is the
        caller's — _plan_minimal knows the negotiation round.)"""
        rde = self._rde
        if rde is None:
            return False
        ce = rde.ce
        tpid = tp.taskpool_id
        by_peer: Dict[int, List] = {}
        for r, ckey, cflow in needs:
            by_peer.setdefault(r, []).append((tuple(ckey), cflow))
        from parsec_tpu_torch.comm.engine import TAG_RECOVER
        with self._ctl_cond:
            for r in by_peer:
                self._need_acks.pop((tpid, r), None)
        for r, items in by_peer.items():
            try:
                ce.send_am(TAG_RECOVER, r,
                           {"k": "need", "tp": tpid, "needs": items})
            except OSError:
                return False
        deadline = time.monotonic() + self.agree_timeout
        with self._ctl_cond:
            while True:
                missing = [r for r in by_peer
                           if (tpid, r) not in self._need_acks]
                if not missing:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._ctl_cond.wait(left)
            return all(self._need_acks.get((tpid, r))
                       for r in by_peer)

    def _mode_round(self, tpid: int) -> int:
        """The mode-vote round = this pool's restart-attempt count —
        symmetric across survivors under the gang-wide restart rule,
        so two ranks agreeing are provably talking about the SAME
        death event (divergent rounds time out into full replay)."""
        with self._lock:
            return self._attempts.get(tpid, 0)

    def _broadcast_mode(self, tpid: int, minimal: bool) -> None:
        """Declare this rank's replay mode for one pool restart to
        every live peer (the mode-agreement vote), and remember it so
        a late voter's ballot gets answered after we committed."""
        rde = self._rde
        if rde is None:
            return
        rnd = self._mode_round(tpid)
        mode = "minimal" if minimal else "full"
        with self._ctl_cond:
            self._my_mode[tpid] = (rnd, mode)
        peers = rde._live_peers()
        jr = self.context.journal
        if jr is not None:
            # membership = this voter's view of the round's live gang
            # (the auditor's votes-agree-on-membership invariant reads
            # exactly this field across ranks)
            jr.emit("mode_decl", pool=tpid, round=rnd, mode=mode,
                    peers=set(peers) | {self.context.rank})
        from parsec_tpu_torch.comm.engine import TAG_RECOVER
        for r in peers:
            try:
                rde.ce.send_am(TAG_RECOVER, r,
                               {"k": "mode", "tp": tpid, "round": rnd,
                                "minimal": bool(minimal)})
            except OSError:
                pass

    def _agree_mode(self, tpid: int) -> bool:
        """Every survivor must take the SAME replay mode for a pool: a
        full-replaying peer sends no re-feed needs, so a minimal peer
        would skip producers that peer's re-enumeration waits on
        forever — asymmetric modes deadlock the gang.  True only when
        EVERY live peer declared minimal FOR THIS ROUND within the
        agreement timeout; a declared full, a missing vote, or a
        divergent round falls this rank back too (full-on-all-sides is
        always safe)."""
        rde = self._rde
        peers = rde._live_peers() if rde is not None else []
        if not peers:
            return True
        rnd = self._mode_round(tpid)
        deadline = time.monotonic() + self.agree_timeout

        def _result(agreed: bool) -> bool:
            jr = self.context.journal
            if jr is not None:
                jr.emit("mode_result", pool=tpid, round=rnd,
                        mode="minimal" if agreed else "full")
            return agreed

        with self._ctl_cond:
            while True:
                modes = [self._peer_modes.get((tpid, r)) for r in peers]
                modes = [m[1] if m is not None and m[0] == rnd else None
                         for m in modes]
                if any(m == "full" for m in modes):
                    return _result(False)
                if all(m == "minimal" for m in modes):
                    return _result(True)
                left = deadline - time.monotonic()
                if left <= 0:
                    return _result(False)
                self._ctl_cond.wait(left)

    # -- DTD insert-stream skip agreement ---------------------------------
    def _plan_dtd_skip(self, tp, spec, dead_set: set) -> dict:
        """Agree the largest common skippable insert-stream prefix for
        one multi-rank DTD pool restart (one TAG_RECOVER report/
        broadcast round, bounded by ``recovery_agree_timeout_s``) and
        materialize this rank's side of it: the cut payloads it is the
        designated holder of, and the vcut map the selective restore
        consults.  A sole survivor short-circuits to its local view
        (no wire round).  Raises :class:`RecoveryUnsupported` on any
        infeasibility — the caller votes full and the mode round
        falls the whole gang back symmetrically."""
        from parsec_tpu_torch.comm.engine import TAG_RECOVER
        tpid = tp.taskpool_id
        rep = tp.dtd_skip_report()
        full_why = rep.get("full")
        rde = self._rde
        ce = rde.ce if rde is not None else None
        peers = rde._live_peers() if rde is not None else []
        rnd = self._mode_round(tpid)
        me = self.context.rank
        jr = self.context.journal
        if jr is not None:
            # this rank's OWN offered cut — the auditor checks every
            # agreed prefix against every offer in the round
            jr.emit("skip_offer", pool=tpid, round=rnd,
                    frontier=(-1 if full_why is not None
                              else int(rep["frontier"])),
                    full=full_why)
        if not peers or ce is None:
            # sole survivor: the agreement short-circuits locally
            if full_why is not None:
                raise RecoveryUnsupported(f"dtd skip: {full_why}")
            k, holders, vcuts = dtd_skip_prefix(
                {me: rep["frontier"]}, {me: rep["landed"]},
                rep["writes"])
            if jr is not None:
                jr.emit("skip_cut", pool=tpid, round=rnd, prefix=int(k))
            if k <= 0:
                raise RecoveryUnsupported(
                    "dtd skip: no skippable prefix in the local view")
        elif rde.recovery_coordinator() == ce.rank:
            # coordinator: collect every survivor's frontier report,
            # cut the common prefix, broadcast it (prefix 0 = the gang
            # falls back fast instead of timing out one by one)
            k, holders, vcuts = 0, {}, {}
            why = None
            if full_why is not None:
                why = f"local vote full ({full_why})"
            else:
                deadline = time.monotonic() + self.agree_timeout
                reports: Dict[int, dict] = {}
                with self._ctl_cond:
                    while True:
                        reports = {}
                        for r in peers:
                            ent = self._skip_reports.get((tpid, r))
                            if ent is not None and ent[0] == rnd:
                                reports[r] = ent[1]
                        if len(reports) == len(peers):
                            break
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._ctl_cond.wait(left)
                if len(reports) < len(peers):
                    why = "a survivor's skip report never arrived"
                else:
                    fulls = sorted(r for r, m in reports.items()
                                   if m.get("full"))
                    if fulls:
                        why = (f"rank {fulls[0]} voted full "
                               f"({reports[fulls[0]]['full']})")
                    else:
                        frontiers = {me: rep["frontier"]}
                        landed = {me: dict(rep["landed"])}
                        for r, m in reports.items():
                            frontiers[r] = int(m["frontier"])
                            landed[r] = dict(m["landed"])
                        k, holders, vcuts = dtd_skip_prefix(
                            frontiers, landed, rep["writes"])
                        if k <= 0:
                            why = ("no common prefix consistent with "
                                   "the survivors' materializable cuts")
            out = {"k": "skipset", "tp": tpid, "round": rnd,
                   "prefix": k, "holders": holders, "vcut": vcuts}
            if jr is not None:
                jr.emit("skip_cut", pool=tpid, round=rnd, prefix=int(k),
                        why=why)
            for r in peers:
                try:
                    ce.send_am(TAG_RECOVER, r, dict(out))
                except OSError:
                    pass   # its death gets its own event
            if why is not None:
                raise RecoveryUnsupported(f"dtd skip: {why}")
        else:
            # participant: report the frontier (or the full vote),
            # then wait for the coordinator's agreed prefix
            coord = rde.recovery_coordinator()
            msg = {"k": "skipf", "tp": tpid, "round": rnd}
            if full_why is not None:
                msg["full"] = full_why
            else:
                msg["frontier"] = rep["frontier"]
                msg["landed"] = rep["landed"]
            try:
                ce.send_am(TAG_RECOVER, coord, msg)
            except OSError:
                raise RecoveryUnsupported(
                    "dtd skip: coordinator unreachable")
            if full_why is not None:
                raise RecoveryUnsupported(f"dtd skip: {full_why}")
            deadline = time.monotonic() + self.agree_timeout
            with self._ctl_cond:
                while True:
                    ent = self._skip_set.get(tpid)
                    if ent is not None and ent[0] == rnd:
                        agreed = ent[1]
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise RecoveryUnsupported(
                            "dtd skip: agreed-prefix broadcast never "
                            "arrived (coordinator died mid-round?)")
                    self._ctl_cond.wait(left)
            k = int(agreed.get("prefix", 0))
            holders = dict(agreed.get("holders") or {})
            vcuts = dict(agreed.get("vcut") or {})
            if k <= 0:
                raise RecoveryUnsupported(
                    "dtd skip: coordinator declared no skippable "
                    "prefix")
        mine = [w for w, h in holders.items() if h == me]
        seeds = tp.dtd_capture_seeds(mine)
        if len(seeds) != len(mine):
            # a held cut payload with no host bytes is an
            # infeasibility, not a crash — the mode round falls the
            # gang back symmetrically
            raise RecoveryUnsupported(
                "dtd skip: a held cut payload is not host-pullable")
        return {"prefix": k, "holders": holders, "vcut": vcuts,
                "seeds": seeds}

    # -- minimal replay (recorded-lineage plan) ---------------------------
    def _plan_minimal(self, tp, spec, dead_set: set) -> ReplayPlan:
        """Compute, negotiate, and FREEZE the minimal plan for one pool
        restart.  Raises RecoveryUnsupported on any infeasibility — the
        caller then takes the restore-point fallback."""
        tpid = tp.taskpool_id
        rounds = self.need_rounds_cap
        used = 0
        counts = self.need_round_counts

        def _round_outcome(outcome: str, rnd: int, peers) -> None:
            """Count AND journal one negotiation round's terminal
            outcome — a silent round is exactly the bug class the
            auditor's answered-or-degraded invariant encodes."""
            counts[outcome] += 1
            jr = self.context.journal
            if jr is not None:
                jr.emit("need_round", pool=tpid, round=rnd,
                        outcome=outcome, peers=peers)

        def _round_send(rnd: int, needs) -> None:
            jr = self.context.journal
            if jr is not None:
                jr.emit("need_send", pool=tpid, round=rnd,
                        peers={r for r, _k, _f in needs},
                        n=len(needs))

        with self._ctl_cond:
            extra = set(self._extra_seeds.get(tpid, ()))
        plan = self._compute_minimal(tp, spec, dead_set, extra)
        first_needs = {(r, k, f) for r, k, f in plan.needs}
        if plan.needs:
            used = 1
            need_peers = {r for r, _k, _f in plan.needs}
            _round_send(1, plan.needs)
            if not self._negotiate_needs(tp, plan.needs):
                _round_outcome("nacked", 1, need_peers)
                raise RecoveryUnsupported(
                    "a peer nacked (or never acked) a re-feed need")
            _round_outcome("acked", 1, need_peers)
        if self._rde is not None and self._rde._live_peers():
            # one window for LATE cross-survivor needs to land before
            # the plan freezes (peers restarting the same pool send
            # theirs concurrently)
            time.sleep(min(self.agree_window, 1.0))
        with self._ctl_cond:
            self._plan_state[tpid] = "frozen"
            # published so a peer's OWN widened second-round need can
            # ack against this rank's committed replay set
            self._frozen_tasks[tpid] = set(plan.tasks)
            extra2 = set(self._extra_seeds.pop(tpid, ()))
        if extra2 - extra:
            plan = self._compute_minimal(tp, spec, dead_set, extra2)
            with self._ctl_cond:
                self._frozen_tasks[tpid] = set(plan.tasks)
            widened = {(r, k, f) for r, k, f in plan.needs} \
                - first_needs
            if widened:
                # the merged seeds' closure reached producers nobody
                # asked for: re-issue a BOUNDED second need round
                # against the peers' frozen plans (they ack iff the
                # producers are already committed) instead of an
                # unconditional fallback
                wide_peers = {r for r, _k, _f in widened}
                if used >= rounds:
                    _round_outcome("exhausted", used + 1, wide_peers)
                    raise RecoveryUnsupported(
                        "merged re-feed seeds widened the remote needs "
                        f"past recovery_need_rounds={rounds}")
                used += 1
                _round_outcome("widened", used, wide_peers)
                _round_send(used, sorted(widened))
                if not self._negotiate_needs(tp, sorted(widened)):
                    _round_outcome("nacked", used, wide_peers)
                    raise RecoveryUnsupported(
                        "a peer nacked a widened re-feed need "
                        "(second negotiation round)")
                _round_outcome("acked", used, wide_peers)
        return plan

    def _compute_minimal(self, tp, spec, dead_set: set,
                         extra_seeds: set) -> ReplayPlan:
        """Adapter feeding :func:`minimal_plan`: enumerate the local +
        adopted instance space, derive structural edges from the task
        classes, and expose live/materializable tile versions."""
        from parsec_tpu_torch.core.task import FromDesc, FromTask
        lin = tp._lineage
        if lin is None or lin.overflow:
            raise RecoveryUnsupported(
                "lineage ring evicted records (or recording disabled)")
        if any(tc.key_fn is not None
               for tc in tp.task_classes.values()):
            raise RecoveryUnsupported(
                "custom key_fn task class: keys are not invertible")
        myrank = self.context.rank
        records = list(lin.records)
        completed = set(lin.completed)
        dcs = {dc.name: dc for dc in spec["collections"]}
        with self._lock:
            snaps = {dc.name: dict(self._snaps.get(id(dc), ()))
                     for dc in spec["collections"]}
        #: key -> (tc, locals, original owner rank)
        keymap: Dict[Any, Tuple] = {}
        pending: set = set()
        adopted: set = set()
        for tc in tp.task_classes.values():
            aff = tc.affinity
            if aff is None and myrank != 0:
                continue
            for locals_ in tc.iter_space(tp.globals):
                locals_ = dict(locals_)
                if aff is not None and tc.rank_of(locals_) != myrank:
                    continue
                key = tc.make_key(locals_)
                orank = 0
                if aff is not None:
                    ref = aff(locals_)
                    orank = ref.dc.rank_of(*ref.indices)
                keymap[key] = (tc, locals_, orank)
                if orank in dead_set:
                    adopted.add(key)
                elif key not in completed:
                    pending.add(key)
        live: Dict[Any, int] = {}
        mat: Dict[Any, set] = {}

        def tile_info(tile) -> None:
            if tile in live:
                return
            dc = dcs.get(tile[0])
            if dc is None:
                return
            idx = tuple(tile[1:])
            if dc.rank_of(*idx) in dead_set:
                return   # adopted partition: restored, not "live"
            try:
                d = dc.data_of(*idx)
            except KeyError:
                return
            live[tile] = d.newest_version()
            vs = set()
            if self.ckpt is not None:
                vs.update(self.ckpt.versions((id(dc), tile)))
            sv = snaps.get(tile[0], {}).get(idx)
            if sv is not None:
                vs.add(sv[0])
            mat[tile] = vs

        for r in records:
            for t, _v in r.reads:
                tile_info(t)
            for t, _v in r.writes:
                tile_info(t)

        def edges(key):
            ent = keymap.get(key)
            if ent is None:
                return
            tc, locals_, _orank = ent
            for flow in tc._in_flows:
                dep = flow.active_input(locals_)
                if dep is None:
                    continue
                end = dep.end
                if isinstance(end, FromTask):
                    if dep.multiplicity(locals_) == 0:
                        continue
                    ptc = tp.task_classes.get(end.task_class)
                    if ptc is None:
                        continue
                    for pl in end.instances(locals_):
                        pl = ptc.complete_locals(dict(pl))
                        pkey = ptc.make_key(pl)
                        porig = 0
                        paff = ptc.affinity
                        if paff is not None:
                            pref = paff(pl)
                            porig = pref.dc.rank_of(*pref.indices)
                        powner = ptc.rank_of(pl)
                        if powner == myrank:
                            where = "local"
                        elif porig in dead_set:
                            where = "dead"
                        else:
                            where = ("peer", powner)
                        yield ("task", pkey, end.flow, flow.name,
                               where, flow.is_ctl)
                elif isinstance(end, FromDesc):
                    from parsec_tpu_torch.data.data import ACCESS_READ
                    if not flow.access & ACCESS_READ:
                        # a WRITE-only desc binding fully overwrites
                        # the tile: no version requirement, no rewind
                        continue
                    ref = end.ref_fn(locals_)
                    if ref.dc.rank_of(*ref.indices) in dead_set:
                        continue   # restored by the adopted path
                    idx = tuple(ref.indices)
                    tile = ref.dc.tile_key(*idx)
                    tile_info(tile)
                    sv = snaps.get(ref.dc.name, {}).get(idx)
                    yield ("desc", tile,
                           sv[0] if sv is not None else None)

        # every desc-read tile of the instance space enters ``live`` and
        # ``mat`` BEFORE the planner copies them (a deliberate difference
        # from the JAX package, whose planner sees only the tiles the
        # records name: with no completed record — a kill before the
        # first completion — a pending task's collection read of a tile
        # a fenced stale body already wrote in place found no live
        # version, took the tile as external, and re-ran over the
        # mutated bytes instead of rewinding them)
        for key in keymap:
            for _edge in edges(key):
                pass
        return minimal_plan(
            records, dead_set=dead_set, pending=pending,
            adopted=adopted, live=live, materializable=mat,
            edges=edges, extra_seeds=extra_seeds & set(keymap))

    def _materialize_plan(self, tp, spec, rplan: ReplayPlan):
        """Capture every synthesis payload and rewind array BEFORE any
        tile is overwritten (a rewound tile's live payload may itself
        be a synthesis source)."""
        dcs = {dc.name: dc for dc in spec["collections"]}
        with self._lock:
            snaps = {dc.name: dict(self._snaps.get(id(dc), ()))
                     for dc in spec["collections"]}

        def mater(tile, ver) -> torch.Tensor:
            dc = dcs.get(tile[0])
            if dc is None:
                raise RecoveryUnsupported(
                    f"minimal replay: unknown collection for {tile!r}")
            idx = tuple(tile[1:])
            d = dc.data_of(*idx)
            if d.newest_version() == ver:
                copy = d.pull_to_host()
                if copy is None or copy.payload is None:
                    # a pull that cannot produce host bytes is an
                    # infeasibility, not a crash: the caller still has
                    # the full-replay fallback
                    raise RecoveryUnsupported(
                        f"minimal replay: {tile!r} v{ver} has no "
                        "host-pullable payload")
                return to_host(copy.payload).clone()
            if self.ckpt is not None:
                arr = self.ckpt.get((id(dc), tile), ver)
                if arr is not None:
                    return arr.clone()
            sv = snaps.get(tile[0], {}).get(idx)
            if sv is not None and sv[0] == ver:
                return sv[1].clone()
            raise RecoveryUnsupported(
                f"minimal replay: {tile!r} v{ver} no longer "
                "materializable")

        synth = []
        for (ckey, cflow, tile, ver, _pk) in rplan.synth:
            arr = None if tile is None else mater(tile, ver)
            synth.append((ckey, cflow, arr))
        base = []
        for tile, ver in rplan.base.items():
            base.append((dcs[tile[0]], tuple(tile[1:]),
                         mater(tile, ver)))
        return synth, base

    def _deliver_synth(self, tp, synth) -> List[Any]:
        """Deliver the materialized out-of-plan-producer edges into the
        restarted dep countdown (exactly how a remote payload lands —
        one fresh datum per delivery; core/engine.deliver_dep returns
        the task when the arrival completes it)."""
        from parsec_tpu_torch.core import engine as core_engine
        from parsec_tpu_torch.data.data import Coherency, Data
        ready = []
        for ckey, cflow, arr in synth:
            tc = tp.task_classes.get(ckey[0])
            if tc is None:
                continue
            locals_ = tc.key_to_locals(ckey)
            copy = None
            if arr is not None:
                datum = Data(nb_elts=arr.numel() * arr.element_size())
                copy = datum.create_copy(0, payload=arr,
                                         coherency=Coherency.SHARED,
                                         version=1)
            t = core_engine.deliver_dep(tp, tc, locals_, cflow, copy,
                                        None)
            if t is not None:
                ready.append(t)
        return ready

    def _restore_plan(self, spec) -> List[Tuple[Any, Tuple, Any, str]]:
        """(dc, idx, payload, source) for every tile this rank serves
        after the re-mapping; raises RecoveryUnsupported when a tile has
        neither a snapshot nor a re-runnable source."""
        plan: List[Tuple[Any, Tuple, Any, str]] = []
        for dc in spec["collections"]:
            if not hasattr(dc, "local_tiles"):
                raise RecoveryUnsupported(
                    f"collection {dc.name!r} has no local_tiles "
                    "enumeration")
            with self._lock:
                snap = dict(self._snaps.get(id(dc), ()))
            for idx in dc.local_tiles():
                idx = tuple(idx) if isinstance(idx, (tuple, list)) \
                    else (idx,)
                if idx in snap:
                    plan.append((dc, idx, snap[idx][1], "snapshot"))
                elif dc.init_fn is not None:
                    plan.append((dc, idx, dc.init_fn(*idx), "init"))
                else:
                    raise RecoveryUnsupported(
                        f"{dc.name}{idx}: no surviving snapshot and no "
                        "init_fn re-runnable source (set one with "
                        "collection.set_init)")
        return plan

    def _drain_inflight(self, tp: Taskpool) -> None:
        """Wait (bounded) until no stale-generation body of this pool
        can still write a tile: their in-place tile writes must land
        BEFORE the restore overwrites them, never after.  First the
        worker streams (a claimed body runs to its end); then every
        device module: its queued stale tasks complete through the
        epoch fence without launching (``drop_stale``), and ``sync``
        waits out what is already launched or chain-held and
        synchronizes the launch stream, so no in-place kernel (K1 with
        ``out=C``) is left to land on restored bytes.  A drain that
        cannot complete ABORTS the recovery (the caller contains the
        pool): restoring under a still-running stale body would be
        silent corruption, strictly worse than the contained failure
        recovery replaces."""
        deadline = time.monotonic() + self.drain_s
        while True:
            busy = False
            for es in self.context.streams:
                t = es.running_task
                if t is not None and t.taskpool is tp \
                        and t.pool_epoch != tp.run_epoch:
                    busy = True
                    break
            if not busy:
                break
            if time.monotonic() >= deadline:
                raise RecoveryUnsupported(
                    f"rank {self.context.rank}: stale-generation bodies "
                    f"of pool {tp.taskpool_id} still running after "
                    f"{self.drain_s:g}s drain — restoring under them "
                    "would corrupt the lineage base")
            time.sleep(0.005)
        for d in self.context.device_registry.accelerators:
            drop = getattr(d, "drop_stale", None)
            if drop is not None:
                drop(tp)
        try:
            self.context.sync_devices(
                timeout=max(0.1, deadline - time.monotonic()))
        except TimeoutError as exc:
            raise RecoveryUnsupported(
                f"rank {self.context.rank}: device modules of pool "
                f"{tp.taskpool_id} not drained within {self.drain_s:g}s "
                f"({exc}) — restoring under them would corrupt the "
                "lineage base") from exc

    # -- rejoin ----------------------------------------------------------
    def on_rejoin_request(self, src: int, msg: dict) -> Optional[dict]:
        """Survivor side of the rejoin handshake (comm thread): validate
        the incarnation epoch against the fence, clear the dead mark,
        hand back the translation table.  Returns the ack payload, or
        None to deny."""
        rde = self._rde
        if rde is None:
            return None
        epoch = int(msg.get("epoch", 0))
        fence = rde.peer_fence(src)
        jr = self.context.journal
        if epoch < fence:
            if jr is not None:
                jr.emit("rejoin_req", src=src, epoch=epoch, ok=False,
                        fence=fence)
            warning("rank %d: rejected rejoin of rank %d with stale "
                    "epoch %d (fence %d)", self.context.rank, src,
                    epoch, fence)
            return None
        if jr is not None:
            jr.emit("rejoin_req", src=src, epoch=epoch, ok=True,
                    fence=fence)
        rde.note_peer_epoch(src, epoch)
        rde.ce.peer_rejoined(src, epoch)
        with self._ctl_cond:
            # the agreement plane must not re-declare a rejoined rank
            # from stale confirmations of its previous incarnation
            self._agree_confirmed.discard(src)
            self._agree_reports.pop(src, None)
            for s in self._agree_reports.values():
                s.discard(src)
        busy = False
        with self._lock:
            self._peer_epochs[src] = epoch
            self._dead_map.pop(src, None)
            dead_map = dict(self._dead_map)
            busy = bool(self._active) or bool(self._events)
            translated = list(self._translated)
            if busy:
                # a restart mid-flight keeps its table until done (the
                # re-executing tasks must keep resolving to their
                # adopter); the recovery thread applies the clear once
                # the pipeline drains (_apply_untranslate)
                self._pending_untranslate.add(src)
        if not busy:
            # the rank takes its partition back for FUTURE lookups
            for dc in translated:
                table = dict(dc._recovery_translate or {})
                table.pop(src, None)
                dc.set_rank_translation(table)
        self.rejoins += 1
        self._notify_services("rejoin", src)
        warning("rank %d: rank %d REJOINED (incarnation epoch %d)",
                self.context.rank, src, epoch)
        ce = rde.ce
        with ce._bar_cond:
            bar_gen = ce._bar_gen
        return {"k": "ack", "epoch": epoch, "rank": self.context.rank,
                "translation": dead_map, "bar_gen": bar_gen}

    def rejoin(self, timeout: float = 30.0) -> Dict[int, int]:
        """Restarted-rank side: announce the new incarnation to every
        live peer and wait for the first ack; returns the received
        translation table (other still-dead ranks' re-mappings)."""
        rde = self._rde
        if rde is None:
            raise RuntimeError("rejoin needs an attached comm engine")
        ce = rde.ce
        peers = [r for r in range(ce.nranks)
                 if r != ce.rank and r not in ce.dead_peers]
        if not peers:
            raise RuntimeError("rejoin: no live peers to rejoin")
        from parsec_tpu_torch.comm.engine import TAG_REJOIN
        req = {"k": "req", "rank": ce.rank, "epoch": ce.epoch}
        deadline = time.monotonic() + timeout
        ack = None
        while ack is None:
            # RE-ANNOUNCE each round: a frame sent before a survivor
            # finished re-creating its transport state for us (the shm
            # ring re-creation race, a still-dialing socket) is lost —
            # the request is idempotent, so retry until acked
            for r in peers:
                try:
                    ce.send_am(TAG_REJOIN, r, dict(req))
                except OSError:
                    continue   # that survivor died meanwhile
            left = deadline - time.monotonic()
            if left <= 0:
                break
            ack = ce.wait_rejoin_ack(min(2.0, left))
        if ack is None:
            raise TimeoutError(
                f"rank {ce.rank}: rejoin not acknowledged within "
                f"{timeout:g}s (every survivor denied the epoch or was "
                "unreachable)")
        table = {int(k): int(v)
                 for k, v in (ack.get("translation") or {}).items()}
        jr = self.context.journal
        if jr is not None:
            jr.emit("rejoin_done", epoch=ce.epoch,
                    acked_by=int(ack.get("rank", -1)),
                    bar_gen=int(ack.get("bar_gen", 0)))
        with self._lock:
            self._dead_map.update(table)
        # generation-numbered state transfer: the fresh engine's barrier
        # counter syncs to the survivors' so the next collective round
        # numbers match across the rebuilt gang
        with ce._bar_cond:
            ce._bar_gen = max(ce._bar_gen,
                              int(ack.get("bar_gen", 0)))
        return table

    # -- observability ----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                **self.counts,
                "tasks_reexecuted": self.tasks_reexecuted,
                "rejoins": self.rejoins,
                "minimal_replays": self.minimal_replays,
                "full_replays": self.full_replays,
                "skip_agreements": self.skip_agreements,
                "retirements": self.retirements,
                "retire_degraded": self.retire_degraded,
                "restored_tiles": dict(self.restored_tiles),
                "need_rounds": dict(self.need_round_counts),
                "dead_map": dict(self._dead_map),
                "active_pools": sorted(self._active),
            }

    def _collect(self) -> List[dict]:
        """Scrape-time metrics families (prof/metrics.py collector —
        zero hot-path hooks; every value accumulates on the recovery/
        comm threads and is read here)."""
        from parsec_tpu_torch.prof.metrics import (counter_sample,
                                             histogram_sample)
        out = [counter_sample("parsec_recoveries_total", v,
                              {"stage": stage})
               for stage, v in self.counts.items()]
        out.append(counter_sample("parsec_tasks_reexecuted_total",
                                  self.tasks_reexecuted))
        out.append(counter_sample("parsec_rank_rejoins_total",
                                  self.rejoins))
        out.append(counter_sample("parsec_recovery_minimal_replays_total",
                                  self.minimal_replays))
        out.append(counter_sample("parsec_recovery_full_replays_total",
                                  self.full_replays))
        out.append(counter_sample("parsec_recovery_skip_agreements_total",
                                  self.skip_agreements))
        out.append(counter_sample(
            "parsec_recovery_pool_retirements_total", self.retirements))
        out.append(counter_sample(
            "parsec_recovery_retire_degraded_total",
            self.retire_degraded))
        out.extend(counter_sample("parsec_recovery_need_rounds_total",
                                  v, {"outcome": outcome})
                   for outcome, v in self.need_round_counts.items())
        out.append(histogram_sample("parsec_recovery_duration_seconds",
                                    self.duration_hist))
        return out
