"""Dependency-resolution engine: the release-deps / activate-successors path.

Rebuild of the reference's generic dep engine (reference: parsec.c:1694-1894
``parsec_release_local_OUT_dependencies`` / ``parsec_release_dep_fct`` and
the hashed dependency tracking of parsec_hash_find_deps): when a task
completes, its output deps are evaluated; each local successor's
dep-countdown record accumulates arrivals (with the produced data copies
attached) and the successor instantiates exactly when the count reaches its
expected number of task-fed inputs.  Remote successors are handed to the
comm layer (remote-dep activation).

All countdown mutations ride the deps-table bucket locks, mirroring the
reference's atomic update_deps_with_counter (parsec_internal.h:355-366).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from parsec_tpu_torch.containers.hash_table import REMOVE
from parsec_tpu_torch.data.data import (ACCESS_READ, ACCESS_WRITE, Coherency,
                                        Data, DataCopy, FLAG_COW,
                                        FLAG_SCRATCH, host_read_fence,
                                        materialize, private_host, to_host)
from parsec_tpu_torch.data.reshape import as_dtt, convert, needs_reshape
from parsec_tpu_torch.core.task import (Dep, Flow, FromDesc, FromTask, New, Null,
                                  Task, TaskClass, ToDesc, ToTask)
from parsec_tpu_torch.utils.debug_history import paranoid
from parsec_tpu_torch.utils.mempool import MemoryPool
from parsec_tpu_torch.utils.output import warning


class PendingRecord:
    """Dep-countdown record for a not-yet-ready task
    (reference: parsec_dependency_t in hash mode)."""

    __slots__ = ("expected", "arrivals", "inputs", "sources", "locals")

    def __init__(self, expected: int, locals_: Dict[str, int]):
        self.expected = expected
        self.arrivals = 0
        self.inputs: Dict[str, Optional[DataCopy]] = {}
        self.sources: Dict[str, Tuple[TaskClass, Tuple]] = {}
        self.locals = locals_


def _rec_reset(rec: PendingRecord) -> None:
    # drop references only: the Task constructed at readiness ALIASES
    # rec.locals and copied the inputs/sources entries — clearing these
    # slots must not clear the dicts themselves
    rec.expected = 0
    rec.arrivals = 0
    rec.inputs = {}
    rec.sources = {}
    rec.locals = None


#: hot-path record pool (reference: the task/dep mempools of
#: parsec/mempool.c — one countdown record is allocated per not-yet-ready
#: task instance and freed the moment the task becomes ready)
_rec_pool = MemoryPool(factory=lambda: PendingRecord(0, None),
                       reset=_rec_reset)


def deliver_dep(taskpool, succ_tc: TaskClass, succ_locals: Dict[str, int],
                flow_name: str, copy: Optional[DataCopy],
                source: Optional[Tuple[TaskClass, Tuple]]) -> Optional[Task]:
    """Record one dependency arrival at a local successor; return the
    instantiated Task exactly when it becomes ready."""
    # dep expressions may address peers by their FREE parameters only;
    # derived single-value params (JDF derived-local idiom) are filled
    # here so the instantiated task carries the full local set
    succ_locals = succ_tc.complete_locals(succ_locals)
    key = succ_tc.make_key(succ_locals)
    nd = taskpool._native_deps
    if nd is not None:
        # native dep-countdown (parsec_tpu_torch/native/schedext.c DepTable,
        # gated by sched_native): the counter decrement, the input/
        # source recording, and the ready-transition test ride one C
        # crossing per arrival (two on the first, which installs the
        # record).  The GIL is the bucket lock; create() keeps an
        # existing record, so two workers racing the first arrivals
        # cannot wipe each other's count.
        res = nd.arrive(key, flow_name, copy, source)
        if res is False:
            nd.create(key, succ_tc.nb_task_inputs(succ_locals),
                      dict(succ_locals))
            res = nd.arrive(key, flow_name, copy, source)
        if res is None:
            return None
        locals_, inputs, sources = res
        # C task construction when the vtable exists: the record's
        # locals dict is exclusively owned (created at nd.create,
        # dropped with the record), so the constructor may alias it
        vt = succ_tc.native_vt()
        task = vt.build_one(locals_) if vt is not None \
            else Task(succ_tc, taskpool, locals_)
        if taskpool.dynamic:
            # see the non-native branch below for the ordering contract
            # (dynamic pools are statically OFF the C chain, so this
            # per-task move only runs where correctness needs it)
            taskpool.termdet.taskpool_addto_nb_tasks(  # lint: ignore[PCL-HOT]
                taskpool, 1)
        if inputs is not None:
            task.data.update(inputs)
            task.pinned_flows.update(k for k, v in inputs.items()
                                     if v is not None)
        if sources is not None:
            task.input_sources.update(sources)
        return task

    def fn(rec):
        if rec is None:
            rec = _rec_pool.alloc()
            rec.expected = succ_tc.nb_task_inputs(succ_locals)
            rec.locals = dict(succ_locals)
        rec.arrivals += 1
        if paranoid(2) and rec.arrivals > rec.expected:
            raise AssertionError(
                f"{succ_tc.name}{succ_locals}: {rec.arrivals} arrivals "
                f"exceed the expected {rec.expected} task-fed inputs")
        if copy is not None and rec.inputs.get(flow_name) is not None:
            # JDF forbids data gathers: a data flow has exactly one source
            raise RuntimeError(
                f"{succ_tc.name}{succ_locals}: data flow {flow_name!r} "
                "received two copies — range deps may only gather CTL")
        rec.inputs[flow_name] = copy
        if source is not None:
            rec.sources[flow_name] = source
        if rec.arrivals >= rec.expected:
            return REMOVE, rec
        return rec, None

    rec = taskpool.deps_table.mutate(key, fn)
    if rec is None:
        return None
    task = Task(succ_tc, taskpool, rec.locals)
    if taskpool.dynamic:
        # dynamically-discovered pools count tasks as they materialize
        # (reference: dynamic termdet, ptgpp --dynamic-termdet); the +1
        # precedes the producer's -1 in complete_execution, so the count
        # cannot transiently hit zero mid-discovery — and dynamic pools
        # never ride the C chain, so the locked move is correctness-only
        taskpool.termdet.taskpool_addto_nb_tasks(  # lint: ignore[PCL-HOT]
            taskpool, 1)
    task.data.update(rec.inputs)
    task.pinned_flows.update(k for k, v in rec.inputs.items()
                             if v is not None)
    task.input_sources.update(rec.sources)
    _rec_pool.release(rec)
    return task


def prepare_input(es, task: Task) -> None:
    """Bind every input flow to a concrete data copy
    (reference: generated data_lookup, jdf2c.c:43).

    Task-fed flows were bound at delivery time; collection reads resolve
    through the coherency protocol; NEW flows allocate from the arena.
    """
    tp = task.taskpool
    tc = task.task_class
    data = task.data
    # flows with no input deps can only bind None (class-partitioned
    # once, core/task.py); the resolution loop walks the rest
    for name in tc._noin_flow_names:
        if name not in data:
            data[name] = None
    for flow in tc._in_flows:
        if flow.name in task.data:
            continue
        dep = flow.active_input(task.locals)
        if dep is None or isinstance(dep.end, Null):
            task.data[flow.name] = None
            continue
        end = dep.end
        if isinstance(end, FromDesc):
            ref = end.ref_fn(task.locals)
            datum = ref.resolve()
            copy = datum.copy_on(0)
            if copy is None:
                raise RuntimeError(f"{task}: no host copy for {ref}")
            # Bind only; coherency (and any pull) is resolved at the
            # execution site — stage_in_host for CPU incarnations, the
            # device module's stage-in for accelerator ones — so a tile
            # resident on the device that will run the task moves zero
            # bytes (reference: the data_lookup / stage_in split).
            dtt = as_dtt(dep.dtt)
            if dtt is not None and needs_reshape(copy, dtt):
                # converting read from the collection (reference:
                # parsec_get_copy_reshape_from_desc)
                copy = tp.reshape.get_copy(copy, dtt)
            task.data[flow.name] = copy
        elif isinstance(end, New):
            arena = tp.arenas.get(end.arena_name)
            if arena is None:
                raise RuntimeError(
                    f"{task}: flow {flow.name} needs arena "
                    f"{end.arena_name!r} but the taskpool has none")
            copy = arena.get_copy()
            # the buffer is torch.empty scratch: nothing may read it before
            # the first write, so a device incarnation can materialize it
            # directly in device memory (see CudaDevice._stage_in)
            copy.flags |= FLAG_SCRATCH
            task.data[flow.name] = copy
        elif isinstance(end, FromTask):
            if dep.multiplicity(task.locals) == 0:
                # empty JDF range at a boundary instance: no edge, no data
                task.data[flow.name] = None
                continue
            raise RuntimeError(
                f"{task}: task-fed flow {flow.name} reached prepare_input "
                f"unbound — activation protocol error")
        else:
            task.data[flow.name] = None


def stage_in_host(task: Task) -> None:
    """Make every bound data flow valid on the host before a CPU body runs
    (the host-side analog of the device module's stage-in; reference:
    generated data_lookup resolving CPU-side copies).  Pulls from a
    newer device-resident copy when one exists and rebinds the flow to
    the host copy so in-place tensor mutation works.

    A bound copy that is no longer attached to its datum is a
    version-pinned snapshot: a same-wavefront ``-> DATA`` writeback
    superseded it (see _writeback), and the consumer must read the
    snapshot — not the datum's newer copy (reference: repo-pinned
    versioned copies, datarepo.h:50-58)."""
    for flow in task.task_class.flows:
        copy = task.data.get(flow.name)
        if copy is None or copy.data is None:
            continue
        # a chain-held device task's output reaching a CPU body: run the
        # held chain now (devices/cuda.py Deferred)
        copy.payload = materialize(copy.payload)
        datum = copy.data
        with datum._lock:
            if copy.flags & FLAG_COW:
                # materialize the private buffer before the body writes
                copy.payload = private_host(copy.payload)
                copy.flags &= ~FLAG_COW
            if copy.is_pinned_snapshot(flow.name in task.pinned_flows):
                # read the bound payload, never the datum's newer copy
                if flow.access & ACCESS_WRITE:
                    # the snapshot payload may alias storage other pinned
                    # readers hold (e.g. the old backing view): a writing
                    # body must get a private buffer
                    copy.payload = private_host(copy.payload)
                else:
                    copy.payload = to_host(copy.payload)
                continue
            host = datum.copy_on(0)
            if host is None:
                host = datum.create_copy(0)
            src = datum.transfer_ownership(0, flow.access)
            if src is not None:
                hp = host.payload
                sp = src.payload = materialize(src.payload)
                if isinstance(hp, torch.Tensor) and hp.device.type == "cpu" \
                        and hp.shape == sp.shape and hp.dtype == sp.dtype:
                    if sp.is_cuda:
                        host_read_fence(sp)
                    hp.copy_(sp)   # D2H lands in the backing view
                else:
                    host.payload = private_host(src.payload)
                host.version = src.version
            elif host.payload is None and copy.payload is not None \
                    and copy is not host:
                host.payload = private_host(copy.payload)
                host.version = copy.version
        task.data[flow.name] = host


def _writeback(task: Task, flow: Flow, copy: DataCopy, ref,
               dtt=None) -> None:
    """Return a produced copy to its collection datum (``-> A(m, n)``).

    A copy that already belongs to the datum needs NO data movement — in
    particular a device-resident copy simply stays the authoritative
    version (the reference keeps GPU copies resident until eviction or
    flush, not eagerly D2H on every output dep); host readers pull it
    lazily via Data.pull_to_host.  Only a copy of a *different* datum
    (arena temporaries, COW duplicates) is physically written back.

    The write-back NEVER mutates the existing host copy's storage: a
    same-wavefront reader bound to that copy would observe the new value
    mid-read (the stencil Gauss–Seidel contamination).  Instead the old
    host copy is detached — surviving, version-pinned, for any consumer
    already holding it — and a fresh copy with a private payload becomes
    the datum's new authoritative version (reference: versioned
    data-copies + repo refcount protocol, datarepo.h:50-58).
    """
    datum = ref.resolve()
    home_dtype = getattr(datum.collection, "dtype", None)
    if copy.data is datum and datum.copy_on(copy.device) is copy \
            and (dtt is None or not needs_reshape(copy, dtt)) \
            and (dtt is None or dtt.inverse is None) \
            and (home_dtype is None or
                 getattr(copy.payload, "dtype", home_dtype) == home_dtype):
        # attached and already in home type: in place (host) or
        # device-resident (lazy pull-home).  A DETACHED copy of the same
        # datum is a superseded snapshot a WRITE body mutated privately —
        # its value must still land below or the update is silently lost;
        # an edge-layout (dtt) copy — or a body that rebound the attached
        # copy to the EDGE dtype (dtype-only OUT dtt) — must be converted
        # home below or the collection silently keeps the stale value.
        return
    if dtt is not None:
        # reshape-on-writeback: undo the edge's layout transform
        # (reference: the reverse reshape of parsec_reshape.c remote/
        # local writeback paths)
        arr = private_host(convert(copy.payload, dtt, inverse=True))
    else:
        arr = private_host(copy.payload)
    # ToDesc writeback is statically OFF the C chain (OBAIL): this lock
    # guards the descriptor's copy table on the Python-only path
    with datum._lock:   # lint: ignore[PCL-HOT]
        old = datum.copy_on(0)
        # the collection's dtype is authoritative at home; the old host
        # copy's dtype is only a fallback — the body may have rebound
        # that copy to the EDGE dtype already (dtype-only OUT dtt)
        want = home_dtype if home_dtype is not None else \
            (getattr(old.payload, "dtype", None) if old is not None
             else None)
        if want is not None and arr.dtype != want:
            # the collection's dtype is authoritative at home (bf16
            # compute edges land back in the f32 collection)
            arr = arr.to(want)
        check_versions = paranoid(2)   # sample ONCE: the tier may move
        old_v = datum.newest_version() if check_versions else 0
        datum.detach_copy(0)   # readers keep their pinned snapshot
        for c in datum.copies().values():
            c.coherency = Coherency.INVALID
        host = DataCopy(datum, 0, payload=arr,
                        coherency=Coherency.EXCLUSIVE)
        datum.attach_copy(host)
        datum._version_clock += 1
        host.version = datum._version_clock
        if check_versions and host.version <= old_v:
            raise AssertionError(
                f"writeback of {datum} did not advance the version clock "
                f"({old_v} -> {host.version})")
    # the user-visible backing array re-links at quiescence, when no
    # pinned reader of the old view can still be in flight
    if datum.collection is not None:
        task.taskpool.dirty_data.add(datum)


def release_deps(es, task: Task) -> List[Task]:
    """Evaluate output deps of a completed task, deliver to successors,
    manage repo lifetime; return newly-ready local tasks
    (reference: generated release_deps + iterate_successors,
    jdf2c.c:7175,7631 -> parsec.c:1783)."""
    tp = task.taskpool
    tc = task.task_class
    myrank = tp.context.rank if tp.context else 0
    grapher = tp.context.grapher if tp.context else None
    ready: List[Task] = []
    consumers = 0
    entry = None
    #: arena-backed copies whose only consumers are remote: nothing local
    #: creates a repo entry for them, so they are returned to the freelist
    #: once flush_activations has snapshotted the payload
    remote_only_arena: List[DataCopy] = []
    #: minimal-replay restart gate (core/recovery.py): local deliveries
    #: to consumers outside the replay plan are redundant re-sends of
    #: already-materialized work — skipping them HERE (not in
    #: deliver_dep) also keeps them out of the repo usage count, so the
    #: producer's entry still retires.  Remote activations always fire;
    #: the receiving rank's own filter decides there.
    replay_filter = tp._replay_filter

    # only flows with output deps can deliver anything (class-level
    # partition, core/task.py): a CTL-only or sink flow skips the whole
    # delivery bookkeeping below
    for flow in tc._out_flows:
        copy = task.data.get(flow.name)
        # gather this flow's local deliveries first: a copy fanning out to
        # several consumers must hand any WRITE-consumer a copy-on-write
        # duplicate, or its in-place update races the other readers
        # (reference: data-copy duplication for RW flows on shared copies)
        local_deliveries: List[Tuple] = []
        remote_count = 0
        for dep in flow.active_outputs(task.locals):
            end = dep.end
            if isinstance(end, ToDesc):
                if copy is not None:
                    _writeback(task, flow, copy, end.ref_fn(task.locals),
                               dtt=as_dtt(dep.dtt))
            elif isinstance(end, ToTask):
                succ_tc = tp.task_classes[end.task_class]
                for succ_locals in end.instances(task.locals):
                    # dep expressions address peers by free params; fill
                    # derived ones NOW — rank_of/make_key below may need
                    # them (e.g. an affinity over a derived local)
                    succ_locals = succ_tc.complete_locals(succ_locals)
                    if grapher is not None:
                        grapher.edge(task, succ_tc.make_key(succ_locals),
                                     flow.name)
                    if succ_tc.rank_of(succ_locals) != myrank:
                        tp.context.remote_dep_activate(
                            es, task, flow, dep, succ_tc, succ_locals, copy)
                        remote_count += 1
                        continue
                    if replay_filter is not None and \
                            succ_tc.make_key(succ_locals) \
                            not in replay_filter:
                        continue   # consumer not re-enumerated (minimal)
                    local_deliveries.append(
                        (succ_tc, succ_locals, end.flow, dep))
            # Null outputs: data is discarded (arena copies will be
            # released by the repo retirement below, or were views)
        total = len(local_deliveries) + remote_count
        if remote_count and not local_deliveries and copy is not None \
                and copy.arena is not None:
            remote_only_arena.append(copy)
        if copy is None and total > 0 and flow.access != 0:
            # a data (non-CTL) flow handing None downstream: legal — the
            # successor's input binds NULL — but almost always a graph
            # bug, so flag it like the reference does (ptgpp
            # forward_{READ,RW}_NULL golden behavior)
            warning("A NULL is forwarded from %s flow %s to %d "
                    "successor(s)", task, flow.name, total)
        ici = tp.context.ici if tp.context is not None else None
        if copy is not None and ici is not None and local_deliveries \
                and (len(local_deliveries) > 1
                     or ici.device_resident(copy)):
            # Fan-out onto DISTINCT consumer modules: one broadcast; a
            # single distinct target (one consumer, or several sharing a
            # module): one proactive put that overlaps with scheduling
            # (reference: dataflow bcast trees remote_dep.c:334-357 and
            # the CE put; comm/ici.py).  Host-resident single-consumer
            # edges skip the affinity resolution entirely; multi-consumer
            # fan-outs qualify even from host (one replication beats N
            # separate stage-ins)
            uniq = set(ici.consumer_spaces(
                tp, [d[:3] for d in local_deliveries]))
            uniq.discard(copy.device)
            if len(uniq) > 1:
                ici.prebroadcast(copy, sorted(uniq))
            elif len(uniq) == 1:
                # single-consumer edge: defer so the whole DAG wavefront
                # rides one batched permute round instead of N puts
                sp = uniq.pop()
                if not ici.defer_place(copy, sp, tp):
                    ici.preplace(copy, sp)
        for succ_tc, succ_locals, dflow, odep in local_deliveries:
            dcopy = copy
            if copy is not None:
                # edge datatype: the consumer's IN dtt wins, else the
                # producer's OUT dtt (reference: receiver-side datatype
                # lookup, remote_dep_get_datatypes)
                edge_dtt = _edge_dtt(succ_tc, dflow, succ_locals) \
                    or as_dtt(odep.dtt)
                if edge_dtt is not None and needs_reshape(copy, edge_dtt):
                    dcopy = tp.reshape.get_copy(copy, edge_dtt)
            if dcopy is not None and total > 1 and \
                    succ_tc.flow(dflow).access & ACCESS_WRITE:
                dcopy = _cow_copy(dcopy)
            if entry is None and copy is not None:
                entry = tc.repo.lookup_entry_and_create(task.key)
            if copy is not None:
                if entry.copies[flow.flow_index] is not copy \
                        and copy.arena is not None:
                    # entry hold on the arena buffer: a NEW-flow copy
                    # chained through several tasks lives in every
                    # producer's entry, and only the LAST retirement may
                    # return it to the freelist (reference: refcounted
                    # repo copies, datarepo.h:50-58)
                    copy.arena.retain_copy(copy)
                entry.copies[flow.flow_index] = copy
                consumers += 1
            src = (tc, task.key) if copy is not None else None
            es.pins("deliver_dep", (task, succ_tc, succ_locals, dflow))
            t = deliver_dep(tp, succ_tc, succ_locals, dflow, dcopy, src)
            if t is not None:
                ready.append(t)

    if entry is not None:
        entry.on_retire = _make_retire(task)
        tc.repo.entry_addto_usage_limit(task.key, consumers)

    # dynamically-discovered pools (DTD) resolve successors from their
    # runtime dep graph rather than from flow expressions
    dynamic = getattr(tp, "dynamic_release", None)
    if dynamic is not None:
        ready.extend(dynamic(es, task))

    # ship buffered remote activations as one message per flow down the
    # bcast tree (reference: parsec_remote_dep_activate after
    # iterate_successors filled the rank bitmask).  This is also the send
    # snapshot: each outgoing payload is copied home here, before the
    # local successors in ``ready`` are scheduled, so no in-place
    # successor can have written the tile yet (comm/remote_dep.py)
    if tp.context is not None and tp.context.comm is not None:
        tp.context.comm.flush_activations(es, task)
        # flush snapshotted every outgoing payload synchronously: arena
        # temporaries with no local consumer can go home now — unless an
        # earlier producer's repo entry still holds the chained buffer
        for copy in remote_only_arena:
            if copy.data is not None:
                copy.data.detach_copy(copy.device)
            copy.arena.release_unheld(copy)
    return ready


def _edge_dtt(succ_tc: TaskClass, dflow: str, succ_locals: Dict[str, int]):
    """The consumer-side dtt of a task-fed edge, if any."""
    flow = succ_tc.flow(dflow)
    if flow is None:
        return None
    dep = flow.active_input(succ_locals)
    return as_dtt(dep.dtt) if dep is not None else None


def _cow_copy(copy: DataCopy) -> DataCopy:
    """A lazily-duplicating alias of ``copy``: shares the payload now, but
    carries FLAG_COW so the execution site (stage_in_host, or the device
    stage-in) materializes a private buffer before any write or donation."""
    datum = Data(nb_elts=copy.data.nb_elts if copy.data is not None else 0)
    # registered at host index regardless of where the shared payload
    # lives: both stage_in_host and the device stage-in then see it as
    # "the newest copy" and materialize a private buffer from it
    c = DataCopy(datum, 0, payload=copy.payload,
                 coherency=Coherency.EXCLUSIVE, version=1)
    c.flags = FLAG_COW
    datum.attach_copy(c)
    return c


def _make_retire(task: Task):
    def retire(entry):
        for copy in entry.copies:
            if copy is not None and copy.arena is not None:
                copy.arena.drop_copy(copy)
    return retire


def consume_inputs(task: Task) -> None:
    """Release our holds on predecessor repo entries
    (reference: data_repo_entry_used_once calls in generated release_deps)."""
    for flow_name, (ptc, pkey) in task.input_sources.items():
        ptc.repo.entry_used_once(pkey)
