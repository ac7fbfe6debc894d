"""Taskpools: DAG containers with lifecycle and termination detection.

Rebuild of the reference's taskpool object
(reference: parsec/parsec_internal.h:119-161 ``parsec_taskpool_t``,
scheduling.c:678-727 add_taskpool, compound.c): a taskpool owns task
classes, global symbols, arenas, and the two termination counters
(``nb_tasks`` = known-but-unexecuted tasks, ``nb_pending_actions`` =
runtime activities incl. the pool's own startup hold).  ``Compound``
chains taskpools sequentially by completion callbacks.

``ParameterizedTaskpool`` is the engine behind the PTG front-end: its
startup hook enumerates the parameter space, counts local tasks, and
schedules dependency-free ones (reference: generated startup,
jdf2c.c:2989,4398).
"""

from __future__ import annotations

import itertools
import threading
from enum import IntEnum
from typing import Any, Callable, Dict, List, Optional, Sequence

from parsec_tpu_torch.containers.hash_table import ConcurrentHashTable
from parsec_tpu_torch.data.arena import Arena
from parsec_tpu_torch.data.datarepo import DataRepo
from parsec_tpu_torch.core.task import Task, TaskClass

_tp_ids = itertools.count(1)

_ndep_cls = None


def _native_dep_table():
    """A native dep-countdown table (schedext.DepTable) when the
    scheduler hot path is on, else None — the per-pool gate
    engine.deliver_dep dispatches on.  The class resolves once per
    process (a failed build raises, native.NativeBuildError); the
    ``sched_native`` knob stays a live read so an A/B flip affects pools
    created after it."""
    global _ndep_cls
    from parsec_tpu_torch.utils.mca import params
    if not int(params.get("sched_native", 1)):
        return None
    if _ndep_cls is None:
        from parsec_tpu_torch.native import load_schedext
        _ndep_cls = load_schedext().DepTable
    return _ndep_cls()


class TaskpoolState(IntEnum):
    CREATED = 0
    ATTACHED = 1
    RUNNING = 2
    DONE = 3


class Taskpool:
    """Base taskpool (reference: parsec_taskpool_t)."""

    #: dynamically-discovered pools count tasks into nb_tasks as they are
    #: instantiated (engine.deliver_dep) instead of at startup enumeration
    dynamic = False

    def __init__(self, name: str = "taskpool",
                 globals_: Optional[Dict[str, Any]] = None):
        self.taskpool_id = next(_tp_ids)
        self.name = name
        self.globals = dict(globals_ or {})
        self.context = None
        self.termdet = None
        self.state = TaskpoolState.CREATED
        self.nb_tasks = 0              # mutated only through termdet
        self.nb_pending_actions = 0    # idem
        #: name of the termdet module this pool wants instead of the
        #: context default (e.g. "user_trigger"; reference: DSLs install
        #: their own termdet before parsec_context_add_taskpool)
        self.termdet_name: Optional[str] = None
        self.task_classes: Dict[str, TaskClass] = {}
        self.arenas: Dict[str, Arena] = {}
        #: dep-countdown records for not-yet-ready tasks; the native
        #: twin (schedext.DepTable) replaces it wholesale when the
        #: scheduler hot path is on — ONE of the two holds this pool's
        #: records, selected once at construction (engine.deliver_dep)
        self.deps_table = ConcurrentHashTable()
        self._native_deps = _native_dep_table()
        #: collection datums whose host copy a writeback replaced; their
        #: user-visible backing re-links at termination (engine._writeback)
        self.dirty_data: set = set()
        #: reshape promises: one shared conversion per (copy, dtt) edge
        #: (reference: parsec_reshape.c promise table)
        from parsec_tpu_torch.data.reshape import ReshapeCache
        self.reshape = ReshapeCache()
        #: extensible per-pool info slots (reference: the info object
        #: array hung off parsec_taskpool_t, class/info.h)
        from parsec_tpu_torch.utils.info import InfoObjectArray, \
            taskpool_info
        self.info = InfoObjectArray(taskpool_info, owner=self)
        self._complete_cbs: List[Callable[["Taskpool"], None]] = []
        self._done_event = threading.Event()
        #: pool-wide priority bias added to every task's priority — the
        #: job-service fairness lever: per-job priority rides into the
        #: priority schedulers (sched/local_queues pbq/ltq/lhq) so
        #: concurrent jobs interleave by weight instead of FIFO order
        self.priority = 0
        #: cancellation flag: workers discard (not execute) tasks of a
        #: cancelled pool, and the termdet clamps its counters at zero
        self.cancelled = False
        #: owning job id when enqueued through the job service (tags
        #: PINS events / per-job gauges); None for plain batch pools
        self.job_id: Optional[int] = None
        #: per-pool error route: when set, task errors of this pool go
        #: here instead of poisoning the whole context
        #: (``sink(exc, task)``; see Context.record_error)
        self.error_sink: Optional[Callable] = None
        #: ranks this pool exchanged traffic with (filled by the comm
        #: layer) — peer-death containment fails exactly the pools whose
        #: dataflow touches the dead rank (RemoteDepEngine._on_peer_dead)
        self.peer_ranks: set = set()
        #: recovery generation (core/recovery.py): bumped when a peer
        #: death restarts this pool on the survivors.  Tasks stamp it at
        #: construction (Task.pool_epoch); stale-generation tasks and
        #: counter decrements are fenced at task_progress /
        #: complete_execution, and cross-rank activations carry it so a
        #: survivor mid-restart parks frames from an already-recovered
        #: peer instead of losing them
        self.run_epoch = 0
        #: recovery spec: the collections this pool's dataflow reads and
        #: writes (builders set it; core/recovery.py snapshots/restores
        #: them) and, for insert-driven pools, a replay callable that
        #: re-inserts the lost work.  Empty/None = not recoverable —
        #: peer death keeps the containment behavior
        self.recovery_collections: list = []
        self.recovery_replay: Optional[Callable] = None
        #: recorded lineage log (core/recovery.LineageLog), installed by
        #: the RecoveryCoordinator at registration when the lineage
        #: plane is on.  None keeps complete_execution's hook at one
        #: attribute load + None check; the C chain reads it off every
        #: pool (native/schedext.c gates_for) and hands a pool that has
        #: one back to Python, where the record is taken
        self._lineage = None
        #: minimal-replay enumeration filter (core/recovery.py): during
        #: a minimal restart only keys in this set re-enumerate,
        #: re-deliver locally, and accept remote deliveries — every
        #: other delivery of the restarted generation is a redundant
        #: re-send of already-materialized work and drops.  None (the
        #: pristine and full-replay states) disables the gate
        self._replay_filter: Optional[set] = None
        #: GLOBALLY done: set once a distributed run passes global
        #: quiescence after this pool completed (Context.wait), or the
        #: recovery plane's RETIREMENT HANDSHAKE confirmed every live
        #: rank locally complete.  A pool that completed only LOCALLY
        #: stays restartable — another survivor may still need its
        #: re-executed partition; a retired one is never resurrected by
        #: recovery
        self.retired = False
        #: memory-space indices this pool's tasks may execute on.  None =
        #: unrestricted; a frozenset restricts DeviceRegistry.best_device
        self.device_spaces: Optional[frozenset] = None

    # -- construction ------------------------------------------------------
    def add_task_class(self, tc: TaskClass) -> TaskClass:
        tc.task_class_id = len(self.task_classes)
        tc.taskpool = self
        tc.repo = DataRepo(nb_flows=len(tc.flows), name=tc.name)
        self.task_classes[tc.name] = tc
        return tc

    def add_arena(self, name: str, arena: Arena) -> None:
        self.arenas[name] = arena

    def on_complete(self, cb: Callable[["Taskpool"], None]) -> None:
        self._complete_cbs.append(cb)

    # -- lifecycle (driven by the Context) ---------------------------------
    def attach(self, context, termdet) -> None:
        """Install termination detection and take the startup hold
        (reference: parsec_context_add_taskpool, scheduling.c:692-697)."""
        self.context = context
        self.termdet = termdet
        termdet.monitor(self, self._terminated)
        # the pool holds one pending action until startup completed, so an
        # empty pool cannot terminate before being made ready
        termdet.taskpool_addto_runtime_actions(self, 1)
        self.state = TaskpoolState.ATTACHED

    def startup(self) -> List[Task]:
        """Produce the initial ready tasks; return them for scheduling.
        Subclasses implement enumeration; base pools start empty."""
        return []

    def recovery_reset(self) -> None:
        """Drop every in-flight dependency/repo structure so the pool
        can re-enumerate from restored collection state (called by the
        RecoveryCoordinator AFTER the run_epoch bump fenced stale tasks
        and the termdet counters were rewound)."""
        self.deps_table = ConcurrentHashTable()
        self._native_deps = _native_dep_table()
        for tc in self.task_classes.values():
            tc.repo = DataRepo(nb_flows=len(tc.flows), name=tc.name)
        self.reshape.clear()
        self.dirty_data.clear()
        self.peer_ranks = set()
        # the torn generation's lineage describes pre-restart state;
        # the new generation records afresh.  The replay filter is
        # (re)installed by the coordinator AFTER this reset when the
        # restart is minimal — None here is the full-replay default
        if self._lineage is not None:
            self._lineage.clear()
        self._replay_filter = None

    def ready(self) -> None:
        """Startup done: drop the hold and let termination fire
        (reference: parsec_taskpool_enable / termdet ready)."""
        self.state = TaskpoolState.RUNNING
        self.termdet.taskpool_ready(self)
        self.termdet.taskpool_addto_runtime_actions(self, -1)

    def _terminated(self) -> None:
        self.state = TaskpoolState.DONE
        for datum in self.dirty_data:
            if datum.collection is not None:
                datum.collection.refresh_backing(datum)
        self.dirty_data.clear()
        self.reshape.clear()
        cbs = list(self._complete_cbs)
        for cb in cbs:
            cb(self)
        if self.context is not None:
            self.context._taskpool_terminated(self)
        self._done_event.set()

    def cancel(self) -> None:
        """Cancel the pool: undelivered tasks are dropped at selection
        (scheduling.task_progress discards tasks of cancelled pools) and
        the termdet is force-quiesced so termination fires without the
        remaining counts draining naturally.  In-flight tasks finish
        their current execution; their late counter decrements clamp at
        zero (termdet tolerates cancelled pools).  Idempotent, callable
        from any thread."""
        self.cancelled = True
        if self.state == TaskpoolState.DONE:
            return
        if self.termdet is not None and self.state != TaskpoolState.CREATED:
            self.termdet.taskpool_force_quiesce(self)
        else:
            # never attached: nothing was scheduled, close out locally
            self.state = TaskpoolState.DONE
            self._done_event.set()

    def wait_local(self, timeout: Optional[float] = None) -> bool:
        return self._done_event.wait(timeout)

    @property
    def completed(self) -> bool:
        return self.state == TaskpoolState.DONE

    def __repr__(self):
        return f"<Taskpool {self.name}#{self.taskpool_id} {self.state.name}>"


class ParameterizedTaskpool(Taskpool):
    """Taskpool whose DAG is a parameterized (problem-size-independent)
    graph — the PTG execution engine.  Each rank enumerates only its own
    tasks (owner computes)."""

    def startup(self) -> List[Task]:
        myrank = self.context.rank if self.context else 0
        nb_local = 0
        ready: List[Task] = []
        append = ready.append
        flt = self._replay_filter
        for tc in self.task_classes.values():
            aff = tc.affinity
            if aff is None and myrank != 0:
                continue   # rank_of is the constant 0: nothing local
            # classes with no task-fed inputs skip the per-instance
            # countdown probe entirely (class-level partition, task.py)
            all_ready = not tc._ft_inputs
            vt = tc.native_vt()
            if vt is not None and all_ready and aff is None \
                    and flt is None and tc.key_fn is None \
                    and len(tc.params) == 1:
                # flat dep-free class (the independent-task shape):
                # enumerate AND construct directly from the parameter
                # range in C — Python Task.__init__ and the per-
                # instance dict build leave the startup hot loop
                # entirely (schedext.TaskVT.build_range)
                space = tc.params[0][1](self.globals, {})
                if isinstance(space, range):
                    tasks = vt.build_range(tc.params[0][0], space.start,
                                           space.stop, space.step)
                else:
                    name = tc.params[0][0]
                    tasks = vt.build_batch([{name: v} for v in space])
                nb_local += len(tasks)
                ready.extend(tasks)
                continue
            build = vt.build_one if vt is not None else None
            for locals_ in tc.iter_space(self.globals):
                # owner-computes through the recovery translation: a
                # dead rank's partition enumerates on its adopting
                # survivor at re-execution (TaskClass.rank_of applies
                # the same table on the activation-routing side)
                if aff is not None and tc.rank_of(locals_) != myrank:
                    continue
                if flt is not None and tc.make_key(locals_) not in flt:
                    # minimal-replay restart: this task's outputs are
                    # intact and nothing in the plan consumes them —
                    # skip the re-execution entirely
                    continue
                nb_local += 1
                if all_ready or tc.nb_task_inputs(locals_) == 0:
                    # iter_space yields a fresh dict per instance, so
                    # the C constructor may alias it (build_one)
                    append(build(locals_) if build is not None
                           else Task(tc, self, locals_))
        if nb_local:
            self.termdet.taskpool_addto_nb_tasks(self, nb_local)
        return ready


class DynamicTaskpool(ParameterizedTaskpool):
    """Dynamically-discovered PTG pool (reference: ``%option dynamic``
    / ptgpp --dynamic-termdet, interfaces/ptg/ptg-compiler/main.c:28-44;
    the JDF customer is tests/apps/haar_tree/project_dyn.jdf): the
    parameter space is too large or unknowable to enumerate, so startup
    does NO enumeration — task classes carrying a ``startup_fn`` property
    seed the DAG (the reference's generated-startup replacement,
    project_dyn.jdf:109-159), every task discovered at runtime is counted
    into ``nb_tasks`` the moment it is instantiated (engine.deliver_dep),
    and termination fires when the in-flight count drains — dynamic
    termination detection.  Bodies may overwrite derived locals on
    ``task.locals`` (this_task->locals.X.value in the reference) to prune
    output guards at runtime."""

    dynamic = True

    def attach(self, context, termdet) -> None:
        super().attach(context, termdet)
        if context is not None and getattr(context, "comm", None) \
                is not None:
            # Distributed dynamic pools must NOT terminate on a local
            # zero count: a rank whose tasks all arrive by remote
            # discovery would fire termination before the first
            # activation lands, and a rank that transiently drains to
            # zero while a discovery message is in flight would
            # terminate early.  The pool takes a permanent runtime-action
            # hold, released only when the comm layer's pool-scoped Safra
            # round proves every rank drained with no discovery in
            # flight (RemoteDepEngine.resolve_dynamic_holds).
            self._dyn_hold = True
            termdet.taskpool_addto_runtime_actions(self, 1)
            context.comm.register_dynamic_hold(self)

    def startup(self) -> List[Task]:
        myrank = self.context.rank if self.context else 0
        ready: List[Task] = []
        for tc in self.task_classes.values():
            fn = tc.properties.get("startup_fn")
            if fn is None:
                continue
            for seed in fn(self.globals, myrank):
                locals_ = tc.complete_locals(dict(seed))
                ready.append(Task(tc, self, locals_))
        if ready:
            self.termdet.taskpool_addto_nb_tasks(self, len(ready))
        return ready


class Compound(Taskpool):
    """Sequential composition (reference: parsec_compose, compound.c):
    completion of pool N enqueues pool N+1."""

    def __init__(self, pools: Sequence[Taskpool], name: str = "compound"):
        super().__init__(name=name)
        self.pools = list(pools)
        self._idx = 0
        self._clock = threading.Lock()
        self._driving = False

    def attach(self, context, termdet) -> None:
        super().attach(context, termdet)
        # the compound holds one action per sub-pool still to run
        termdet.taskpool_addto_runtime_actions(self, len(self.pools))

    def startup(self) -> List[Task]:
        self._drive()
        return []

    def _drive(self) -> None:
        """Launch sub-pools iteratively.  Empty/instantly-completing pools
        fire their completion callback synchronously inside add_taskpool;
        the _driving flag turns that reentrancy into a loop iteration
        instead of recursion, so long compositions cannot overflow the
        stack."""
        while True:
            with self._clock:
                if self._driving or self._idx >= len(self.pools) \
                        or self.cancelled:
                    return
                self._driving = True
                launched = self._idx
                pool = self.pools[launched]
            pool.on_complete(self._sub_done)
            # recovery must never restart a compound member once it
            # completed: a re-fired completion would double-advance the
            # composition's cursor
            pool._compound_member = True
            self.context.add_taskpool(pool, start=True)
            # cancel() racing this launch saw the sub-pool CREATED and
            # skipped it; it set our flag BEFORE reading the state, so
            # re-checking after attach closes the window
            if self.cancelled and not pool.cancelled:
                pool.cancel()
            with self._clock:
                self._driving = False
                advanced = self._idx > launched
            if not advanced:
                return   # still running; its completion re-enters _drive

    def _sub_done(self, pool: Taskpool) -> None:
        with self._clock:
            self._idx += 1
            driving = self._driving
        self.termdet.taskpool_addto_runtime_actions(self, -1)
        if not driving:
            self._drive()

    def cancel(self) -> None:
        """Cancel the composition: the active sub-pool is cancelled,
        not-yet-launched sub-pools never start (_drive checks the flag),
        and the compound's own held actions are force-quiesced."""
        self.cancelled = True
        with self._clock:
            active = (self.pools[self._idx]
                      if self._idx < len(self.pools) else None)
        if active is not None and active.state not in (
                TaskpoolState.CREATED, TaskpoolState.DONE):
            active.cancel()
        super().cancel()


def compose(*pools: Taskpool) -> Compound:
    """parsec_compose equivalent; flattens nested compounds."""
    flat: List[Taskpool] = []
    for p in pools:
        if isinstance(p, Compound):
            flat.extend(p.pools)
        else:
            flat.append(p)
    return Compound(flat)
