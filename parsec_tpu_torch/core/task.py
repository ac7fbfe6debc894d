"""Task model: task classes, flows, dependencies, task instances.

Rebuild of the reference's task-class vtable
(reference: parsec/parsec_internal.h:381-425 ``parsec_task_class_t``): a
TaskClass describes one parameterized family of tasks — its parameter
space, its data flows with guarded input/output dependencies, its affinity
(owner-computes placement), and its per-device-type incarnations (hooks).
A Task is one instantiation with concrete parameter values.

Dependency endpoints mirror the JDF notions (reference:
interfaces/ptg/ptg-compiler/jdf.h): a flow input comes from another task's
output flow, from the data collection (``A(k)``), from a fresh arena
allocation (NEW), or nowhere (NULL); outputs symmetrically go to successor
tasks and/or back to the collection.
"""

from __future__ import annotations

import itertools
from enum import IntEnum
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

from parsec_tpu_torch.data.data import (ACCESS_NONE, ACCESS_READ, ACCESS_RW,
                                  ACCESS_WRITE, DataCopy)
from parsec_tpu_torch.data.collection import DataRef


class HookReturn(IntEnum):
    """Hook return codes (reference: parsec_hook_return_t)."""
    DONE = 0       # body executed, completion may proceed
    AGAIN = 1      # reschedule this task later (with fairness distance)
    ASYNC = 2      # device took ownership; completion arrives asynchronously
    NEXT = 3       # this incarnation declined; try the next chore
    DISABLE = 4    # disable this incarnation for the whole task class
    ERROR = -1


def normalize_body_outputs(ret: Any, writable: Sequence[str],
                           what: str = "body") -> Dict[str, Any]:
    """Normalize a functional body/kernel return value to {flow: value}.

    Shared by CPU bodies and device kernels so both incarnations of a task
    class follow one convention: a dict keyed by flow name, a tuple in
    written-flow declaration order, or a single value when exactly one
    flow is written.
    """
    if isinstance(ret, dict):
        return ret
    if isinstance(ret, (tuple, list)):
        if len(ret) != len(writable):
            raise ValueError(
                f"{what} returned {len(ret)} values for "
                f"{len(writable)} written flows {list(writable)}")
        return dict(zip(writable, ret))
    if len(writable) != 1:
        raise ValueError(
            f"{what} returned one value but writes {list(writable)}")
    return {writable[0]: ret}


# --------------------------------------------------------------------------
# Dependency endpoints
# --------------------------------------------------------------------------

class DepEnd:
    """Base endpoint of a dependency edge."""
    __slots__ = ()


class _TaskEnd(DepEnd):
    """Shared base of task-to-task endpoints.  ``params_fn`` may return a
    list of param dicts — the JDF range form (``-> TRSM(k+1..NT, k)`` /
    ``<- CTL First(0..3)``) — in which case the dep represents that many
    edges."""
    __slots__ = ("task_class", "flow", "params_fn")

    def __init__(self, task_class: str, flow: str,
                 params_fn: Callable[[Dict[str, int]], Any]):
        self.task_class = task_class
        self.flow = flow
        self.params_fn = params_fn

    def instances(self, locals_: Dict[str, int]) -> List[Dict[str, int]]:
        res = self.params_fn(locals_)
        return list(res) if isinstance(res, (list, tuple)) else [res]


class FromTask(_TaskEnd):
    """Input comes from task_class.flow of the instance(s) params_fn(locals)
    (reference: jdf dep ``A <- B TASK(k-1)``)."""
    __slots__ = ()


class ToTask(_TaskEnd):
    """Output feeds task_class.flow of the instance(s) params_fn(locals)."""
    __slots__ = ()


class FromDesc(DepEnd):
    """Input read directly from a data collection: ``<- A(k, n)``."""
    __slots__ = ("ref_fn",)

    def __init__(self, ref_fn: Callable[[Dict[str, int]], DataRef]):
        self.ref_fn = ref_fn


class ToDesc(DepEnd):
    """Output written back to the collection: ``-> A(k, n)``."""
    __slots__ = ("ref_fn",)

    def __init__(self, ref_fn: Callable[[Dict[str, int]], DataRef]):
        self.ref_fn = ref_fn


class New(DepEnd):
    """Input is a fresh arena allocation (JDF ``<- NEW``)."""
    __slots__ = ("arena_name",)

    def __init__(self, arena_name: str = "default"):
        self.arena_name = arena_name


class Null(DepEnd):
    """No data (JDF ``<- NULL`` / ``-> NULL``)."""
    __slots__ = ()


NULL = Null()


class Dep:
    """One guarded dependency (reference: jdf_dep_t with guard).

    ``guard(locals) -> bool`` decides applicability; ``end`` is the other
    endpoint; ``dtt`` optionally names the datatype/layout for reshapes;
    ``count(locals)`` is the edge multiplicity for gather deps — the JDF
    range form ``<- CTL First(0..3)`` is one dep representing 4 incoming
    edges, and the dep countdown must expect all of them.
    """
    __slots__ = ("guard", "end", "dtt", "count")

    def __init__(self, end: DepEnd,
                 guard: Optional[Callable[[Dict[str, int]], bool]] = None,
                 dtt: Any = None,
                 count: Optional[Callable[[Dict[str, int]], int]] = None):
        self.end = end
        self.guard = guard
        self.dtt = dtt
        self.count = count

    def applies(self, locals_: Dict[str, int]) -> bool:
        return True if self.guard is None else bool(self.guard(locals_))

    def multiplicity(self, locals_: Dict[str, int]) -> int:
        """Incoming-edge count: explicit ``count`` wins; a range FromTask
        contributes one edge per instance."""
        if self.count is not None:
            return int(self.count(locals_))
        if isinstance(self.end, FromTask):
            return len(self.end.instances(locals_))
        return 1


class Flow:
    """One named data flow of a task class (reference: parsec_flow_t)."""

    __slots__ = ("name", "access", "inputs", "outputs", "flow_index")

    def __init__(self, name: str, access: int,
                 inputs: Sequence[Dep] = (), outputs: Sequence[Dep] = ()):
        self.name = name
        self.access = access
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.flow_index = -1   # assigned by TaskClass

    def active_input(self, locals_: Dict[str, int]) -> Optional[Dep]:
        """The single input dep applying for these params (JDF semantics:
        guards are mutually exclusive)."""
        for dep in self.inputs:
            if dep.applies(locals_):
                return dep
        return None

    def active_outputs(self, locals_: Dict[str, int]) -> List[Dep]:
        return [dep for dep in self.outputs if dep.applies(locals_)]

    @property
    def is_ctl(self) -> bool:
        return self.access == ACCESS_NONE


def RW(name: str, inputs=(), outputs=()) -> Flow:
    return Flow(name, ACCESS_RW, inputs, outputs)


def READ(name: str, inputs=(), outputs=()) -> Flow:
    return Flow(name, ACCESS_READ, inputs, outputs)


def WRITE(name: str, inputs=(), outputs=()) -> Flow:
    return Flow(name, ACCESS_WRITE, inputs, outputs)


def CTL(name: str, inputs=(), outputs=()) -> Flow:
    return Flow(name, ACCESS_NONE, inputs, outputs)


# --------------------------------------------------------------------------
# Task class
# --------------------------------------------------------------------------

class TaskClass:
    """Parameterized task family (reference: parsec_task_class_t).

    ``params``: ordered (name, range_fn) pairs; range_fn(globals, locals)
    yields the values of that parameter given the outer ones — triangular
    spaces like ``m in k+1..NT`` fall out naturally.
    ``affinity``: locals -> DataRef; the task runs on rank_of that datum
    (owner computes, reference: jdf2c.c:2005 affinity generation).
    ``incarnations``: ordered (device_type, hook) preference list
    (reference: __parsec_chore_t).
    """

    def __init__(self, name: str,
                 params: Sequence[Tuple[str, Callable]] = (),
                 affinity: Optional[Callable[[Dict[str, int]], DataRef]] = None,
                 flows: Sequence[Flow] = (),
                 body: Optional[Callable] = None,
                 incarnations: Sequence[Tuple[str, Callable]] = (),
                 priority: Optional[Callable[[Dict[str, int]], int]] = None,
                 properties: Optional[Dict[str, Any]] = None,
                 key_fn: Optional[Callable[[Dict[str, int]], Any]] = None):
        self.name = name
        self.params = list(params)
        #: user-defined key function (reference: the [make_key_fn = ...]
        #: task-class property, tests/dsl/ptg/user-defined-functions/udf.jdf)
        self.key_fn = key_fn
        self.affinity = affinity
        self.flows = list(flows)
        for i, f in enumerate(self.flows):
            f.flow_index = i
        self._flow_by_name = {f.name: f for f in self.flows}
        # hot-path partitions, computed once per CLASS instead of
        # filtered per task instance (flows are fixed at construction;
        # the per-task loops in prepare_input / release_deps /
        # complete_execution walk only the flows that can matter)
        self._in_flows = [f for f in self.flows if f.inputs]
        self._noin_flow_names = [f.name for f in self.flows
                                 if not f.inputs]
        self._out_flows = [f for f in self.flows if f.outputs]
        self._write_flows = [f for f in self.flows
                             if f.access & ACCESS_WRITE]
        #: task-fed input deps only (the dep-countdown universe); an
        #: empty list makes nb_task_inputs O(1) — the dominant case for
        #: independent-task pools is "no task-fed inputs at all"
        self._ft_inputs = [d for f in self.flows for d in f.inputs
                           if isinstance(d.end, FromTask)]
        self._param_names = tuple(p for p, _ in self.params)
        self.incarnations = list(incarnations)
        if body is not None:
            self.incarnations.append(("cpu", body))
        self.chore_disabled_mask = 0   # class-wide disabled incarnations
        self.priority = priority
        self.properties = dict(properties or {})
        self.task_class_id = -1    # assigned by the taskpool
        self.repo = None           # DataRepo, created by the taskpool
        self.taskpool = None
        #: native per-class vtable (schedext.TaskVT): False = not yet
        #: resolved, None = native path off (sched_native=0)
        self._vt = False

    def flow(self, name: str) -> Flow:
        return self._flow_by_name[name]

    # -- key machinery (reference: make_key / task_snprintf) --------------
    def make_key(self, locals_: Dict[str, int]) -> Tuple:
        if self.key_fn is not None:
            return (self.name, self.key_fn(locals_))
        # map + the C-level __getitem__ beats a genexpr at 100k keys/s
        return (self.name,) + tuple(map(locals_.__getitem__,
                                        self._param_names))

    def key_to_locals(self, key: Tuple) -> Dict[str, int]:
        return {p: key[1 + i] for i, (p, _) in enumerate(self.params)}

    def complete_locals(self, locals_: Dict[str, int]) -> Dict[str, int]:
        """Fill DERIVED parameters absent from a dep-provided params
        dict (single-value ranges over earlier params — the JDF
        derived-local idiom, e.g. the ring's visit class): dep
        expressions may name peers by the free parameters alone, but
        task instances carry the full local set.  A missing param whose
        range holds more than one value is a real addressing error."""
        if all(p in locals_ for p, _ in self.params):
            return locals_
        out = dict(locals_)
        g = self.taskpool.globals if self.taskpool is not None else {}
        for name, range_fn in self.params:
            if name in out:
                continue
            vals = list(range_fn(g, out))
            if len(vals) != 1:
                raise KeyError(
                    f"{self.name}: dep params missing {name!r}, which "
                    f"is not single-valued ({len(vals)} candidates)")
            out[name] = vals[0]
        return out

    # -- parameter space ---------------------------------------------------
    def iter_space(self, globals_: Dict[str, Any]) -> Iterable[Dict[str, int]]:
        """Enumerate the full parameter space (generated startup loops in the
        reference, jdf2c.c:2989)."""
        if len(self.params) == 1:
            # flat spaces (the independent-task shape) skip the
            # recursive generator: one dict literal per instance
            name, range_fn = self.params[0]
            for v in range_fn(globals_, {}):
                yield {name: v}
            return

        def rec(i: int, locals_: Dict[str, int]):
            if i == len(self.params):
                yield dict(locals_)
                return
            name, range_fn = self.params[i]
            for v in range_fn(globals_, locals_):
                locals_[name] = v
                yield from rec(i + 1, locals_)
                del locals_[name]
        yield from rec(0, {})

    def nb_task_inputs(self, locals_: Dict[str, int]) -> int:
        """How many incoming task-fed dep EDGES this instance has — the
        dep-countdown goal (reference: update_deps_with_counter counts every
        edge).  Data flows have mutually-exclusive guards (one source), but
        CTL flows may gather through several simultaneously-applying deps,
        and each counts."""
        deps = self._ft_inputs
        if not deps:
            return 0    # startup-enumeration fast path
        n = 0
        for dep in deps:
            if dep.applies(locals_):
                n += dep.multiplicity(locals_)
        return n

    # binding-table kinds, mirrored by native/schedext.c (CK_*)
    _CK_NULL, _CK_FROMDESC, _CK_NEW, _CK_FROMTASK, _CK_BAIL = 0, 1, 2, 3, 4
    _CK_TOTASK, _CK_OBAIL = 10, 11

    def _native_in_table(self):
        """Per-in-flow binding table for the C ``prepare_input`` twin:
        ``(flow_name, ((guard, kind, payload), ...))`` per flow, one
        entry per dep in declaration order (guards are mutually
        exclusive; the C plan picks the first applying one).  A dep the
        C chain cannot bind (reshape dtt, writeback, unknown end)
        becomes a BAIL entry — the instance pops back to Python."""
        table = []
        for flow in self._in_flows:
            deps = []
            for dep in flow.inputs:
                end = dep.end
                if isinstance(end, Null):
                    deps.append((dep.guard, self._CK_NULL, None))
                elif isinstance(end, FromDesc):
                    if dep.dtt is not None:   # converting read: reshape
                        deps.append((dep.guard, self._CK_BAIL, None))
                    else:
                        deps.append((dep.guard, self._CK_FROMDESC,
                                     end.ref_fn))
                elif isinstance(end, New):
                    deps.append((dep.guard, self._CK_NEW, end.arena_name))
                elif isinstance(end, FromTask):
                    # only reachable unbound (empty range -> None); the
                    # C side needs dep.multiplicity for the 0-edge test
                    deps.append((dep.guard, self._CK_FROMTASK, dep))
                else:
                    deps.append((dep.guard, self._CK_BAIL, None))
            table.append((flow.name, tuple(deps)))
        return tuple(table)

    def _native_out_table(self):
        """Per-out-flow delivery table for the C ``release_deps`` twin:
        ``(flow_name, flow_index, access, ((guard, kind, payload), ...))``
        with payload ``(end, succ_tc, succ_flow_name, succ_write)`` for
        local-capable ToTask deps.  Writebacks (ToDesc), reshaping edges
        (any dtt on either side), and unresolvable successors are BAIL
        entries; Null outputs deliver nothing and are omitted (exactly
        the Python walk's no-op arm)."""
        tp = self.taskpool
        table = []
        for flow in self._out_flows:
            deps = []
            for dep in flow.outputs:
                end = dep.end
                if isinstance(end, Null):
                    continue
                if not isinstance(end, ToTask):
                    deps.append((dep.guard, self._CK_OBAIL, None))
                    continue
                succ_tc = tp.task_classes.get(end.task_class) \
                    if tp is not None else None
                succ_flow = succ_tc._flow_by_name.get(end.flow) \
                    if succ_tc is not None else None
                if (succ_tc is None or succ_flow is None
                        or dep.dtt is not None
                        or any(d.dtt is not None
                               for d in succ_flow.inputs)):
                    deps.append((dep.guard, self._CK_OBAIL, None))
                    continue
                deps.append((dep.guard, self._CK_TOTASK,
                             (end, succ_tc, end.flow,
                              int(bool(succ_flow.access & ACCESS_WRITE)))))
            table.append((flow.name, flow.flow_index, flow.access,
                          tuple(deps)))
        return tuple(table)

    def native_vt(self):
        """The native per-class vtable (reference: the
        ``parsec_task_class_t`` vtable — schedext.TaskVT): C-side task
        construction for every class, plus the one-crossing progress
        chains — trivial (no flows) and extended (data-carrying classes
        via the binding tables above), both requiring a single cpu
        incarnation.  None when the native hot path is off
        (``sched_native=0``); resolved once per class (a class belongs to
        exactly one taskpool).  Device classes (a ``"cuda"`` incarnation)
        get construction only: their tasks pop back to Python at
        ``run_quantum`` and are counted as ``non_trivial`` bailouts."""
        vt = self._vt
        if vt is not False:
            return vt
        self._vt = None
        if self.taskpool is None:
            self._vt = False    # not attached yet: retry at next ask
            return None
        from parsec_tpu_torch.utils.mca import params
        if not int(params.get("sched_native", 1)):
            return None
        # no fallback: a failed build raises (native.NativeBuildError)
        from parsec_tpu_torch.native import load_schedext
        se = load_schedext()
        # drift guard: the C chain hardcodes the TaskStatus values
        if (int(TaskStatus.PENDING), int(TaskStatus.PREPARED),
                int(TaskStatus.RUNNING),
                int(TaskStatus.COMPLETE)) != (0, 2, 3, 4):
            raise RuntimeError(
                "TaskStatus drifted from schedext's hardcoded values")
        single_cpu = (len(self.incarnations) == 1
                      and self.incarnations[0][0] == "cpu"
                      and getattr(self.taskpool, "dynamic_release",
                                  None) is None)
        trivial = (single_cpu and not self._in_flows
                   and not self._out_flows and not self._write_flows)
        # extended chain: data-carrying class with a static binding
        # plan.  Dynamically-discovered (DTD) pools resolve successors
        # from their runtime graph, not from flow tables: Python only.
        cchain = (single_cpu and not trivial
                  and not getattr(self.taskpool, "dynamic", False)
                  and len(self.flows) <= 16)
        hook = self.incarnations[0][1] if (trivial or cchain) else None
        self._vt = se.TaskVT(self, self.taskpool, self.name,
                             self._param_names,
                             tuple(f.name for f in self.flows),
                             self.priority, self.key_fn, hook,
                             bool(trivial), int(bool(cchain)),
                             self._native_in_table() if cchain else (),
                             tuple(self._noin_flow_names)
                             if cchain else (),
                             self._native_out_table() if cchain else (),
                             tuple(f.name for f in self._write_flows)
                             if cchain else ())
        return self._vt

    def rank_of(self, locals_: Dict[str, int]) -> int:
        if self.affinity is None:
            return 0
        # owner_of, not rank_of: a dead rank's tasks place on the
        # survivor that adopted its partition of the affinity
        # collection (identity outside a recovery; collection.py)
        ref = self.affinity(locals_)
        return ref.dc.owner_of(*ref.indices)

    def __repr__(self):
        return f"<TaskClass {self.name}>"


# --------------------------------------------------------------------------
# Task instance
# --------------------------------------------------------------------------

class TaskStatus(IntEnum):
    PENDING = 0
    READY = 1
    PREPARED = 2
    RUNNING = 3
    COMPLETE = 4


_task_seq = itertools.count()


class Task:
    """One task instance (reference: parsec_task_t).

    Field contract with its C twin (native/schedext.c ``TaskCore``, built
    by ``TaskClass.native_vt().build_*``): both carry exactly these
    slots, so every layer of the port, devices/cuda.py included, reads
    either one by attribute (``dtd`` included: the DTD front-end,
    dsl/dtd/insert.py, hangs its dep bookkeeping there)."""

    __slots__ = ("task_class", "taskpool", "locals", "key", "priority",
                 "status", "data", "input_sources", "pinned_flows",
                 "chore_mask", "seq", "device", "prof", "dtd",
                 "ready_at", "mtr_t0", "retries", "retry_snap",
                 "pool_epoch")

    def __init__(self, task_class: TaskClass, taskpool, locals_: Dict[str, int]):
        self.task_class = task_class
        self.taskpool = taskpool
        self.locals = dict(locals_)
        self.key = task_class.make_key(self.locals)
        # class-level priority plus the pool-wide bias (Taskpool.priority;
        # the job service sets it per job so priority schedulers
        # interleave concurrent jobs by weight)
        self.priority = (task_class.priority(self.locals)
                         if task_class.priority else 0) \
            + getattr(taskpool, "priority", 0)
        self.status = TaskStatus.PENDING
        #: flow name -> DataCopy bound for this execution
        self.data: Dict[str, Optional[DataCopy]] = {}
        #: flow name -> (producer TaskClass, producer key) for repo release
        self.input_sources: Dict[str, Tuple[TaskClass, Tuple]] = {}
        #: task-fed flows: their bound copy is a version-pinned input that
        #: must never be superseded by a newer datum version at stage-in
        #: (reference: repo-pinned copies, datarepo.h:50-58)
        self.pinned_flows: set = set()
        self.chore_mask = 0xFFFF
        self.seq = next(_task_seq)
        self.device = None
        #: the task profiler's per-task interval state (prof/pins.py)
        self.prof = None
        self.dtd = None     # DTD dep-bookkeeping state, if dynamically inserted
        #: perf_counter stamp of the moment the task became READY, set by
        #: schedule() (or the C ready queue) when a telemetry consumer
        #: wants it (Context._ready_stamp): the causal tracer's queue-wait
        #: span and the metrics registry's sojourn latency read it
        self.ready_at = None
        #: split-mode metrics: the body interval's start (prof/metrics.py)
        self.mtr_t0 = None
        #: transient-failure retry bookkeeping (core/scheduling
        #: _maybe_retry; active only when task_retry_max > 0)
        self.retries = 0
        self.retry_snap = None
        #: the pool's generation at construction: batched termdet
        #: decrements are keyed by it (core/scheduling.py)
        self.pool_epoch = getattr(taskpool, "run_epoch", 0)

    def __repr__(self):
        args = ",".join(f"{k}={v}" for k, v in self.locals.items())
        return f"{self.task_class.name}({args})"
