"""PINS: performance instrumentation hooks on the task lifecycle.

Rebuild of the reference's PINS framework (reference: parsec/mca/pins/ —
callback chains on task lifecycle events SELECT/EXEC/COMPLETE_EXEC/...
(pins.h:22-50) invoked by PARSEC_PINS macros in scheduling.c; the
``task_profiler`` module feeds the binary tracer).  The runtime already
emits events through ``ExecutionStream.pins`` (core/context.py); modules
here subscribe to them.
"""

from __future__ import annotations

from time import perf_counter as _now
from typing import Any, Dict, Optional

from parsec_tpu_torch.prof.profiling import EV_END, EV_POINT, EV_START, Profile

#: lifecycle events emitted by the runtime (scheduling.py / context.py).
#: ``task_discard`` fires for tasks dropped by pool cancellation; the
#: ``job_*`` events are emitted by the job service (service/service.py)
#: with the Job as payload.
#: ``device_dispatch``/``device_done`` bracket a device task's
#: accelerator-pipeline residency (devices/cuda.py, gated on the causal
#: tracer being installed).
PINS_EVENTS = ("select", "exec_begin", "exec_end", "exec_async",
               "complete_exec", "task_discard",
               "device_dispatch", "device_done",
               "job_submit", "job_start", "job_done")


class TaskProfilerPins:
    """Feed task execution intervals into the binary trace
    (reference: mca/pins/task_profiler).

    Hot-path discipline (reference: profiling.c writes one fixed-size
    record with no allocation): the per-event path caches the stream
    buffer per es and the dictionary key per task class, and by default
    records NO Python info payload — info-less events land straight in
    the native C++ packed buffer.  ``with_locals=True`` restores the
    per-event ``{"locals": ...}`` payload (richer traces, Python-path
    cost; the reference's converter-string info analog).
    """

    def __init__(self, profile: Profile, with_locals: bool = False):
        self.profile = profile
        self.with_locals = with_locals
        self._sbs: Dict[int, Any] = {}         # th_id -> StreamBuffer
        self._keys: Dict[str, int] = {}        # class name -> dict key
        self._tagged: list = []                # objects carrying caches
        # hot-path bindings: the raw event-id counter and (per stream,
        # below) the C sink's interval FASTCALL — each skipped Python
        # frame is ~0.1us of the 1us/task tracer budget
        ids = getattr(profile, "_event_ids", None)
        self._next_eid = ids.__next__ if ids is not None \
            else profile.next_event_id

    def install(self, context) -> None:
        # one task_profiler per context: the interval state rides the
        # shared Task.prof slot, so two instances would corrupt each
        # other's streams (the reference's task_profiler is likewise a
        # per-process singleton — PINS modules are MCA-selected once)
        cur = getattr(context, "_task_profiler", None)
        if cur is not None and cur is not self:
            raise RuntimeError(
                "a TaskProfilerPins is already installed on this "
                "context; uninstall it first")
        context._task_profiler = self
        context.pins_register("exec_begin", self._begin)
        context.pins_register("exec_end", self._end)
        context.pins_register("complete_exec", self._complete)

    def uninstall(self, context) -> None:
        if getattr(context, "_task_profiler", None) is self:
            context._task_profiler = None
        context.pins_unregister("exec_begin", self._begin)
        context.pins_unregister("exec_end", self._end)
        context.pins_unregister("complete_exec", self._complete)
        # drop the hot-path caches planted on streams/task classes so an
        # uninstalled profiler (and its Profile's event buffers) does not
        # stay reachable for the life of the context
        for obj, attr in self._tagged:
            if getattr(obj, attr, (None,))[0] is self:
                try:
                    delattr(obj, attr)
                except AttributeError:
                    pass
        self._tagged.clear()

    def _sb(self, es):
        sb = self._sbs.get(es.th_id)
        if sb is None:
            sb = self._sbs[es.th_id] = \
                self.profile.stream(es.th_id, f"worker-{es.th_id}")
        # hot-path cache, owner-tagged so a second profiler instance
        # on the same context cannot reuse the wrong stream; the third
        # slot is the C sink's interval FASTCALL (or None), called
        # directly from _end/_complete — no Python frame.  The tag is
        # (re)planted on EVERY slow-path call, not only on stream
        # creation: _end/_complete re-read es._prof_sb after calling
        # here, and a tag left behind by a previous profiler must not
        # route our END records into its streams
        cs = es.__dict__.get("_prof_sb")
        if cs is None or cs[0] is not self or cs[1] is not sb:
            es._prof_sb = (self, sb, getattr(sb, "_sink_interval", None))
            self._tagged.append((es, "_prof_sb"))
        return sb

    def _key(self, name: str) -> int:
        k = self._keys.get(name)
        if k is None:
            k = self._keys[name] = self.profile.add_event_class(name).key
        return k

    # The per-task state rides the Task.prof slot as
    # [dict key, event id, object id, closed-by-end, taskpool id,
    # begin-timestamp] — no module-level dict/set traffic on the hot
    # path (reference: profiling.c's record path touches only the
    # per-thread buffer; sp-perf.c is the bar).  Info-less intervals
    # DEFER the begin record: _begin only captures a perf_counter()
    # read, and the closing edge writes BOTH records through ONE C
    # crossing (StreamBuffer.interval -> pinsext interval).  Events carrying an info payload keep the eager two-record
    # path.

    def _begin(self, es, event, task) -> None:
        if not self.profile.enabled:
            return
        tc = task.task_class
        ck = tc.__dict__.get("_prof_key")
        if ck is None or ck[0] is not self:
            k = self._key(tc.name)
            tc._prof_key = (self, k)
            self._tagged.append((tc, "_prof_key"))
        else:
            k = ck[1]
        eid = self._next_eid()
        oid = hash(task.key)
        tpid = task.taskpool.taskpool_id
        if not self.with_locals:
            # the timestamp is the last thing taken: it marks the edge
            task.prof = [k, eid, oid, False, tpid, _now()]
            return
        cs = es.__dict__.get("_prof_sb")
        sb = cs[1] if (cs is not None and cs[0] is self) else self._sb(es)
        task.prof = [k, eid, oid, False, tpid, None]
        sb.trace(k, EV_START, tpid, eid, oid,
                 {"locals": dict(task.locals)})

    def _end(self, es, event, task) -> None:
        p = task.prof
        if p is None or not self.profile.enabled:
            return
        p[3] = True
        cs = es.__dict__.get("_prof_sb")
        if cs is None or cs[0] is not self:
            self._sb(es)
            cs = es._prof_sb
        if p[5] is not None and cs[2] is not None:
            cs[2](p[0], p[4], p[1], p[2], p[5], EV_START, EV_END)
        elif p[5] is not None:
            cs[1].interval(p[0], p[4], p[1], p[2], p[5])
        else:
            cs[1].trace(p[0], EV_END, p[4], p[1], p[2])

    def _complete(self, es, event, task) -> None:
        # device (ASYNC) tasks never ran exec_end on a worker stream:
        # close their interval at completion
        p = task.prof
        if p is None:
            return
        task.prof = None
        if p[3] or not self.profile.enabled:    # closed by _end already
            return
        cs = es.__dict__.get("_prof_sb")
        if cs is None or cs[0] is not self:
            self._sb(es)
            cs = es._prof_sb
        if p[5] is not None and cs[2] is not None:
            cs[2](p[0], p[4], p[1], p[2], p[5], EV_START, EV_END)
        elif p[5] is not None:
            cs[1].interval(p[0], p[4], p[1], p[2], p[5])
        else:
            cs[1].trace(p[0], EV_END, p[4], p[1], p[2])


def install_task_profiler(context, profile: Profile,
                          with_locals: bool = False) -> TaskProfilerPins:
    mod = TaskProfilerPins(profile, with_locals=with_locals)
    mod.install(context)
    return mod


class StealCounterPins:
    """Per-stream select counters (reference: mca/pins/print_steals)."""

    def __init__(self):
        self.selects: Dict[int, int] = {}

    def install(self, context) -> None:
        context.pins_register("select", self._select)

    def uninstall(self, context) -> None:
        context.pins_unregister("select", self._select)

    def _select(self, es, event, task) -> None:
        self.selects[es.th_id] = self.selects.get(es.th_id, 0) + 1

    def display(self) -> str:
        total = sum(self.selects.values())
        per = " ".join(f"es{t}={n}" for t, n in sorted(self.selects.items()))
        return f"selects total={total} {per}"


class GaugesPins:
    """Bridge to the live gauges (reference: the alperf/papi_sde-style
    modules exporting runtime counters)."""

    def __init__(self):
        from parsec_tpu_torch.prof.gauges import Gauges
        self.gauges = Gauges()

    def install(self, context) -> None:
        self.gauges.install(context)

    def uninstall(self, context) -> None:
        self.gauges.uninstall(context)

    def display(self) -> str:
        return str(self.gauges.snapshot())


class IteratorsCheckerPins:
    """Successor-iteration validator (reference:
    mca/pins/iterators_checker — re-derives a completed task's successor
    set and cross-checks it against the dependencies the engine actually
    delivered; valuable precisely because this runtime's dep engine is
    hand-written per front-end).  Per completed PTG task it re-walks the
    flow expressions (iterate_successors) and compares with the
    ``deliver_dep`` calls observed through the PINS hook: a lost or
    extra delivery is reported as a context error.  Dynamic (DTD) pools
    resolve successors from their runtime graph, not flow expressions,
    and are skipped."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        #: id(task) -> set of (succ class name, succ key, flow name)
        self._delivered: Dict[int, set] = {}
        self.checked = 0
        self.flagged = 0

    def install(self, context) -> None:
        context.pins_register("deliver_dep", self._deliver)
        context.pins_register("complete_exec", self._complete)

    def uninstall(self, context) -> None:
        context.pins_unregister("deliver_dep", self._deliver)
        context.pins_unregister("complete_exec", self._complete)

    def _deliver(self, es, event, payload) -> None:
        task, succ_tc, succ_locals, dflow = payload
        with self._lock:
            self._delivered.setdefault(id(task), set()).add(
                (succ_tc.name, succ_tc.make_key(succ_locals), dflow))

    def _expected(self, task) -> set:
        from parsec_tpu_torch.core.task import ToTask
        tp = task.taskpool
        myrank = tp.context.rank if tp.context else 0
        want = set()
        for flow in task.task_class.flows:
            for dep in flow.active_outputs(task.locals):
                end = dep.end
                if not isinstance(end, ToTask):
                    continue
                succ_tc = tp.task_classes[end.task_class]
                for succ_locals in end.instances(task.locals):
                    # dep instances carry free params only; fill derived
                    # locals before keying/ranking (mirrors release_deps,
                    # else every derived-local successor class silently
                    # escapes validation via the except below)
                    succ_locals = succ_tc.complete_locals(succ_locals)
                    if succ_tc.rank_of(succ_locals) != myrank:
                        continue
                    want.add((succ_tc.name, succ_tc.make_key(succ_locals),
                              end.flow))
        return want

    def _complete(self, es, event, task) -> None:
        if getattr(task.taskpool, "dynamic_release", None) is not None:
            return          # DTD: successors come from the runtime graph
        with self._lock:
            got = self._delivered.pop(id(task), set())
        try:
            want = self._expected(task)
        except Exception:
            return          # un-evaluable expressions: nothing to check
        self.checked += 1
        if got != want:
            self.flagged += 1
            missing = want - got
            extra = got - want
            es.context.record_error(AssertionError(
                f"iterators_checker: {task} successor mismatch — "
                f"missing deliveries: {sorted(missing)}; "
                f"unexpected deliveries: {sorted(extra)}"), task)

    def display(self) -> str:
        return f"iterators_checker checked={self.checked} " \
               f"flagged={self.flagged}"


#: name -> zero-arg constructor; the MCA-selected modules of ``--mca
#: pins a,b`` (reference: the pins framework's module list, pins_init.c)
_MODULES = {
    "print_steals": StealCounterPins,
    "alperf": GaugesPins,
    "iterators_checker": IteratorsCheckerPins,
}


def install_selected(context) -> list:
    """Install the PINS modules named by ``--mca pins`` (comma list) on
    a context; returns the module instances (reference: pins_init
    iterating the selected module list).  Unknown names warn rather than
    fail — a missing instrumentation module must not kill the run."""
    from parsec_tpu_torch.utils.mca import params
    from parsec_tpu_torch.utils.output import warning
    params.register("pins", "",
                    "comma-separated PINS instrumentation modules to "
                    "install at context init "
                    f"(available: {', '.join(sorted(_MODULES))})")
    spec = str(params.get("pins", "") or "").strip()
    mods = []
    if not spec:
        return mods
    for name in spec.split(","):
        name = name.strip()
        if not name:
            continue
        ctor = _MODULES.get(name)
        if ctor is None:
            warning("unknown PINS module %r (available: %s)", name,
                    ", ".join(sorted(_MODULES)))
            continue
        mod = ctor()
        mod.install(context)
        mods.append(mod)
    return mods
