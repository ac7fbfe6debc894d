"""Execution context: worker streams, scheduler, taskpool lifecycle.

Rebuild of the reference's context tree (reference:
include/parsec/execution_stream.h: parsec_context_t -> parsec_vp_t ->
parsec_execution_stream_t; bring-up parsec.c:384-900): one Context per
process holds N worker threads (execution streams), the selected scheduler,
the device registry, and the set of active taskpools.  API mirrors
parsec_init / parsec_context_add_taskpool / _start / _test / _wait / _fini
(reference: parsec/runtime.h:170-323).

Worker threads orchestrate host-side task progression; the FLOPs run in
kernels the device module launches on each CUDA device's launch stream, so
a handful of streams keep a card fed — the default nb_cores is deliberately
small, not one-per-CPU-core.

Devices: a Context attaches one device module per visible CUDA device and
raises when there is none.  ``Context(device="cpu")`` (or the MCA param
``device=cpu``) attaches one CPU-backed instance of the same module
instead, for tests on a host without a card.

Telemetry: as in the JAX package, every Context installs at its defaults
the control-plane journal (``journal_enabled``), the properties space,
the PINS modules ``pins`` names, and the metrics registry
(``metrics_enabled``) with live attribution and health armed; schedule()
and the C quantum then stamp ``Task.ready_at`` for them.  Each is turned
off by its knob (``PARSEC_MCA_METRICS_ENABLED=0`` and the others).

Distributed runs: ``rank``/``nranks`` name this process's place in the
gang, and a comm engine attaches as ``ctx.comm`` (comm/remote_dep.py
RemoteDepEngine; comm/launch.py run_distributed wires one per rank).
Remote successors then ride the remote-dep protocol, and ``wait`` adds
the gang's global quiescence to local completion.

Streams map onto virtual processes by ``vpmap`` (core/vpmap.py) and bind
to cores under ``runtime_bind_threads``, as in the JAX package.  The
crash-dump flight recorder (``flightrec_enabled``) and the recovery plane
(``recovery_enable``) are opt-in, as there; the recovery plane covers
PTG, DTD and dynamic pools, elastic rejoin and the job service's
recovery notices.

Several device modules (``device="cuda*N"``, or "cpu:N" in tests): the
ICI transport (comm/ici.py) attaches as ``ctx.ici`` when two or more
accelerators are attached and ``comm_ici_enabled`` (default 1) holds; it
moves cross-module payload edges proactively (a broadcast per fan-out, a
put per single-consumer edge, batched permute rounds per wavefront),
and idle workers drain its batching window through ``flush_ici``.  On
one module ``ctx.ici`` stays None.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, List, Optional

from parsec_tpu_torch.core import scheduling
from parsec_tpu_torch.core.task import Task
from parsec_tpu_torch.core.taskpool import Taskpool, TaskpoolState
# registers vpmap and runtime_bind_threads, read below
from parsec_tpu_torch.core.vpmap import VPMap, bind_current_thread
from parsec_tpu_torch.core import termdet as _termdet  # noqa: F401 (registers the termdet components)
# the telemetry planes: imported here so their knobs (defaults 1) are
# registered before a Context reads them
from parsec_tpu_torch.prof import flightrec as _flightrec
from parsec_tpu_torch.prof import health as _health  # noqa: F401
from parsec_tpu_torch.prof import journal as _journal
from parsec_tpu_torch.prof import liveattr as _liveattr  # noqa: F401
from parsec_tpu_torch.prof import metrics as _metrics
from parsec_tpu_torch.prof.pins import install_selected
from parsec_tpu_torch.utils.properties import (PropertySpace,
                                               install_runtime_properties,
                                               install_taskpool_properties)
from parsec_tpu_torch.sched import create as create_scheduler
from parsec_tpu_torch.utils.mca import components, params
from parsec_tpu_torch.utils.output import debug_verbose, inform

params.register("runtime_num_cores", 4, "worker execution streams")
params.register("sched", "", "scheduler component selection")
params.register("termdet", "", "termination-detection component selection")
params.register("runtime_autopsy_s", 45.0,
                "soft deadline of Context.wait: when completion takes "
                "longer than this, a one-shot HANG AUTOPSY is logged — "
                "termdet counters, per-pool pending tasks and device "
                "pipeline depths — so a stuck run is diagnosable from its "
                "log (0 disables)")
params.register("task_retry_max", 0,
                "retry a transiently-failing idempotent task body up to "
                "this many times before failing its pool with "
                "TaskRetryExhausted (datarepo-versioned inputs plus a "
                "pre-execution write-flow snapshot make re-execution "
                "safe; 0 = off; read at Context construction)")
params.register("termdet_batch", 64,
                "per-worker termdet decrement batch: completion "
                "decrements accumulate on the worker and flush to the "
                "locked counter every N tasks and at every idle moment.  "
                "1 = a lock round-trip per task")
params.register("comm_inline_poll", 1,
                "idle workers briefly re-poll the ready queue (GIL-"
                "yield spin) before blocking on the doorbell when a "
                "comm engine is attached — an activation landing in "
                "the window is picked up at GIL-handoff latency "
                "instead of a condvar wakeup.  0 = always block "
                "immediately; 1 = auto (spin only when the host has a "
                "spare core — on 1 core the spin steals the GIL from "
                "the comm loop it waits on); 2 = force on")
params.register("doorbell_coalesce_us", 150,
                "the worker-inlined poll window in microseconds (see "
                "comm_inline_poll)")
params.register("runtime_gc_freeze", 1,
                "freeze the already-imported object graph out of cyclic "
                "GC's full-collection scans just before the first Context "
                "is made (gc.freeze, the CPython production idiom).  Once "
                "per process; cycles allocated BEFORE that are never "
                "reclaimed afterwards.  0 = leave the collector alone")

params.register("recovery_enable", 0,
                "peer-death RECOVERY: surviving ranks re-map a dead "
                "rank's data partition onto themselves and re-execute "
                "the lost lineage instead of failing the affected "
                "taskpools (core/recovery.py).  0 (default) keeps the "
                "containment-only failure lifecycle: a dead peer fails "
                "the pools that touch it")

_gc_frozen = False


def _freeze_import_graph() -> None:
    """One-shot (per process): reclaim pre-existing garbage, then move
    the surviving import-time object population into GC's permanent
    generation.  Later Contexts skip — their working sets must stay
    collectable, and re-freezing would permanently pin each prior
    context's residue."""
    global _gc_frozen
    if _gc_frozen:
        return
    _gc_frozen = True
    import gc
    gc.collect()
    gc.freeze()


class ExecutionStream:
    """One worker stream (reference: parsec_execution_stream_t)."""

    def __init__(self, context: "Context", th_id: int, vp_id: int = 0):
        self.context = context
        self.th_id = th_id
        self.vp_id = vp_id
        self.nb_tasks_done = 0
        self.sched_data: Any = None
        #: task whose body is currently executing on this stream, or None
        self.running_task = None
        #: per-worker batched termdet accumulator ({taskpool: [epoch,
        #: count]}) and its owning thread id — installed by worker_loop
        #: (None = unbatched); single-writer: only the owning worker
        #: thread mutates it, off-thread completers take the locked path
        self._td_acc = None
        self._td_tid = 0
        #: tasks this worker took off the native ready queue outside
        #: ``run_quantum`` (the doorbell's probe under its lock, the comm
        #: spin poll): they never reach the C chain, so no bailout counts
        #: them, and with the C chain's bailouts they account for every
        #: task a native worker handed to Python (single writer: the
        #: owning worker)
        self.probe_pops = 0
        #: the context's event->callbacks dict, aliased so the per-task
        #: dispatch reads one attribute (pins_register mutates the dict
        #: in place; the binding itself never changes)
        self._pins_map = context._pins

    def pins(self, event: str, task: Task) -> None:
        """PINS instrumentation point (reference: PARSEC_PINS macros);
        callbacks registered with Context.pins_register run here."""
        cbs = self._pins_map.get(event)
        if cbs:
            for cb in cbs:
                cb(self, event, task)


class Context:
    """Process-wide runtime context (reference: parsec_context_t).

    ``device``: "cuda" attaches every visible CUDA device and raises when
    there is none; "cpu" attaches one CPU-backed device module (tests).
    None reads the MCA param ``device`` (default "cuda")."""

    def __new__(cls, nb_cores: Optional[int] = None,
                scheduler: Optional[str] = None,
                rank: int = 0, nranks: int = 1,
                argv: Optional[List[str]] = None,
                device: Optional[str] = None):
        if argv is not None:
            params.parse_cmdline(argv)
        # freeze before this object exists: a frozen Context (and what it
        # is given later: devices, taskpools, their tiles) would never be
        # reclaimed, since the collector takes the permanent generation's
        # references as live
        if int(params.get("runtime_gc_freeze", 1)):
            _freeze_import_graph()
        return super().__new__(cls)

    def __init__(self, nb_cores: Optional[int] = None,
                 scheduler: Optional[str] = None,
                 rank: int = 0, nranks: int = 1,
                 argv: Optional[List[str]] = None,
                 device: Optional[str] = None):
        self.rank = rank
        self.nranks = nranks
        self.nb_cores = nb_cores if nb_cores is not None \
            else params.get("runtime_num_cores", 4)
        self.finished = False                 # guarded-by: _lock, _cond
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)   # same RLock
        self._active_taskpools = 0            # guarded-by: _lock, _cond
        self._pending_start: List[Taskpool] = []   # guarded-by: _lock, _cond
        #: taskpool_id -> taskpool (reference: taskpool registry hash)
        self.taskpools: dict = {}
        self._errors: List[tuple] = []        # guarded-by: _lock, _cond
        self._pins = {}
        #: comm/remote_dep.py RemoteDepEngine of a distributed run
        #: (attached by its constructor), else None
        self.comm = None
        self.grapher = None            # DOT grapher (prof/grapher.py)
        self.ici = None                # ICI transport (comm/ici.py)
        self._causal_tracer = None     # prof/causal.py CausalTracer
        self.metrics = None            # prof/metrics.py RuntimeMetrics
        self._flightrec = None         # prof/flightrec.py FlightRecorder
        # control-plane black box (prof/journal.py): a bounded ring of
        # protocol decisions, no per-task emits.  A deliberate difference
        # from the JAX package, which installs a disabled journal at
        # journal_enabled 0: the port then installs none
        self.journal = None
        if int(params.get("journal_enabled", 1)):
            _journal.install_journal(self)
        #: schedule() and the C quantum stamp Task.ready_at only when a
        #: telemetry consumer wants it (causal tracer or metrics
        #: registry), and devices/cuda.py fires device_dispatch/
        #: device_done PINS, and times its launch steps, only when the
        #: causal tracer or the flight recorder listens; the tracer that
        #: records the device module's host stages, or None.  All
        #: maintained by _recompute_ready_stamp on (un)install
        self._ready_stamp = False
        self._device_spans = False
        self._stage_tracer = None
        #: perf_counter when the device spans last turned on
        self._device_spans_since = 0.0
        #: transient-task retry budget, cached off the worker hot path
        #: (core/scheduling.task_progress and the C chain probe it)
        self._retry_max = int(params.get("task_retry_max", 0))
        self._termdet_batch = max(1, int(params.get("termdet_batch", 64)))
        self._db_waiters = 0          # GIL-atomic int (plain reads)
        self._db_suppressed = 0       # doorbells coalesced away (stats)
        self._recompute_db_spin()

        # device layer (reference: parsec_mca_device_init, parsec.c:823)
        from parsec_tpu_torch.devices import init_devices
        self.device_registry = init_devices(self, device)
        self.devices = self.device_registry.devices

        # ICI transport: multi-module payload edges ride device-to-device
        # copies (reference: the second comm-engine module seam, SURVEY
        # §5.8).  Imported here: it registers comm_ici_enabled, so an env
        # override (PARSEC_MCA_COMM_ICI_ENABLED=0) coerces to int instead
        # of arriving as a truthy raw string
        from parsec_tpu_torch.comm.ici import IciEngine
        if int(params.get("comm_ici_enabled", 1)):
            ici = IciEngine(self.device_registry)
            if ici.ndev >= 2:
                self.ici = ici

        # properties dictionary: runtime-queryable hierarchical key space
        # for live tooling (reference: parsec/dictionary.c; see
        # utils/properties.py)
        self.properties = PropertySpace()
        install_runtime_properties(self)

        # termination detection: pools default to the MCA-selected module
        # but may name their own via Taskpool.termdet_name
        sel_name, td_cls = components.select(
            "termdet", params.get("termdet", "") or None)
        self._termdet_cls = td_cls
        self._termdet = td_cls()
        self._termdets = {sel_name: self._termdet}

        # VP map: streams -> virtual processes (+ optional core binding)
        # (reference: vpmap_init_* + thread binding, parsec.c:543-583,:861).
        # Built before the scheduler installs: lhq reads it at install
        # (the JAX package builds it after, so its lhq never sees it)
        self.vpmap = VPMap.from_mca(self.nb_cores, rank=self.rank)
        self.scheduler = create_scheduler(
            scheduler or (params.get("sched", "") or None))
        self.scheduler.install(self)

        self.streams = [ExecutionStream(self, i,
                                        vp_id=self.vpmap.vp_of(i))
                        for i in range(self.nb_cores)]
        for es in self.streams:
            self.scheduler.flow_init(es)
        bind = bool(int(params.get("runtime_bind_threads", 0)))

        def run_worker(es):
            if bind:
                core = self.vpmap.core_of(es.th_id)
                if core is None:   # flat/parameter maps carry no cores:
                    # the documented round-robin placement
                    core = es.th_id % (os.cpu_count() or 1)
                bind_current_thread(core)
            scheduling.worker_loop(es)

        self._threads = [
            threading.Thread(target=run_worker, args=(es,),
                             name=f"parsec-worker-{es.th_id}", daemon=True)
            for es in self.streams]
        for t in self._threads:
            t.start()

        # MCA-selected PINS instrumentation modules (reference: pins_init
        # + per-thread PINS THREAD_INIT, parsec.c bring-up)
        self._pins_modules = install_selected(self)

        # telemetry plane: the always-on metrics registry (PAPI-SDE
        # counterpart grown into a scrapeable registry), with live
        # attribution and health riding its hooks, and the crash-dump
        # flight recorder (armed via flightrec_enabled)
        if int(params.get("metrics_enabled", 1)):
            _metrics.RuntimeMetrics(rank=self.rank).install(self)
        if int(params.get("flightrec_enabled", 0)):
            _flightrec.FlightRecorder(self).install(self)
        # recovery plane (core/recovery.py): opt-in — when disabled
        # (the default) every peer-death path keeps the containment
        # behavior, byte for byte
        self.recovery = None
        if int(params.get("recovery_enable", 0)):
            from parsec_tpu_torch.core.recovery import RecoveryCoordinator
            self.recovery = RecoveryCoordinator(self)
        self._recompute_ready_stamp()
        debug_verbose(3, "context up: %d streams, scheduler=%s",
                      self.nb_cores, self.scheduler.name)

    def _recompute_ready_stamp(self) -> None:
        """Telemetry-consumer gates: schedule() stamps Task.ready_at iff
        someone consumes it (the causal tracer's "queue" class, or the
        metrics registry), and the device module emits its dispatch/
        done span events iff the causal tracer (its "device" or
        "stages" class) or the flight recorder (its "device" class)
        listens.  When the device spans turn on, each device module
        takes a fresh clock anchor for its device intervals."""
        tr, fr = self._causal_tracer, self._flightrec
        self._ready_stamp = ((tr is not None and "queue" in tr.classes)
                             or self.metrics is not None)
        was = self._device_spans
        self._device_spans = (
            (tr is not None and not tr.classes.isdisjoint(
                ("device", "stages")))
            or (fr is not None and "device" in fr.classes))
        self._stage_tracer = tr if tr is not None \
            and "stages" in tr.classes else None
        if self._device_spans and not was:
            self._device_spans_since = time.perf_counter()
        reg = getattr(self, "device_registry", None)
        if self._device_spans and not was and reg is not None:
            for dev in reg.accelerators:
                anchor = getattr(dev, "anchor_clock", None)
                if anchor is not None:
                    anchor()

    def _recompute_db_spin(self) -> None:
        """Arm (or re-arm) the inlined comm-poll window from the
        CURRENT core affinity.  The spin needs a spare core: on a
        1-core host a polling worker steals the GIL/CPU from the very
        comm loop whose delivery it is waiting for; auto mode (1) arms
        it only with a spare core, 2 forces.  Called from ``__init__``
        and again when a comm engine attaches (comm/remote_dep.py);
        workers pick the window up on their next idle pass."""
        try:
            ncores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            ncores = os.cpu_count() or 1
        ip = int(params.get("comm_inline_poll", 1))
        self._db_spin_s = (
            max(0, int(params.get("doorbell_coalesce_us", 150))) * 1e-6
            if ip == 2 or (ip == 1 and ncores > 1) else 0.0)

    # -- PINS registration -------------------------------------------------
    def pins_register(self, event: str, cb: Callable) -> None:
        self._pins.setdefault(event, []).append(cb)

    def pins_unregister(self, event: str, cb: Callable) -> None:
        if event in self._pins and cb in self._pins[event]:
            self._pins[event].remove(cb)

    def telemetry_incident(self, reason: str):
        """Fire the flight recorder's incident dump (no-op unarmed).
        Called from containment/error paths — must never raise."""
        fr = self._flightrec
        if fr is None:
            return None
        try:
            return fr.incident(reason)
        except Exception as exc:
            debug_verbose(1, "flight recorder incident failed: %s", exc)
            return None

    def accelerator_spaces(self) -> list:
        """Memory-space indices of the enabled device modules."""
        return [d.space for d in self.device_registry.accelerators]

    def flush_ici(self) -> None:
        """Drain deferred wavefront placements (comm/ici.py defer_place)
        whose batching window expired.  Idle workers call it, and must
        survive it: a copy that raises fails the pools whose tiles the
        batch was placing, and no other (the JAX package's swallows it;
        comm/ici.py docstring)."""
        if self.ici is None:
            return
        self.ici.flush_placements()

    # -- doorbell ----------------------------------------------------------
    def ring_doorbell(self, n: int = 1) -> None:
        """Wake up to ``n`` idle workers.  Coalesced: while no worker
        has raised its waiting flag the condvar lock is skipped
        entirely.  No lost wakeups: doorbell_wait raises the flag and
        re-probes the queue under the lock, so a push that raced the
        flag is observed by the probe."""
        if self._db_waiters:
            with self._cond:
                self._cond.notify(n)
        else:
            self._db_suppressed += 1

    def doorbell_wait(self, timeout: float, probe=None):
        """Park until a doorbell or ``timeout``.  ``probe`` (the ready
        queue's pop) re-checks for work under the lock AFTER the
        waiting flag went up.  Returns the probed task, or None."""
        with self._cond:
            if self.finished:
                return None
            self._db_waiters += 1
            try:
                if probe is not None:
                    t = probe()
                    if t is not None:
                        return t
                self._cond.wait(timeout)
            finally:
                self._db_waiters -= 1
        return None

    # -- taskpool lifecycle ------------------------------------------------
    def add_taskpool(self, tp: Taskpool, start: bool = False) -> None:
        """reference: parsec_context_add_taskpool (scheduling.c:678)."""
        with self._lock:
            self._active_taskpools += 1
            # register BEFORE attach: a comm message arriving in between
            # must find the pool in this table
            self.taskpools[tp.taskpool_id] = tp
            tp.attach(self, self.termdet_for(tp))
            self._pending_start.append(tp)
        install_taskpool_properties(self, tp)
        if self.recovery is not None:
            # recovery registration: snapshot the pool's collections'
            # local tiles (the lineage base a restart restores to) and
            # record its replay spec; pools without one stay on the
            # containment path
            self.recovery.register_pool(tp)
        if self.comm is not None:
            # activations may have raced this registration
            self.comm.retry_delayed()
        if start:
            self.start()

    def termdet_for(self, tp: Taskpool):
        """The termdet module instance for a pool: its named override or
        the context default (modules are shared per name)."""
        name = getattr(tp, "termdet_name", None)
        if not name:
            return self._termdet
        td = self._termdets.get(name)
        if td is None:
            _, cls = components.select("termdet", name)
            td = self._termdets.setdefault(name, cls())
        return td

    def start(self) -> None:
        """Fire startup hooks of attached pools
        (reference: parsec_context_start:750)."""
        while True:
            with self._lock:
                if not self._pending_start:
                    return
                tp = self._pending_start.pop(0)
            ready = tp.startup()
            if ready:
                scheduling.schedule(self.streams[0], ready)
            tp.ready()
            if self.comm is not None:
                # activations delayed while this pool counted its tasks
                self.comm.retry_delayed()

    def _taskpool_terminated(self, tp: Taskpool) -> None:
        with self._cond:
            self._active_taskpools -= 1
            if self._active_taskpools == 0:
                self._cond.notify_all()

    def test(self) -> bool:
        """Non-blocking completion check (reference: parsec_context_test)."""
        with self._lock:
            return self._active_taskpools == 0

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until all enqueued taskpools complete
        (reference: parsec_context_wait:776), then synchronize every
        device's launch stream; on a distributed run, then wait for the
        gang's global quiescence.  Past the ``runtime_autopsy_s`` soft
        deadline a one-shot hang autopsy is logged."""
        import time as _time
        self.start()
        if self.comm is not None:
            # dynamic pools hold a runtime action until the pool-scoped
            # quiescence round proves every rank drained (see
            # DynamicTaskpool.attach); resolve before waiting on them.
            # timeout=None means wait indefinitely, like the completion
            # wait below
            self.comm.resolve_dynamic_holds(timeout)
        start = _time.monotonic()
        autopsy_s = float(params.get("runtime_autopsy_s", 45.0))
        autopsy_at = start + autopsy_s if autopsy_s > 0 else None
        deadline = None if timeout is None else start + timeout
        pred = lambda: self._active_taskpools == 0 or self._errors  # noqa: E731
        while True:
            while True:
                with self._cond:
                    bounds = [t for t in (autopsy_at, deadline)
                              if t is not None]
                    slice_s = max(0.0, min(bounds) - _time.monotonic()) \
                        if bounds else None
                    ok = self._cond.wait_for(pred, timeout=slice_s)
                if ok:
                    break
                now = _time.monotonic()
                if autopsy_at is not None and now >= autopsy_at:
                    from parsec_tpu_torch.utils.output import warning
                    warning("context wait exceeded the %.0fs soft "
                            "deadline — hang autopsy:\n%s", autopsy_s,
                            self.hang_autopsy())
                    autopsy_at = None
                if deadline is not None and now >= deadline:
                    break
            self._raise_first_error()
            if not ok:
                raise TimeoutError("parsec context wait timed out")
            # drain device pipelines: deps are released eagerly on
            # dispatch (devices/cuda.py completer), so pool termination
            # means "all work launched" — quiescence means "all work
            # done", and late device-side failures surface here
            self.sync_devices(timeout=timeout)
            self._raise_first_error()
            if self.comm is None:
                break
            # distributed: local completion is not global completion —
            # peers may still pull our data (reference: ranks keep
            # progressing comm until termdet quiesces the whole run)
            self.comm.wait_quiescence()
            with self._lock:
                if self._active_taskpools != 0 and not self._errors:
                    # a recovery restart re-armed a pool while the
                    # quiescence round ran (completed-pool grace): the
                    # gang is NOT done — go back to waiting instead of
                    # handing tiles mid-restore to the application
                    continue
                # past global quiescence every completed pool is
                # GLOBALLY done: retire them so a later peer death
                # cannot resurrect them for re-execution
                # (core/recovery.py restarts only locally-complete,
                # not-yet-retired pools)
                for tp in self.taskpools.values():
                    if getattr(tp, "completed", False):
                        tp.retired = True
            break

    def sync_devices(self, timeout: Optional[float] = None) -> None:
        """Quiesce device pipelines; raises late device failures."""
        for d in self.device_registry.accelerators:
            dsync = getattr(d, "sync", None)
            if dsync is not None:
                dsync(timeout=timeout)

    def _raise_first_error(self) -> None:
        """Surface the first recorded context error.  Structured
        failures (PeerFailedError, TaskRetryExhausted) raise AS
        THEMSELVES when no task is attributable; everything else keeps
        the RuntimeError wrapper."""
        if not self._errors:
            return
        from parsec_tpu_torch.core.errors import (PeerFailedError,
                                                  TaskRetryExhausted)
        exc, task = self._errors[0]
        if task is None and isinstance(exc, (PeerFailedError,
                                             TaskRetryExhausted)):
            raise exc
        raise RuntimeError(f"task {task} failed") from exc

    def record_error(self, exc: Exception, task: Task) -> None:
        from parsec_tpu_torch.utils.debug_history import dump_history, \
            paranoid
        if paranoid(1):
            marks = dump_history()
            if marks:
                debug_verbose(1, "debug history (%d marks, newest last):\n%s",
                              len(marks), "\n".join(marks[-64:]))
        # per-pool error isolation: a pool carrying an error_sink keeps
        # its failures to itself
        from parsec_tpu_torch.core.errors import PeerFailedError
        if isinstance(exc, PeerFailedError):
            # containment fired: capture what just happened before the
            # ring overwrites it (no-op unless the recorder is armed)
            self.telemetry_incident(
                f"PeerFailedError rank={exc.rank} ({exc.detector})")
        tp = getattr(task, "taskpool", None)
        sink = getattr(tp, "error_sink", None) if tp is not None else None
        if sink is not None:
            try:
                sink(exc, task)
                return
            except Exception as sink_exc:   # a broken sink falls back to
                debug_verbose(1, "error_sink failed: %s", sink_exc)
        with self._cond:
            self._errors.append((exc, task))
            self._cond.notify_all()

    def record_pool_error(self, tp, exc: Exception) -> None:
        """Route a pool-scoped failure with no specific task (a dead
        peer, a rendezvous timeout) through the pool's error sink,
        falling back to the context-wide error list exactly like
        record_error."""
        self.telemetry_incident(
            f"pool {getattr(tp, 'taskpool_id', '?')} error: "
            f"{type(exc).__name__}")
        sink = getattr(tp, "error_sink", None) if tp is not None else None
        if sink is not None:
            try:
                sink(exc, None)
                return
            except Exception as sink_exc:
                debug_verbose(1, "error_sink failed: %s", sink_exc)
        with self._cond:
            self._errors.append((exc, None))
            self._cond.notify_all()

    def hang_autopsy(self) -> str:
        """One diagnosable snapshot of what can wedge a run: per-pool
        termdet counters, comm protocol state (termdet balance, parked
        activations, in-flight rendezvous, per-peer queue depths and
        last-frame ages) and device pipeline depths."""
        lines = ["=== parsec hang autopsy (rank %d) ===" % self.rank]
        with self._lock:
            lines.append(f"active taskpools: {self._active_taskpools}; "
                         f"errors recorded: {len(self._errors)}")
            pools = list(self.taskpools.values())
        for tp in pools:
            if getattr(tp, "completed", False):
                continue
            try:
                peers = sorted(tp.peer_ranks) or "-"
            except RuntimeError:
                # comm threads resize the set lock-free; the autopsy
                # must never raise out of Context.wait
                peers = "~resizing~"
            lines.append(
                f"  pool {tp.taskpool_id} {tp.name!r}: state="
                f"{getattr(tp, 'state', '?')} nb_tasks={tp.nb_tasks} "
                f"pending_actions={tp.nb_pending_actions} "
                f"cancelled={tp.cancelled} "
                f"peer_ranks={peers}")
        done = sum(es.nb_tasks_done for es in self.streams)
        lines.append(f"workers: {len(self.streams)} streams, "
                     f"{done} tasks done")
        for d in self.device_registry.accelerators:
            pend = len(getattr(d, "_pending", ()) or ())
            infl = len(getattr(d, "_inflight", ()) or ())
            lines.append(f"  device {d.name}: pending={pend} "
                         f"inflight={infl}")
        if self.comm is not None:
            try:
                lines.append("comm: " + repr(self.comm.debug_state()))
            except Exception as exc:   # the autopsy must never raise
                lines.append(f"comm: <debug_state failed: {exc}>")
        # control-plane tail: the last ~N protocol events per rank,
        # clock-aligned — a wedged negotiation (a mode vote that never
        # got its quorum, a need round nobody answered) is visible in
        # the autopsy text itself, no bundle pull needed
        tail_n = int(params.get("journal_autopsy_tail", 20))
        if tail_n > 0 and self.journal is not None:
            try:
                per_rank = _journal.cluster_journals(self, timeout=2.0)
                for r in sorted(per_rank):
                    snap = per_rank[r]
                    snap["events"] = snap.get("events", [])[-tail_n:]
                merged = _journal.merge_journals(per_rank)
                if merged:
                    t0 = merged[0]["t"]
                    lines.append("control-plane journal tail "
                                 f"(last {tail_n}/rank, clock-aligned):")
                    lines.extend("  " + _journal.format_event(ev, t0)
                                 for ev in merged)
            except Exception as exc:   # the autopsy must never raise
                lines.append(f"journal tail: <failed: {exc}>")
        # armed flight recorder: the last-N-seconds ring is worth more
        # than this snapshot — dump it and point the reader at the
        # bundle (summarize with python -m parsec_tpu_torch.prof.flightrec)
        bundle = self.telemetry_incident("hang-autopsy")
        if bundle is not None:
            lines.append(f"flight recorder incident bundle: {bundle} "
                         "(summarize: python -m "
                         f"parsec_tpu_torch.prof.flightrec {bundle})")
        return "\n".join(lines)

    # -- remote deps (filled in by the comm layer) ------------------------
    def remote_dep_activate(self, es, task, flow, dep, succ_tc, succ_locals,
                            copy) -> None:
        if self.comm is None:
            from parsec_tpu_torch.utils.output import show_help
            raise RuntimeError(
                f"{task}: successor {succ_tc.name}{succ_locals} lives on "
                f"rank {succ_tc.rank_of(succ_locals)}.\n"
                + show_help("no-comm-engine", warn=False))
        self.comm.remote_dep_activate(es, task, flow, dep, succ_tc,
                                      succ_locals, copy)

    # -- shutdown ----------------------------------------------------------
    def fini(self) -> None:
        """Stop workers and device threads (reference: parsec_fini)."""
        with self._cond:
            self.finished = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self.device_registry.fini()
        stats = self.scheduler.display_stats(None)
        if stats:
            inform("scheduler stats: %s", stats)
        for mod in self._pins_modules:
            disp = getattr(mod, "display", None)
            if disp is not None:
                inform("pins %s: %s", type(mod).__name__, disp())
            unins = getattr(mod, "uninstall", None)
            if unins is not None:   # reference: pins_fini unregisters
                unins(self)
        self._pins_modules = []
        if self.metrics is not None:
            self.metrics.uninstall(self)
        if self._flightrec is not None:
            self._flightrec.uninstall(self)
        jdir = str(params.get("journal_dir", "") or "").strip()
        if jdir and self.journal is not None:
            # per-rank black-box bundle for the JAX package's
            # tools/journal_audit.py.  Without a journal nothing is
            # dumped at all — a header-only file would let an audit pass
            # vacuously over zero events
            try:
                self.journal.dump(jdir)
            except OSError as exc:
                debug_verbose(1, "journal dump failed: %s", exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.fini()
        return False


__all__ = ["Context", "ExecutionStream", "TaskpoolState"]
