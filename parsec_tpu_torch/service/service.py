"""JobService: a resident, multi-tenant front door for one warm Context.

The port's copy of the JAX package's service/service.py.  Its deliberate
difference: the Context it builds runs on the card unless
``device="cpu"``/``"cpu:N"`` is passed (the Context's own default).  With
the recovery plane on, the service attaches to it and ``note_recovery``
moves a rank degraded -> recovering -> healthy, as in the JAX package.

The batch shape of the runtime (build Context -> add_taskpool ->
Context.wait -> fini) keeps nothing warm between runs.  The job service
inverts it: ONE long-lived Context (worker streams, devices, comm
threads stay up) accepts a stream of independent jobs and multiplexes
them onto the same scheduler — the PaRSEC capability of multiple
simultaneously-enqueued DAGs on one context (PAPER.md; reference:
parsec_context_add_taskpool is explicitly many-pools-per-context,
scheduling.c:678), grown into a serving front end.

Pieces:

  admission   — a bounded pending queue (``service_max_pending``) and a
                cap on concurrently-attached taskpools
                (``service_max_active``); a full queue rejects
                (AdmissionError) or exerts backpressure
                (``submit(block=True, timeout=...)``).
  fairness    — per-job priority lands on Taskpool.priority, which every
                Task adds to its class priority (core/task.py), so the
                priority schedulers (pbq/ltq/lhq/llp) interleave
                concurrent jobs by weight; the service queue itself
                dispatches by aged priority (``service_aging_weight``
                per second of wait) so low-priority jobs cannot starve.
  lifecycle   — cancel() drops undelivered tasks and force-quiesces the
                pool's termdet (core/taskpool.cancel); deadlines cancel
                the job, never the context; drain()/shutdown() finish
                gracefully.
  isolation   — each job pool carries an error_sink, so one job's
                failure stays on its handle (Context.record_error
                routes it) and the context keeps serving other jobs.
  observability — JobGauges (prof/gauges.py) publishes per-job counters
                through the aggregator path; job lifecycle emits
                job_submit/job_start/job_done PINS events, and tasks
                are attributable via Taskpool.job_id.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from parsec_tpu_torch.core.errors import PeerFailedError
from parsec_tpu_torch.core.taskpool import Compound, Taskpool
from parsec_tpu_torch.prof.gauges import JobGauges
from parsec_tpu_torch.service.job import (AdmissionError, JobHandle,
                                          JobStatus)
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose

params.register("service_max_active", 4,
                "max taskpools concurrently attached to the context")
params.register("service_max_pending", 64,
                "bounded pending-job queue depth before rejection")
params.register("service_priority_scale", 1024,
                "job priority -> task priority multiplier (keeps job "
                "weight above app-internal task priorities)")
params.register("service_aging_weight", 1.0,
                "pending-queue aging: priority points gained per second "
                "of wait (starvation guard; 0 disables)")
params.register("service_poll_interval", 0.02,
                "dispatcher tick in seconds (deadline sweep granularity)")
params.register("service_history_limit", 512,
                "finished jobs kept in the service index (handles held "
                "by callers stay valid after eviction)")


class JobService:
    """Resident job service owning (or wrapping) one warm Context."""

    def __init__(self, context=None, *,
                 max_active: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 aging_weight: Optional[float] = None,
                 **context_kwargs):
        if context is None:
            from parsec_tpu_torch.core.context import Context
            context = Context(**context_kwargs)
            self._own_context = True
        else:
            if context_kwargs:
                raise ValueError("context kwargs need context=None")
            self._own_context = False
        self.context = context
        self._max_active = int(max_active if max_active is not None
                               else params.get("service_max_active", 4))
        self._max_pending = int(max_pending if max_pending is not None
                                else params.get("service_max_pending", 64))
        self._prio_scale = int(params.get("service_priority_scale", 1024))
        self._aging = float(aging_weight if aging_weight is not None
                            else params.get("service_aging_weight", 1.0))
        self._tick = float(params.get("service_poll_interval", 0.02))
        self._history = int(params.get("service_history_limit", 512))
        self._seq = itertools.count(1)
        self._lock = threading.RLock()
        self._space = threading.Condition(self._lock)   # admission room
        self._work = threading.Condition(self._lock)    # dispatcher wakeup
        self._pending: List[JobHandle] = []
        self._running: Dict[int, JobHandle] = {}
        self._jobs: Dict[int, JobHandle] = {}   # insertion-ordered history
        self._draining = False
        self._stop = False
        #: DEGRADED MODE: ranks declared dead while the service runs.
        #: Jobs whose taskpools touched a dead rank were failed by the
        #: containment route (PeerFailedError -> error_sink -> _job_error)
        #: — the service keeps admitting and serving every job that stays
        #: off the dead ranks (single-rank pools, jobs on surviving
        #: ranks); the set is surfaced through stats()/degraded for
        #: operators and load balancers
        self._degraded_ranks: set = set()
        #: ranks a recovery is currently re-executing around (the
        #: degraded -> recovering -> healthy transition the stats
        #: surface and tools/job_client.py expose); guarded-by: _lock
        self._recovering_ranks: set = set()
        self.gauges = JobGauges(self)
        self.gauges.install(context)
        if getattr(context, "recovery", None) is not None:
            # the recovery plane reports start/done/rejoin transitions
            # so degraded-mode bookkeeping UN-degrades (without them
            # these sets would be set-only — a healed service would look
            # sick forever)
            context.recovery.attach_service(self)
        # the always-on metrics registry (prof/metrics.py) folds the
        # service view into its scrape: job queue depths, degraded
        # flag, per-job task counters over the JobGauges window, and
        # the admission->completion SLO histograms fed by the job_*
        # PINS events this service already emits
        if getattr(context, "metrics", None) is not None:
            context.metrics.attach_service(self)
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="job-service", daemon=True)
        self._thread.start()

    # -- submission --------------------------------------------------------
    def submit(self, factory: Callable, *, priority: int = 0,
               deadline: Optional[float] = None, client: str = "",
               name: str = "", block: bool = False,
               timeout: Optional[float] = None) -> JobHandle:
        """Admit a job.  ``factory()`` runs at dispatch time and returns
        a taskpool or ``(taskpool, result_fn)``.  ``deadline`` is a
        wall-clock budget in seconds from submission; on expiry the job
        is cancelled (status TIMEOUT) and the context lives on.

        A full pending queue raises AdmissionError immediately, or —
        with ``block=True`` — blocks up to ``timeout`` seconds for room
        (backpressure) before raising."""
        deadline = None if deadline is None else float(deadline)
        wait_deadline = (None if timeout is None
                         else time.monotonic() + timeout)
        with self._lock:
            while True:
                if self._draining or self._stop:
                    raise AdmissionError("service is draining")
                if len(self._pending) < self._max_pending:
                    break
                if not block:
                    raise AdmissionError(
                        f"pending queue full ({self._max_pending})")
                remaining = (None if wait_deadline is None
                             else wait_deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise AdmissionError(
                        f"pending queue still full ({self._max_pending}) "
                        f"after {timeout}s backpressure wait")
                self._space.wait(remaining)
            job = JobHandle(next(self._seq), factory, priority=priority,
                            deadline=deadline, client=client, name=name,
                            service=self)
            self._pending.append(job)
            self._jobs[job.job_id] = job
            self._work.notify_all()
        self._emit("job_submit", job)
        jr = getattr(self.context, "journal", None)
        if jr is not None:
            # admission decisions are control-plane history: the black
            # box records every admit/dispatch/terminal transition next
            # to the recovery rounds that may explain their latency
            jr.emit("job_admit", job=job.job_id, priority=priority,
                    name=job.name)
        debug_verbose(3, "service: admitted %s prio=%d", job.name, priority)
        return job

    # -- dispatcher --------------------------------------------------------
    def _score(self, job: JobHandle, now_mono: float) -> tuple:
        aged = job.priority + self._aging * (now_mono - job.submitted_mono)
        return (aged, -job.job_id)          # ties: oldest first

    def _dispatch_loop(self) -> None:
        while True:
            try:
                if self._dispatch_once():
                    return
            except Exception as exc:
                # the dispatcher is the service's heartbeat: an escaped
                # exception (bad job field, broken factory interplay)
                # must not silently kill dispatch forever
                debug_verbose(1, "service dispatcher: %r", exc)
                time.sleep(self._tick)

    def _dispatch_once(self) -> bool:
        """One dispatcher iteration; returns True to exit the loop."""
        job = None
        with self._lock:
            if self._stop:
                # leftover pending jobs (drain timed out / forced stop)
                # must not dangle forever
                for j in self._pending:
                    if j._to(JobStatus.CANCELLED):
                        self._emit_done(j)
                self._pending.clear()
                self._space.notify_all()
                return True
            now = time.monotonic()
            self._sweep_deadlines(now)
            job = self._pick_job(now)
            if job is not None:
                self._pending.remove(job)
                self._running[job.job_id] = job
                self._space.notify_all()
            else:
                self._work.wait(self._tick)
        if job is not None:
            # launch off-thread: a slow factory (tile allocation at
            # dispatch time) must not head-of-line-block further
            # dispatch or the deadline sweep
            threading.Thread(target=self._launch, args=(job,),
                             name=f"job-launch-{job.job_id}",
                             daemon=True).start()
        return False

    def _pick_job(self, now_mono: float) -> Optional[JobHandle]:
        """Select the next pending job to dispatch (lock held); None
        keeps the dispatcher waiting.  The base policy is aged-priority
        order under the active cap; the serving fabric overrides this
        with placement-aware admission (service/fabric.py)."""
        if self._pending and len(self._running) < self._max_active:
            return max(self._pending,
                       key=lambda j: self._score(j, now_mono))
        return None

    def _sweep_deadlines(self, now_mono: float) -> None:
        """Expire deadlines (lock held; monotonic clock).  Pool
        cancellation is safe here: termdet callbacks never run while
        holding the termdet lock, and our lock is reentrant for
        same-thread completion callbacks."""
        for job in list(self._pending):
            if job.deadline is not None \
                    and now_mono - job.submitted_mono > job.deadline:
                self._pending.remove(job)
                if job._to(JobStatus.TIMEOUT):
                    self._emit_done(job)
                self._space.notify_all()
        for job in list(self._running.values()):
            if job.deadline is not None \
                    and now_mono - job.submitted_mono > job.deadline:
                if job._to(JobStatus.TIMEOUT) and job.taskpool is not None:
                    job.taskpool.cancel()

    def _launch(self, job: JobHandle) -> None:
        try:
            made = job.factory()
            if not getattr(job, "resumable", False):
                job.factory = None  # one-shot; drop the closure early
                # (a resumable job keeps its factory: a fabric
                # preemption re-queues it and re-runs the factory)
            tp, result_fn = (made if isinstance(made, tuple) else (made,
                                                                   None))
            job._result_fn = result_fn
            self._brand(tp, job)
            job.taskpool = tp
            if not job._to(JobStatus.RUNNING):
                # cancelled / timed out while the factory ran: the pool
                # was never attached; close the job out here (nothing
                # else will emit its job_done)
                tp.cancel()
                with self._lock:
                    self._running.pop(job.job_id, None)
                    self._release_job(job)
                    self._prune_history()
                    self._work.notify_all()
                self._emit_done(job)
                return
            job.started_at = time.time()
            tp.on_complete(lambda _tp, job=job: self._finish(job))
            self._emit("job_start", job)
            jr = getattr(self.context, "journal", None)
            if jr is not None:
                jr.emit("job_start", job=job.job_id,
                        pool=tp.taskpool_id)
            self.context.add_taskpool(tp, start=True)
            if tp.cancelled and not tp.completed:
                # cancel()/deadline fired between _to(RUNNING) and the
                # attach: its cancel saw a CREATED pool and could not
                # quiesce the termdet — re-cancel now that it is
                # attached (same post-attach re-check as Compound._drive)
                tp.cancel()
        except Exception as exc:
            job._exc = exc
            job._to(JobStatus.FAILED)
            with self._lock:
                self._running.pop(job.job_id, None)
                self._release_job(job)
                self._work.notify_all()
            self._emit_done(job)

    def _brand(self, tp: Taskpool, job: JobHandle) -> None:
        """Stamp a job's pool tree: id tag (PINS/gauges attribution),
        priority bias (fairness), and the per-pool error route
        (isolation)."""
        tp.job_id = job.job_id
        tp.priority = job.priority * self._prio_scale
        tp.error_sink = lambda exc, task, job=job: \
            self._job_error(job, exc, task)
        if isinstance(tp, Compound):
            for sub in tp.pools:
                self._brand(sub, job)

    # -- completion / failure ---------------------------------------------
    def _finish(self, job: JobHandle) -> None:
        """Pool termination callback (worker thread).

        A completed pool restarted by the recovery plane (a peer died
        inside its restartable window) TERMINATES A SECOND TIME when
        the replay drains — the re-fired completion is absorbed here,
        below the service seam: the job's terminal transition already
        happened and its one ``job_done`` already emitted (SLO
        histograms, gauges, and client waiters must each see exactly
        one terminal event per job)."""
        if job._done_emitted:
            debug_verbose(2, "service: %s re-completed after a "
                          "recovery restart; absorbed", job.name)
            return
        job._to(JobStatus.DONE)     # keeps FAILED/CANCELLED/TIMEOUT
        if job.status() != JobStatus.DONE:
            # no result will ever be read: drop the result closure (it
            # captures the job's tile collections) right away
            job._result_fn = None
        if self.context.comm is None and job.taskpool is not None:
            # the context registry keeps pools for late remote GETs
            # (Context.taskpools); a single-rank resident service has no
            # remote peers, and keeping every served pool is an O(jobs)
            # leak of tile memory
            self.context.taskpools.pop(job.taskpool.taskpool_id, None)
            if isinstance(job.taskpool, Compound):
                for sub in job.taskpool.pools:
                    self.context.taskpools.pop(sub.taskpool_id, None)
        with self._lock:
            self._running.pop(job.job_id, None)
            self._release_job(job)
            self._prune_history()
            self._work.notify_all()
        self._emit_done(job)

    def _release_job(self, job: JobHandle) -> None:
        """Hook (lock held) fired whenever a job leaves the running
        set, whatever path removed it.  The base service holds no
        placements; the serving fabric overrides this to return the
        job's carved device subset to the free list."""

    def _prune_history(self) -> None:
        """Bound the job index (lock held): a resident service must not
        grow O(jobs served).  Only terminal jobs are evicted — callers'
        handles stay fully usable, they just leave the index/gauges."""
        excess = len(self._jobs) - self._history
        if excess <= 0:
            return
        for jid in [j.job_id for j in self._jobs.values()
                    if j.done][:excess]:
            self._jobs.pop(jid, None)

    def _job_error(self, job: JobHandle, exc: Exception, task) -> None:
        """Per-pool error sink (Context.record_error routes here): fail
        THIS job and drain its pool; the context keeps serving."""
        job._exc = exc
        job._failed_task = task
        if isinstance(exc, PeerFailedError):
            # peer-death containment: the job dies, the SERVICE degrades
            # — record the dead rank so operators see the reduced
            # capacity while unaffected jobs keep running
            job.failed_rank = exc.rank
            with self._lock:
                self._degraded_ranks.add(exc.rank)
            jr = getattr(self.context, "journal", None)
            if jr is not None:
                jr.emit("service_state", peer=exc.rank,
                        state="degraded", cause="containment",
                        job=job.job_id)
        took = job._to(JobStatus.FAILED)
        debug_verbose(2, "service: %s failed on %s: %s", job.name, task,
                      exc)
        if took and job.taskpool is not None:
            job.taskpool.cancel()   # fires _finish via termination

    # -- lifecycle ---------------------------------------------------------
    def cancel(self, job: JobHandle) -> bool:
        with self._lock:
            if job.status() == JobStatus.PENDING:
                in_queue = job in self._pending
                if in_queue:
                    self._pending.remove(job)
                    self._space.notify_all()
                took = job._to(JobStatus.CANCELLED)
                if took:
                    jr = getattr(self.context, "journal", None)
                    if jr is not None:
                        jr.emit("job_cancel", job=job.job_id)
                # a PENDING job not in the queue is in the dispatcher's
                # hands (factory running): _launch's failed RUNNING
                # transition owns the job_done emission there, so only
                # emit for jobs cancelled straight out of the queue
                if took and in_queue:
                    self._emit_done(job)
                return took
            if job.status() != JobStatus.RUNNING:
                return False
            took = job._to(JobStatus.CANCELLED)
            tp = job.taskpool
        if took:
            jr = getattr(self.context, "journal", None)
            if jr is not None:
                jr.emit("job_cancel", job=job.job_id)
        if took and tp is not None:
            tp.cancel()             # termination fires _finish
        return took

    def jobs(self) -> List[JobHandle]:
        """All jobs this service has seen, in submission order."""
        with self._lock:
            return list(self._jobs.values())

    def job(self, job_id: int) -> Optional[JobHandle]:
        with self._lock:
            return self._jobs.get(job_id)

    @property
    def degraded(self) -> bool:
        """True while any peer rank is dead under the service
        (containment kept unaffected jobs running; capacity is
        reduced).  CLEARED when recovery completes or the rank
        rejoins — degraded is a state, not a scar."""
        return bool(self._degraded_ranks)

    def degraded_ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._degraded_ranks)

    def note_recovery(self, event: str, rank: int) -> None:
        """Recovery-plane transitions (core/recovery.py notifier):
        ``start`` marks the rank degraded+recovering, ``done`` heals it
        (re-mapped partition serving again), ``failed`` leaves it
        degraded, ``rejoin`` heals it fully (the rank itself is back).
        Running jobs that were stamped with the failed rank but
        survived through recovery get the stamp cleared; terminally
        FAILED jobs keep theirs — it is their diagnosis."""
        with self._lock:
            if event == "start":
                self._degraded_ranks.add(rank)
                self._recovering_ranks.add(rank)
                jobs = []
                state = "recovering"
            elif event in ("done", "rejoin"):
                self._recovering_ranks.discard(rank)
                self._degraded_ranks.discard(rank)
                jobs = [j for j in self._jobs.values()
                        if j.failed_rank == rank and not j.done]
                state = "healthy"
            else:   # failed: recovery gave up; the degradation stands
                self._recovering_ranks.discard(rank)
                jobs = []
                state = "degraded"
        jr = getattr(self.context, "journal", None)
        if jr is not None:
            jr.emit("service_state", peer=rank, state=state,
                    cause=event)
        for job in jobs:
            job.failed_rank = None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "pending": len(self._pending),
                "running": len(self._running),
                "total": len(self._jobs),
                "max_active": self._max_active,
                "max_pending": self._max_pending,
                "degraded": bool(self._degraded_ranks),
                "degraded_ranks": sorted(self._degraded_ranks),
                "recovering": bool(self._recovering_ranks),
                "recovering_ranks": sorted(self._recovering_ranks),
            }

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting; wait for every admitted job to finish.
        Returns False when ``timeout`` elapsed first (drain stays on)."""
        with self._lock:
            self._draining = True
            jobs = list(self._jobs.values())
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for job in jobs:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not job.wait(remaining):
                return False
        return True

    def shutdown(self, timeout: Optional[float] = None,
                 cancel_jobs: bool = False) -> None:
        """Graceful stop: drain (or cancel everything), stop the
        dispatcher, detach gauges, and fini the context if owned."""
        with self._lock:
            self._draining = True
            jobs = list(self._jobs.values())
        if cancel_jobs:
            for job in jobs:
                self.cancel(job)
        if not self.drain(timeout):
            # drain timed out: force-cancel what's left so the context
            # quiesces before a possible fini (stuck jobs must not keep
            # pools attached through teardown)
            for job in jobs:
                self.cancel(job)
            self.drain(5.0)
        with self._lock:
            self._stop = True
            self._work.notify_all()
            self._space.notify_all()
        self._thread.join(timeout=5)
        self.gauges.uninstall(self.context)
        if getattr(self.context, "metrics", None) is not None:
            self.context.metrics.detach_service(self)
        if getattr(self.context, "recovery", None) is not None:
            self.context.recovery.detach_service(self)
        if self._own_context:
            self.context.fini()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- plumbing ----------------------------------------------------------
    def _sync_devices(self) -> None:
        """Quiesce accelerator pipelines before a job result is read
        (deps release eagerly on dispatch; see Context.wait).  Task
        errors routed through record_error belong to whichever job
        dispatched them — its error_sink already fired — but a SYNC
        failure (timeout, wedged device, stuck chain hold) has no
        error_sink route: the reader's data is not materialized, so it
        must not silently read stale tiles."""
        try:
            self.context.sync_devices(timeout=60.0)
        except Exception as exc:
            debug_verbose(2, "service device sync: %s", exc)
            raise RuntimeError(
                "device sync failed before result read") from exc

    def _emit_done(self, job: JobHandle) -> None:
        """Emit a job's terminal ``job_done`` EXACTLY ONCE, whatever
        path reached it first (completion, failure, cancel, deadline,
        dispatcher stop) and however often a recovery restart re-fires
        the pool's termination afterwards."""
        with job._lock:
            if job._done_emitted:
                return
            job._done_emitted = True
        jr = getattr(self.context, "journal", None)
        if jr is not None:
            jr.emit("job_done", job=job.job_id,
                    status=job.status().name.lower())
        self._emit("job_done", job)

    def _emit(self, event: str, job: JobHandle) -> None:
        """Job-lifecycle PINS events (payload: the JobHandle)."""
        for cb in self.context._pins.get(event, ()):
            try:
                cb(None, event, job)
            except Exception as exc:
                debug_verbose(2, "pins %s callback: %s", event, exc)
