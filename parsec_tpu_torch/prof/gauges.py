"""Live runtime gauges: the PAPI-SDE counterpart.

Rebuild of the reference's software-defined-event exports (reference:
parsec/papi_sde.{c,h} — live gauges MEM_ALLOC/MEM_USED/TASKS_ENABLED/
TASKS_RETIRED/SCHEDULER_PENDING_TASKS readable by external consumers
while the runtime runs).  Counters update through PINS events plus
polling hooks; ``snapshot()`` is the external read.
"""

from __future__ import annotations

import threading
from typing import Dict


class Gauges:
    GAUGE_NAMES = ("tasks_enabled", "tasks_retired", "tasks_discarded",
                   "pending_tasks",
                   "device_bytes_in", "device_bytes_out",
                   "device_tasks", "device_evictions",
                   "comm_frames_sent", "comm_frames_recv",
                   "comm_bytes_sent", "comm_bytes_recv",
                   "comm_act_eager", "comm_act_rdv")

    def __init__(self):
        self._lock = threading.Lock()
        self.tasks_enabled = 0     # became ready (scheduled)
        self.tasks_retired = 0     # completed
        self.tasks_discarded = 0   # dropped by pool cancellation
        self.context = None

    def install(self, context) -> None:
        self.context = context
        context.pins_register("select", self._select)
        context.pins_register("complete_exec", self._complete)
        context.pins_register("task_discard", self._discard)

    def uninstall(self, context) -> None:
        context.pins_unregister("select", self._select)
        context.pins_unregister("complete_exec", self._complete)
        context.pins_unregister("task_discard", self._discard)
        self.context = None

    def _select(self, es, event, task) -> None:
        with self._lock:
            self.tasks_enabled += 1

    def _complete(self, es, event, task) -> None:
        with self._lock:
            self.tasks_retired += 1

    def _discard(self, es, event, task) -> None:
        with self._lock:
            self.tasks_discarded += 1

    def snapshot(self) -> Dict[str, float]:
        snap = {
            "tasks_enabled": self.tasks_enabled,
            "tasks_retired": self.tasks_retired,
            "tasks_discarded": self.tasks_discarded,
            "pending_tasks": max(0, self.tasks_enabled - self.tasks_retired
                                 - self.tasks_discarded),
            "device_bytes_in": 0,
            "device_bytes_out": 0,
            "device_tasks": 0,
            "device_evictions": 0,
        }
        ctx = self.context
        for name in ("comm_frames_sent", "comm_frames_recv",
                     "comm_bytes_sent", "comm_bytes_recv",
                     "comm_act_eager", "comm_act_rdv"):
            snap[name] = 0
        if ctx is not None:
            for d in ctx.device_registry.devices[1:]:
                snap["device_bytes_in"] += d.stats.bytes_in
                snap["device_bytes_out"] += d.stats.bytes_out
                snap["device_tasks"] += d.stats.executed_tasks
                snap["device_evictions"] += d.stats.evictions
            comm = getattr(ctx, "comm", None)
            if comm is not None and hasattr(comm, "stats"):
                cs = comm.stats()
                snap["comm_frames_sent"] = cs.get("frames_sent", 0)
                snap["comm_frames_recv"] = cs.get("frames_recv", 0)
                snap["comm_bytes_sent"] = cs.get("bytes_sent", 0)
                snap["comm_bytes_recv"] = cs.get("bytes_recv", 0)
                snap["comm_act_eager"] = cs.get("act_eager", 0)
                snap["comm_act_rdv"] = cs.get("act_rdv", 0)
        return snap


def install_gauges(context) -> Gauges:
    g = Gauges()
    g.install(context)
    return g


class JobGauges:
    """Per-job live gauges for the resident job service
    (service/service.py): aggregate job counts plus per-job task
    counters keyed ``job<N>_*`` so the existing aggregator path
    (prof/aggregator.py GaugePublisher -> Aggregator) publishes them
    unchanged — any ``snapshot()``-bearing object can ride a publisher.

    Task attribution uses the ``job_id`` tag the service plants on each
    job's taskpool(s); tasks of plain batch pools (job_id None) are
    ignored.  Per-job keys are bounded: only the ``max_jobs`` most
    recent jobs keep per-job counters in the snapshot (aggregate counts
    are exact regardless).
    """

    def __init__(self, service, max_jobs: int = 32):
        self._lock = threading.Lock()
        self._service = service
        self._max_jobs = max_jobs
        #: job_id -> [enabled, retired, discarded]
        self._tasks: Dict[int, list] = {}
        self.context = None

    def install(self, context) -> None:
        self.context = context
        context.pins_register("select", self._select)
        context.pins_register("complete_exec", self._complete)
        context.pins_register("task_discard", self._discard)

    def uninstall(self, context) -> None:
        context.pins_unregister("select", self._select)
        context.pins_unregister("complete_exec", self._complete)
        context.pins_unregister("task_discard", self._discard)
        self.context = None

    def _bump(self, task, idx: int) -> None:
        jid = getattr(task.taskpool, "job_id", None)
        if jid is None:
            return
        with self._lock:
            row = self._tasks.get(jid)
            if row is None:
                row = self._tasks[jid] = [0, 0, 0]
                while len(self._tasks) > self._max_jobs:
                    self._tasks.pop(next(iter(self._tasks)))
            row[idx] += 1

    def _select(self, es, event, task) -> None:
        self._bump(task, 0)

    def _complete(self, es, event, task) -> None:
        self._bump(task, 1)

    def _discard(self, es, event, task) -> None:
        self._bump(task, 2)

    def job_task_counts(self, job_id: int) -> Dict[str, int]:
        with self._lock:
            row = self._tasks.get(job_id, (0, 0, 0))
            return {"tasks_enabled": row[0], "tasks_retired": row[1],
                    "tasks_discarded": row[2]}

    def job_task_rows(self):
        """Bounded (job_id, [enabled, retired, discarded]) rows — the
        metrics registry's per-job family rides this window, so its
        label cardinality is capped by max_jobs exactly like the
        gauge keys."""
        with self._lock:
            return [(jid, list(row)) for jid, row in self._tasks.items()]

    def snapshot(self) -> Dict[str, float]:
        import time
        counts: Dict[str, int] = {}
        snap: Dict[str, float] = {}
        now = time.time()
        jobs = list(self._service.jobs())
        for job in jobs:
            st = job.status().name.lower()
            counts[st] = counts.get(st, 0) + 1
        snap["jobs_submitted"] = len(jobs)
        for st in ("pending", "running", "done", "failed", "cancelled",
                   "timeout"):
            snap[f"jobs_{st}"] = counts.get(st, 0)
        with self._lock:
            rows = dict(self._tasks)
        for job in jobs[-self._max_jobs:]:
            jid = job.job_id
            row = rows.get(jid, (0, 0, 0))
            snap[f"job{jid}_tasks_enabled"] = row[0]
            snap[f"job{jid}_tasks_retired"] = row[1]
            snap[f"job{jid}_tasks_discarded"] = row[2]
            snap[f"job{jid}_priority"] = job.priority
            end = job.finished_at if job.finished_at is not None else now
            start = job.started_at
            snap[f"job{jid}_wall_ms"] = (
                0.0 if start is None else round((end - start) * 1e3, 3))
        return snap
