"""Jobs: the unit of submission of the resident job service.

A job wraps a taskpool FACTORY — a zero-argument callable producing the
taskpool (and optionally a result thunk) — plus submission options:
priority, deadline, client id.  The factory runs at DISPATCH time, not
submission time, so queued jobs hold no tile memory while waiting for
an admission slot.

The factory may return either

    taskpool                       -> result() returns None
    (taskpool, result_fn)          -> result() returns result_fn() after
                                      the pool completes

``JobHandle`` is the caller's view: ``result()`` / ``cancel()`` /
``status()`` / ``wait()``, mirroring concurrent.futures discipline but
backed by taskpool termination instead of a thread.
"""

from __future__ import annotations

import threading
import time
from enum import IntEnum
from typing import Any, Callable, Dict, Optional


class JobStatus(IntEnum):
    PENDING = 0     # admitted to the service queue, not yet dispatched
    RUNNING = 1     # taskpool(s) attached to the context
    DONE = 2        # completed normally
    FAILED = 3      # a task raised; error kept job-local
    CANCELLED = 4   # cancel() before completion
    TIMEOUT = 5     # deadline expired; pool cancelled, context kept


class JobError(RuntimeError):
    """A job's task raised; carries the original exception as __cause__."""


class JobCancelled(JobError):
    """result() on a cancelled job."""


class JobTimeout(JobError):
    """result() on a job whose deadline expired."""


class AdmissionError(RuntimeError):
    """Submission rejected: pending queue full (after any backpressure
    wait) or the service is draining/closed."""


#: statuses from which no further transition happens
_TERMINAL = (JobStatus.DONE, JobStatus.FAILED, JobStatus.CANCELLED,
             JobStatus.TIMEOUT)


class JobHandle:
    """One submitted job (created by JobService.submit)."""

    def __init__(self, job_id: int, factory: Callable, *,
                 priority: int = 0, deadline: Optional[float] = None,
                 client: str = "", name: str = "", service=None):
        self.job_id = job_id
        self.name = name or f"job{job_id}"
        self.client = client
        self.priority = int(priority)
        #: wall-clock budget in seconds, measured from submission
        self.deadline = deadline
        self.factory = factory
        self.submitted_at = time.time()
        #: monotonic twin of submitted_at — deadline expiry and queue
        #: aging must not move with NTP steps of the wall clock
        self.submitted_mono = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.taskpool = None
        self._service = service
        self._status = JobStatus.PENDING
        self._result_fn: Optional[Callable[[], Any]] = None
        self._result: Any = None
        self._result_ready = False
        self._exc: Optional[BaseException] = None
        self._failed_task = None
        #: degraded-mode attribution: the peer rank whose death failed
        #: this job (None for ordinary task failures) — set by the
        #: service's containment route (PeerFailedError -> _job_error)
        self.failed_rank: Optional[int] = None
        #: the ONE terminal ``job_done`` emission happened (service
        #: seam: a recovery restart re-firing a completed pool's
        #: termination callbacks must be absorbed below the service —
        #: JobService._emit_done test-and-sets this)
        self._done_emitted = False
        # -- serving-fabric extensions (service/fabric.py); inert under
        # -- the plain JobService ---------------------------------------
        #: declared completion SLO in seconds from submission (None =
        #: best-effort); the fabric quotes a makespan at submit and
        #: queues/rejects/deprioritizes against this
        self.slo: Optional[float] = None
        #: device ask: how many exclusive accelerators to carve (0 =
        #: temporal sharing of the unreserved remainder) and the
        #: elastic ceiling the fabric may grow the subset to
        self.devices_want: int = 0
        self.devices_max: int = 0
        #: the carved memory-space subset while placed (None = shared)
        self.devices: Optional[tuple] = None
        #: preemptible round-trip state: a resumable job keeps its
        #: factory across a preemption (the pool is cancelled, the job
        #: re-queued PENDING, datarepo snapshots ride the recovery
        #: substrate) and counts how many times that happened
        self.resumable = False
        self.preemptions = 0
        self.preempted_at: Optional[float] = None
        #: admission record: the fabric's quoted makespan (seconds) and
        #: verdict ("admit" | "queue" | "deprioritize" | "reject")
        self.quote_eta: Optional[float] = None
        self.verdict: Optional[str] = None
        self._done = threading.Event()
        self._lock = threading.Lock()

    # -- state transitions (service-internal; see JobService) --------------
    def _to(self, status: JobStatus) -> bool:
        """Transition if not already terminal; returns whether it took."""
        with self._lock:
            if self._status in _TERMINAL:
                return False
            self._status = status
            if status in _TERMINAL:
                self.finished_at = time.time()
        if status in _TERMINAL:
            self._done.set()
        return True

    # -- caller API --------------------------------------------------------
    def status(self) -> JobStatus:
        return self._status

    @property
    def done(self) -> bool:
        return self._status in _TERMINAL

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the job reaches a terminal state."""
        return self._done.wait(timeout)

    def cancel(self) -> bool:
        """Cancel the job (pending: dequeue; running: cancel the pool).
        Returns True when the cancellation took, False when the job had
        already finished."""
        if self._service is None:
            return False
        return self._service.cancel(self)

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for completion and return the factory's result (the
        result_fn's return value, or None).  Raises JobCancelled /
        JobTimeout / JobError(cause) per terminal state, TimeoutError
        when ``timeout`` elapses first."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"{self.name}: not finished")
        st = self._status
        if st == JobStatus.CANCELLED:
            raise JobCancelled(f"{self.name} was cancelled")
        if st == JobStatus.TIMEOUT:
            raise JobTimeout(
                f"{self.name} exceeded its deadline ({self.deadline}s)")
        if st == JobStatus.FAILED:
            raise JobError(
                f"{self.name} failed: task {self._failed_task}"
            ) from self._exc
        with self._lock:
            if not self._result_ready:
                if self._service is not None:
                    # device tasks release deps eagerly on dispatch —
                    # pool termination means "all dispatched"; quiesce
                    # accelerators before materializing the result
                    self._service._sync_devices()
                self._result = (self._result_fn()
                                if self._result_fn is not None else None)
                self._result_ready = True
                # the closure captures the job's collections; once the
                # result is cached a resident service must not keep it
                self._result_fn = None
            return self._result

    def exception(self) -> Optional[BaseException]:
        return self._exc

    def info(self) -> Dict[str, Any]:
        """JSON-able description (server front-end / observability)."""
        return {
            "job": self.job_id,
            "name": self.name,
            "client": self.client,
            "priority": self.priority,
            "deadline": self.deadline,
            "status": self._status.name,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "error": (None if self._exc is None
                      else f"{type(self._exc).__name__}: {self._exc}"),
            "failed_rank": self.failed_rank,
            "slo": self.slo,
            "devices": (list(self.devices)
                        if self.devices is not None else None),
            "preemptions": self.preemptions,
            "quote_eta": self.quote_eta,
            "verdict": self.verdict,
        }

    def __repr__(self):
        return f"<JobHandle {self.name} {self._status.name}>"
