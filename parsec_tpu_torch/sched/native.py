"""Native ready-queue scheduler (MCA component ``native``).

The scheduler inner loop in C (parsec_tpu_torch/native/schedext.c): one
METH_FASTCALL crossing per scheduling event carries the whole ready
ring through READY-transition + ``Task.ready_at`` stamping +
priority-ordered insert, and one crossing pops the next task — no
Python-level lock (the GIL is the queue lock; the Python schedulers
pay a ``threading.Lock`` round-trip per queue op ON TOP of the GIL).
The device module's manager and completer threads push here too, under
the same GIL.

Selection: ``--mca sched native`` explicitly, or the default when
``sched_native`` (env ``PARSEC_MCA_SCHED_NATIVE``, default 1) is on —
sched/__init__.create.  The A/B knob: ``PARSEC_MCA_SCHED_NATIVE=0``
restores the Python component ladder (lfq by default).  Unlike the JAX
package, a schedext that does not build raises instead of degrading to
the ladder, so the port keeps no fallback counter.

Ordering contract: priority-ordered, FIFO among equal priorities (the
``ap`` discipline); distance-rescheduled tasks go behind EVERYTHING
(the sched/__init__.py fairness contract — an AGAIN task must not be
re-selected ahead of the work it waits on).
"""

from __future__ import annotations

from typing import List, Optional

from parsec_tpu_torch.core.task import Task, TaskStatus
from parsec_tpu_torch.sched import Scheduler, register
from parsec_tpu_torch.utils.mca import params

params.register("sched_native", 1,
                "use the native (C) scheduler hot path — ready queue, "
                "dep countdown, C task objects, run_quantum — when no "
                "explicit sched component is requested (0 = the Python "
                "component ladder; the A/B knob).  A failed build of "
                "the extension raises")


class NativeSched(Scheduler):
    """One global native priority queue shared by every stream."""

    #: core/scheduling.schedule hands the raw ready ring to
    #: ``schedule()`` untouched — status/ready_at land C-side
    NATIVE_BATCH = True

    def install(self, context) -> None:
        super().install(context)
        from parsec_tpu_torch.native import load_schedext
        self._q = load_schedext().ReadyQueue(TaskStatus.READY)

    # lint: hot-path (ReadyQueue callback: one call per scheduling event)
    def schedule(self, es, tasks: List[Task], distance: int = 0) -> None:
        # one crossing: READY + ready_at (when a telemetry consumer
        # wants it) + priority-heap insert for the whole ring;
        # distance > 0 pins the ring behind everything (fairness)
        self._q.push_batch(tasks, self.context._ready_stamp, distance > 0)

    # lint: hot-path (ReadyQueue callback: one call per selection)
    def select(self, es) -> Optional[Task]:
        return self._q.pop()

    def display_stats(self, es) -> str:
        pushes, pops, max_len, pending = self._q.stats()
        return (f"native: pushes={pushes} pops={pops} "
                f"max_depth={max_len} pending={pending}")

    def stats(self) -> dict:
        """The queue's counters: pushes, pops, max depth, pending."""
        pushes, pops, max_len, pending = self._q.stats()
        return {"pushes": pushes, "pops": pops, "max_depth": max_len,
                "pending": pending}


register("native", NativeSched, priority=0)   # explicit/knob-gated only
