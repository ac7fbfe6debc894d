"""Pluggable schedulers (MCA framework ``sched``).

Rebuild of the reference's scheduler component framework
(reference: parsec/mca/sched/sched.h:325-340 interface; module inventory
SURVEY.md §2.4).  A scheduler provides install / per-stream flow_init /
schedule(es, tasks, distance) / select(es) / display_stats / remove.
The ``distance`` argument is the fairness contract of sched.h:58-99: a
task rescheduled with growing distance must not be immediately re-selected
by the same stream, or AGAIN-returning tasks livelock.

Selection: ``--mca sched <name>`` (reference: parsec_set_scheduler).
"""

from __future__ import annotations

from typing import List, Optional

from parsec_tpu_torch.utils.mca import components
from parsec_tpu_torch.core.task import Task


class Scheduler:
    name = "base"

    #: native-batch contract: when True, core/scheduling.schedule hands
    #: the raw ready ring to ``schedule()`` without the Python
    #: status/ready_at loop — the scheduler performs the READY
    #: transition (and stamping) itself, in one native crossing
    #: (sched/native.py)
    NATIVE_BATCH = False

    def install(self, context) -> None:
        self.context = context

    def flow_init(self, es) -> None:
        pass

    def schedule(self, es, tasks: List[Task], distance: int = 0) -> None:
        raise NotImplementedError

    def select(self, es) -> Optional[Task]:
        raise NotImplementedError

    def display_stats(self, es) -> str:
        return ""

    def remove(self, context) -> None:
        pass


def register(name: str, cls, priority: int = 0) -> None:
    components.add("sched", name, cls, priority=priority)


def create(name: Optional[str] = None) -> Scheduler:
    """The named scheduler, else the MCA ``sched`` param, else the C
    ``native`` ready queue while ``sched_native`` is on (the default),
    else the highest-priority Python component (``lfq``).

    Deliberate difference from the JAX package: no silent fallback.
    There a schedext that does not build degrades to the Python ladder
    with one warning; here it raises (native.NativeBuildError), and
    ``sched_native=0`` is the one way onto the ladder."""
    from parsec_tpu_torch.utils.mca import params
    requested = name or (params.get("sched", "") or None)
    if requested is None and int(params.get("sched_native", 1)):
        from parsec_tpu_torch.native import load_schedext
        load_schedext()   # raises with the compiler's stderr
        requested = "native"
    selected, cls = components.select("sched", requested)
    inst = cls()
    inst.name = selected
    return inst


# Import modules so they self-register.
from parsec_tpu_torch.sched import simple as _simple          # noqa: E402,F401
from parsec_tpu_torch.sched import local_queues as _lq        # noqa: E402,F401
from parsec_tpu_torch.sched import native as _native          # noqa: E402,F401
