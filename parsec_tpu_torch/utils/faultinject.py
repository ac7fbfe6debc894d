"""Seeded fault-plan engine: deterministic failure injection.

Load-sensitive races taught the usual lesson: they are
observable with the causal tracer but not reproducible on demand.  This
module turns "flake we wait for" into "fault plan we replay" — a seeded,
MCA-configured plan of task/device faults with named hook points
compiled to near-zero-cost checks when no plan is armed (every hook site
guards on the module-global ``ARMED`` flag; one attribute read per
event).

Plan grammar (``PARSEC_MCA_FAULT_PLAN`` / ``--mca fault_plan``)::

    seed=7;fail_task=key~POTRF,n=1;delay_dispatch=ms=5,p=0.1

Directives (``;``-separated; fields ``,``-separated):

``fail_task``     raise FaultInjected in a matching task body
                  (``key~substr`` matches ``str(task)``); exercises the
                  ``task_retry_max`` transient-retry path
``delay_dispatch``  sleep ``ms`` in the device manager before a launch
                  (perturbs manager/completer interleavings); with a
                  ``key~substr`` matcher the delay moves to the WORKER
                  right before a matching task's body runs instead —
                  a deterministic straggler injector

Field forms: ``p=<prob>``, ``n=<count>`` (fire at most n times),
``ms=<millis>``, ``key~<substr>``.

Deliberately narrower than the JAX package's plan: its comm directives
(``drop_frame``, ``dup_frame``, ``delay_frame``, ``delay_recv``,
``trunc_frame``, ``kill_rank``) and the rank-scoped ``degrade`` act on
the comm transport's fault hooks and the health plane; the port's comm
layer leaves those hooks out (they come with the recovery plane), so a
plan naming one raises instead of arming a hook nothing calls.

Determinism: one ``random.Random(seed + 7)`` per process, so a plan
replays the same decision stream modulo thread interleaving — the seeds
vary the schedule, the plan bounds the blast radius.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional

from parsec_tpu_torch.utils.mca import params

params.register("fault_plan", "",
                "seeded fault-injection plan (see utils/faultinject.py "
                "for the grammar); empty = no faults, hook points "
                "compile to one module-flag check")

#: fast-path gate every hook site reads; True only while a plan is armed
ARMED = False

_PLAN: Optional["FaultPlan"] = None
_RUNTIME: Optional["RuntimeFaults"] = None
_lock = threading.Lock()

#: the directive kinds the port acts on (see the module docstring)
_KINDS = ("fail_task", "delay_dispatch")


class _Directive:
    __slots__ = ("kind", "p", "n", "ms", "key", "fired", "lock")

    def __init__(self, kind: str):
        self.kind = kind
        self.p = 1.0
        self.n: Optional[int] = None
        self.ms = 0.0
        self.key: Optional[str] = None
        self.fired = 0
        self.lock = threading.Lock()

    def take(self, rng: random.Random) -> bool:
        """One match attempt: probability/count gates, atomically
        counted so ``n=1`` fires exactly once across threads."""
        with self.lock:
            if self.n is not None and self.fired >= self.n:
                return False
            if self.p < 1.0 and rng.random() >= self.p:
                return False
            self.fired += 1
            return True


def _parse_field(d: _Directive, field: str) -> None:
    field = field.strip()
    if not field:
        return
    if "~" in field and "=" not in field.split("~", 1)[0]:
        k, v = field.split("~", 1)
        if k.strip() == "key":
            d.key = v
            return
    if "=" in field:
        k, v = field.split("=", 1)
        k = k.strip()
        if k == "p":
            d.p = float(v)
        elif k == "n":
            d.n = int(v)
        elif k == "ms":
            d.ms = float(v)
        else:
            raise ValueError(f"unknown fault-plan field {k!r}")
        return
    raise ValueError(f"unparseable fault-plan field {field!r}")


class FaultPlan:
    """A parsed plan: the seed plus its directives, grouped by kind."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        self.directives: List[_Directive] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            name, _, rest = part.partition("=")
            name = name.strip()
            if name == "seed":
                self.seed = int(rest)
                continue
            if name not in _KINDS:
                raise ValueError(
                    f"fault-plan directive {name!r} is not ported (the "
                    f"port acts on {', '.join(_KINDS)})")
            d = _Directive(name)
            for field in rest.split(","):
                _parse_field(d, field)
            self.directives.append(d)

    def of_kind(self, *kinds: str) -> List[_Directive]:
        return [d for d in self.directives if d.kind in kinds]


class RuntimeFaults:
    """Process-wide task/device fault state (one Context per process in
    every supported deployment)."""

    def __init__(self, plan: FaultPlan):
        self.rng = random.Random(plan.seed + 7)
        self.task_dirs = plan.of_kind("fail_task")
        self.disp_dirs = plan.of_kind("delay_dispatch")

    def task_fault(self, task) -> bool:
        for d in self.task_dirs:
            if d.key is not None and d.key not in str(task):
                continue
            if d.take(self.rng):
                return True
        return False

    def device_delay(self) -> None:
        for d in self.disp_dirs:
            if d.key is not None:
                continue   # keyed directives fire per task (task_delay)
            if d.take(self.rng) and d.ms > 0:
                time.sleep(d.ms * 1e-3)

    def task_delay(self, task) -> None:
        """Keyed ``delay_dispatch`` directives: stall a MATCHING task's
        body on the worker — a deterministic straggler."""
        for d in self.disp_dirs:
            if d.key is None or d.key not in str(task):
                continue
            if d.take(self.rng) and d.ms > 0:
                time.sleep(d.ms * 1e-3)


def arm(spec: str) -> FaultPlan:
    """Arm a plan programmatically (tests)."""
    global ARMED, _PLAN, _RUNTIME
    with _lock:
        _PLAN = FaultPlan(spec)
        _RUNTIME = None
        ARMED = bool(_PLAN.directives)
        return _PLAN


def disarm() -> None:
    global ARMED, _PLAN, _RUNTIME
    with _lock:
        ARMED = False
        _PLAN = None
        _RUNTIME = None


def refresh() -> None:
    """Re-read the MCA param (a test that set it after import calls
    this)."""
    spec = str(params.get("fault_plan", "") or "")
    if spec:
        arm(spec)
    elif ARMED and _PLAN is not None and _PLAN.spec != spec:
        disarm()


def runtime() -> Optional[RuntimeFaults]:
    global _RUNTIME
    plan = _PLAN
    if plan is None:
        return None
    with _lock:
        if _RUNTIME is None:
            _RUNTIME = RuntimeFaults(plan)
        return _RUNTIME


def task_fault(task) -> bool:
    """Hook: should this task body raise FaultInjected?  Call only
    behind an ``ARMED`` check."""
    rt = runtime()
    return rt is not None and rt.task_fault(task)


def device_delay() -> None:
    """Hook: pre-dispatch delay.  Call only behind an ``ARMED`` check."""
    rt = runtime()
    if rt is not None:
        rt.device_delay()


def task_delay(task) -> None:
    """Hook: keyed pre-body delay (straggler injection).  Call only
    behind an ``ARMED`` check."""
    rt = runtime()
    if rt is not None:
        rt.task_delay(task)


# a plan set in the environment (PARSEC_MCA_FAULT_PLAN) arms at import
refresh()
