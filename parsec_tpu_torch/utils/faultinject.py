"""Seeded fault-plan engine: deterministic failure injection.

Load-sensitive races taught the usual lesson: they are observable with
the causal tracer but not reproducible on demand.  This
module turns "flake we wait for" into "fault plan we replay" — a seeded,
MCA-configured plan of comm/task/device faults with named hook points
compiled to near-zero-cost checks when no plan is armed (every hook site
guards on the module-global ``ARMED`` flag; one attribute read per
event).

Plan grammar (``PARSEC_MCA_FAULT_PLAN`` / ``--mca fault_plan``)::

    seed=7;drop_frame=tag:ACT,p=0.01;kill_rank=1@t+2s,mode=hang;
    delay_frame=tag:DTD,p=0.5,ms=120;fail_task=key~POTRF,n=1

Directives (``;``-separated; fields ``,``-separated):

``drop_frame``    drop a matching outbound frame (the Safra balance is
                  reconciled through the transport's ``app_sent_adjust``
                  hook so termination detection still converges — the
                  DROPPED work hangs, which is the point)
``dup_frame``     send a matching frame twice (receiver-side ``_fid``
                  dedup must recover)
``delay_frame``   hold a matching frame for ``ms`` before sending
                  (reorders it past later frames — the race amplifier)
``delay_recv``    hold a matching RECEIVED frame for ``ms`` before
                  dispatching its handler, while later frames from the
                  same (and every other) peer flow — reorder coverage
                  on the RECEIVE path, where send-side delays cannot
                  reach (a frame reordered by the network arrives
                  in-order per TCP stream; this reorders AFTER framing).
                  ``rank=<src>`` scopes to one source rank
``trunc_frame``   replace a matching frame with an undecodable one (the
                  receiver severs the connection: wire-corruption path)
``kill_rank``     ``<rank>@t+<sec>s`` — at ``sec`` seconds after the
                  engine came up, rank ``<rank>`` hard-closes every
                  socket (``mode=close``, default: EOF-detector path) or
                  goes silent with sockets open (``mode=hang``: only the
                  heartbeat timeout can see it)
``fail_task``     raise FaultInjected in a matching task body
                  (``key~substr`` matches ``str(task)``); exercises the
                  ``task_retry_max`` transient-retry path
``delay_dispatch``  sleep ``ms`` in the device manager before a launch
                  (perturbs manager/completer interleavings); with a
                  ``key~substr`` matcher the delay moves to the WORKER
                  right before a matching task's body runs instead —
                  a deterministic straggler injector (prof/liveattr.py)
``degrade``       ``rank=<r>,ms=<cap>,ramp=<sec>[,at=<sec>]`` — a rank
                  that is DYING, not dead: starting ``at`` seconds after
                  arming, every task body and every outbound frame
                  (heartbeats included) on rank ``r`` gains a delay that
                  ramps linearly from 0 to ``ms`` over ``ramp`` seconds,
                  with seeded ±10%% jitter.  Keep ``ms`` well under the
                  peer heartbeat timeout: the rank must stay ALIVE so
                  only the predictive health plane (prof/health.py) —
                  not the liveness detector — can see it.  This is the
                  drain-before-death validation workload

Field forms: ``tag:NAME`` (frame tag; default = any app tag),
``pm=<substr>`` (substring of ``repr(payload)``), ``p=<prob>``,
``n=<count>`` (fire at most n times), ``ms=<millis>``, ``key~<substr>``,
``<rank>@t+<sec>s``, ``mode=close|hang``, ``rank=<dst>`` (scope a frame
directive to frames bound for one destination rank).

Determinism: one ``random.Random(seed + 1000 * rank)`` per engine/rank,
so a plan replays the same decision stream per rank modulo thread
interleaving — the seeds vary the schedule, the plan bounds the blast
radius.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

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

#: frame-tag name -> wire tag (mirrors comm/engine.py's TAG_* constants;
#: engine.py asserts the mapping at import so the two cannot drift)
TAG_NAMES: Dict[str, int] = {
    "ACT": 1, "ACTIVATE": 1, "GET_REQ": 2, "GET_REP": 3, "TERMDET": 4,
    "BARRIER": 5, "DTD": 6, "BATCH": 7, "UTRIG": 8, "PUT": 9,
    "GET1": 10, "GET1_REP": 11, "CLOCK": 12, "HB": 13, "REJOIN": 16,
    "RECOVER": 17,
}

#: application tags a tag-less frame matcher applies to (dropping the
#: detection plane itself — TERMDET tokens, barriers, heartbeats —
#: would break the algorithms whose job is to DETECT the fault)
_APP_TAGS = frozenset((1, 2, 3, 6, 7, 9, 10, 11))

_FRAME_KINDS = ("drop_frame", "dup_frame", "delay_frame", "trunc_frame")

#: receive-side directives (matched at the receiver, after framing)
_RECV_KINDS = ("delay_recv",)


class _Directive:
    __slots__ = ("kind", "tag", "p", "n", "ms", "rank", "at_s", "mode",
                 "key", "pm", "ramp", "fired", "lock")

    def __init__(self, kind: str):
        self.kind = kind
        self.tag: Optional[int] = None
        self.p = 1.0
        self.n: Optional[int] = None
        self.ms = 0.0
        self.rank: Optional[int] = None
        self.at_s = 0.0
        self.mode = "close"
        self.key: Optional[str] = None
        self.pm: Optional[str] = None
        self.ramp = 10.0
        self.fired = 0
        self.lock = threading.Lock()

    def take(self, rng: random.Random, text: Optional[str] = None) -> bool:
        """One match attempt: payload/probability/count gates, atomically
        counted so ``n=1`` fires exactly once across threads."""
        if self.pm is not None and (text is None or self.pm not in text):
            return False
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
    if field.startswith("tag:"):
        name = field[4:].strip().upper()
        d.tag = TAG_NAMES[name] if name in TAG_NAMES else int(name)
        return
    if "~" in field and "=" not in field.split("~", 1)[0]:
        k, v = field.split("~", 1)
        if k.strip() == "key":
            d.key = v
            return
    if "@" in field and "=" not in field.split("@", 1)[0]:
        # <rank>@t+<sec>s (kill_rank)
        r, at = field.split("@", 1)
        d.rank = int(r)
        at = at.strip().lower()
        if at.startswith("t+"):
            at = at[2:]
        d.at_s = float(at.rstrip("s"))
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
        elif k == "mode":
            d.mode = v.strip().lower()
        elif k == "pm":
            d.pm = v
        elif k == "rank":
            d.rank = int(v)
        elif k == "ramp":
            d.ramp = float(v.rstrip("s"))
        elif k == "at":
            d.at_s = float(v.rstrip("s"))
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
            d = _Directive(name)
            for field in rest.split(","):
                _parse_field(d, field)
            self.directives.append(d)

    def of_kind(self, *kinds: str) -> List[_Directive]:
        return [d for d in self.directives if d.kind in kinds]


def _ramp_ms(d: _Directive, t0: float, rng: random.Random) -> float:
    """Current delay of a ``degrade`` directive: linear ramp from 0 at
    ``t0 + at_s`` to ``ms`` at ``t0 + at_s + ramp``, then held at the
    cap, with seeded ±10% jitter (the jitter IS a signal — inter-arrival
    variance is what a scrape-time health fold can see even after the
    ramp plateaus and the mean gap renormalizes)."""
    el = time.monotonic() - t0 - d.at_s
    if el <= 0.0:
        return 0.0
    frac = min(1.0, el / max(d.ramp, 1e-9))
    val = d.ms * frac
    if val <= 0.0:
        return 0.0
    return val * (0.9 + 0.2 * rng.random())


class CommFaults:
    """Per-engine (per-rank) comm-fault state: a seeded RNG plus the
    plan's frame and kill directives.  Created by ``comm_faults`` at
    transport construction; ``None`` when the plan has no comm
    directives, so the transport keeps a no-hook fast path."""

    def __init__(self, plan: FaultPlan, rank: int):
        self.rng = random.Random(plan.seed + 1000 * rank)
        self.frame_dirs = plan.of_kind(*_FRAME_KINDS)
        self.recv_dirs = plan.of_kind(*_RECV_KINDS)
        self.kill = next((d for d in plan.of_kind("kill_rank")
                          if d.rank == rank), None)
        self.degrade = next((d for d in plan.of_kind("degrade")
                             if d.rank is None or d.rank == rank), None)
        self._t0 = time.monotonic()

    def frame_action(self, tag: int, dst: int,
                     payload: Any) -> Optional[Tuple[str, float]]:
        """First matching frame directive's action for an outbound
        frame: ("drop"|"dup"|"trunc", 0) or ("delay", ms)."""
        text = None
        for d in self.frame_dirs:
            if d.rank is not None and d.rank != dst:
                continue   # rank= scopes a frame directive to one dst
            if d.tag is None:
                if tag not in _APP_TAGS:
                    continue
            elif d.tag != tag:
                continue
            if d.pm is not None and text is None:
                text = repr(payload)[:512] if payload is not None else ""
            if d.take(self.rng, text):
                return (d.kind[:-6], d.ms)   # strip "_frame"
        # degrade: every outbound frame — heartbeats included — gains
        # the ramped delay.  Explicit frame directives take precedence
        # above so composed plans keep their drop/dup/trunc semantics.
        dg = self.degrade
        if dg is not None:
            ms = _ramp_ms(dg, self._t0, self.rng)
            if ms >= 1.0:
                return ("delay", ms)
        return None

    def recv_delay_ms(self, tag: int, src: int,
                      payload: Any) -> Optional[float]:
        """First matching ``delay_recv`` directive's hold time for a
        just-received frame (``rank=`` scopes by SOURCE rank here), or
        None.  The transport re-delivers the frame after the hold —
        later frames dispatch first, which is the coverage."""
        text = None
        for d in self.recv_dirs:
            if d.rank is not None and d.rank != src:
                continue
            if d.tag is None:
                if tag not in _APP_TAGS:
                    continue
            elif d.tag != tag:
                continue
            if d.pm is not None and text is None:
                text = repr(payload)[:512] if payload is not None else ""
            if d.take(self.rng, text):
                return d.ms
        return None


class RuntimeFaults:
    """Process-wide task/device fault state (one Context per process in
    every supported deployment; rank 0 seeding)."""

    def __init__(self, plan: FaultPlan, rank: int = 0):
        self.rng = random.Random(plan.seed + 1000 * rank + 7)
        self.task_dirs = plan.of_kind("fail_task")
        self.disp_dirs = plan.of_kind("delay_dispatch")
        self.degrade = next((d for d in plan.of_kind("degrade")
                             if d.rank is None or d.rank == rank), None)
        self._t0 = time.monotonic()

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
        body on the worker — a deterministic straggler whose class
        peers establish the baseline profile the detector arms from."""
        for d in self.disp_dirs:
            if d.key is None or d.key not in str(task):
                continue
            if d.take(self.rng) and d.ms > 0:
                time.sleep(d.ms * 1e-3)
        dg = self.degrade
        if dg is not None:
            ms = _ramp_ms(dg, self._t0, self.rng)
            if ms >= 1.0:
                time.sleep(ms * 1e-3)


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
    """Re-read the MCA param (spawned workers arm from the inherited
    environment; a test that set the param after import calls this)."""
    spec = str(params.get("fault_plan", "") or "")
    if spec:
        arm(spec)
    elif ARMED and _PLAN is not None and _PLAN.spec != spec:
        disarm()


def comm_faults(rank: int) -> Optional[CommFaults]:
    """The transport's per-rank fault view, or None (no armed plan or no
    comm directives — the transport then skips every per-frame check)."""
    global _RANK
    _RANK = rank   # the transport learns the rank first; runtime() reuses it
    plan = _PLAN
    if plan is None:
        return None
    cf = CommFaults(plan, rank)
    if not cf.frame_dirs and not cf.recv_dirs and cf.kill is None \
            and cf.degrade is None:
        return None
    return cf


#: this process's rank as last reported by the transport (degrade
#: directives scope by rank on the TASK side too, and the task hooks
#: have no rank argument — the transport always constructs first)
_RANK = 0


def runtime(rank: Optional[int] = None) -> Optional[RuntimeFaults]:
    global _RUNTIME
    plan = _PLAN
    if plan is None:
        return None
    with _lock:
        if _RUNTIME is None:
            _RUNTIME = RuntimeFaults(plan, _RANK if rank is None else rank)
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


# spawned ranks inherit PARSEC_MCA_FAULT_PLAN through the environment:
# arming at import means a distributed child needs no explicit call
refresh()
