"""Causal tracer: cross-layer span + flow-edge events for one rank.

The per-rank half of the causal trace pipeline (reference: the PINS
task_profiler records *execution* intervals; the comm engine's OTF2
backend records send/recv — here one module owns every causal event so a
merged multi-rank trace decomposes each task's latency into queue-wait /
exec / device / comm segments and carries the flow edges the critical
path needs, prof/critpath.py).

Event classes written into the installed :class:`Profile`:

``queue_wait``
    interval on the selecting worker's stream, ``ready_at`` (stamped by
    core/scheduling.schedule when a tracer is installed) -> select;
    object_id = ``hash(task.key)`` — the same oid the task_profiler's
    exec interval carries, so the two join per task.
``dev:<class>``
    interval on the device stream (``900 + space``): the task's launch
    step ON THE CARD, from the CUDA timing events devices/cuda.py records
    on the launch stream before and after the step, placed on the
    profile's clock through the device's reference event (see "Clocks"
    below).  Written when the completer finalizes the task (the
    ``device_done`` PINS event, whose payload is the device's in-flight
    entry: ``.task``, ``.step``).  A fused wave's n tasks share one
    interval, so a class's device time is the union of its spans, not
    their sum; a chained launch gives its held bodies and its consumer
    wave intervals of their own.  Info ``{"lid", "width", "clock"}``
    (plus ``"part"`` inside a chained launch): the launch id of the
    manager step that enqueued the work (the ``mgr.*`` spans carry it
    as their object id), the step's task count, and ``"device"`` — or
    ``"host"`` on the CPU-backed module, which has no events and stamps
    the host clock around the step, and where an event never completed.
``mgr.idle`` / ``mgr.pop`` / ``mgr.stage_in`` / ``mgr.dispatch`` / ``mgr.depth_wait``
    (class ``stages``, off by default) host intervals of the device
    manager's path on its own stream (``930 + space``), object id = the
    launch id: waiting for work with the queue empty, wave selection
    (the fuse window included), stage-in of the wave, the kernel enqueue
    (chain and hold included), blocked on ``device_inflight_depth``.
``fin.complete`` / ``fin.finalize``
    (class ``stages``) host intervals of the device completer on its own
    stream (``960 + space``): ``complete_execution`` of one task (object
    id = its oid: deps released, successors scheduled), and one
    finalization batch (event probe or sync, unpin, arena release;
    object id = the newest launch id of the batch).
``dep_edge``
    point per LOCAL dependency delivery (the ``deliver_dep`` PINS
    event): object_id = producer oid, info ``{"dst": successor oid}`` —
    the intra-rank DAG edges of the merged causal graph.
``comm_send`` / ``comm_recv``
    point per traced wire frame (comm/remote_dep.py): info carries the
    ``(src_rank, event_seq)`` correlation id, the tag, byte count, and
    — on the recv side — the sender's clock stamp; a matched pair is
    one cross-rank flow edge (Perfetto flow arrows, critpath comm
    segments).
``dep_deliver``
    point per REMOTE delivery on the receiving rank: object_id =
    successor oid, info ``{"corr": ...}`` — binds the flow edge to the
    consumer task.
``dtd_lane``
    point per DTD lane/surrogate operation (dsl/dtd/insert.py): info
    ``{"op", "tile", "lane", "ver", "val"}`` — makes region-lane
    ordering races diagnosable from
    one merged timeline instead of rerun roulette.

``uninstall`` (or :meth:`finalize`) records the rank and the comm
engine's per-peer clock table (offset/rtt/drift, engine.py TAG_CLOCK
ping exchange) into the profile header; prof/critpath.py and
tools/trace2chrome.py --merge align the per-rank timelines with it.

Clocks.  Every timestamp is ``perf_counter`` (CLOCK_MONOTONIC).  At
install the profile header takes an anchor pair (``perf_counter``,
``time.time_ns()``, read together: ``Profile.clock_anchor``), which lays
the spans onto the wall clock a ``torch.profiler`` (CUPTI) trace uses
(``reader.wall_ns``); and each CUDA device module records a reference
event and stamps the host clock beside it (``CudaDevice.anchor_clock``),
so a device span's ends are the reference stamp plus ``elapsed_time``
from the reference event.

``classes`` (like the flight recorder's) picks what is recorded:
``queue`` (queue_wait, and the ready stamps it needs), ``deps``
(dep_edge), ``device`` (dev:), ``stages`` (mgr.* and fin.*), ``comm`` and
``dtd``; the default is every class but ``stages``.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict, Iterable, Optional, Tuple

from parsec_tpu_torch.prof.profiling import EV_END, EV_POINT, EV_START, \
    Profile

#: stream id of the comm/causal point events (workers are 0..n, device
#: streams 900+; 800 keeps the lanes apart in any viewer)
COMM_STREAM = 800

#: host-stage spans of the device module's path (class ``stages``)
STAGE_CLASSES = ("mgr.idle", "mgr.pop", "mgr.stage_in", "mgr.dispatch",
                 "mgr.depth_wait", "fin.complete", "fin.finalize")

#: event-class names with non-task semantics — readers exclude them
#: from "task execution" interval sets
SPECIAL_CLASSES = ("queue_wait", "dep_edge", "comm_send", "comm_recv",
                   "dep_deliver", "dtd_lane") + STAGE_CLASSES

#: what a tracer records unless told otherwise (see the module docstring)
DEFAULT_CLASSES = ("queue", "deps", "device", "comm", "dtd")


class CausalTracer:
    """One per context; pair with a TaskProfilerPins on the SAME
    profile so exec intervals and causal spans share a timeline."""

    def __init__(self, profile: Profile, rank: int = 0,
                 classes: Optional[Iterable[str]] = None):
        self.profile = profile
        self.rank = rank
        self.classes = set(DEFAULT_CLASSES if classes is None else classes)
        self._keys: Dict[str, int] = {}
        self._sbs: Dict[int, Any] = {}
        self._comm_sb = profile.stream(COMM_STREAM, "comm")
        self._corr = itertools.count(1)

    def _hooks(self):
        """(PINS event, handler) pairs of the classes recorded."""
        hooks = []
        if "queue" in self.classes:
            hooks.append(("select", self._select))
        if "deps" in self.classes:
            hooks.append(("deliver_dep", self._deliver_dep))
        if "device" in self.classes:
            hooks.append(("device_done", self._dev_done))
        return hooks

    # -- lifecycle -------------------------------------------------------
    def install(self, context) -> "CausalTracer":
        self.rank = context.rank
        self.profile.set_clock_anchor()
        context._causal_tracer = self
        context._recompute_ready_stamp()
        for event, cb in self._hooks():
            context.pins_register(event, cb)
        if context.comm is not None and "comm" in self.classes:
            context.comm.tracer = self
        return self

    def uninstall(self, context) -> None:
        if getattr(context, "_causal_tracer", None) is self:
            context._causal_tracer = None
            context._recompute_ready_stamp()
        for event, cb in self._hooks():
            context.pins_unregister(event, cb)
        if context.comm is not None and \
                getattr(context.comm, "tracer", None) is self:
            context.comm.tracer = None
        self.finalize(context)

    def finalize(self, context) -> None:
        """Record rank + clock-alignment table into the trace header
        (what the cross-rank merge aligns timestamps with)."""
        self.profile.add_information("rank", str(context.rank))
        self.profile.add_information("nranks", str(context.nranks))
        ce = getattr(context.comm, "ce", None) \
            if context.comm is not None else None
        table = ce.clock_table() if ce is not None else {}
        if table:
            self.profile.add_information(
                "clock_offsets", json.dumps(
                    {str(r): st["offset"] for r, st in table.items()}))
            self.profile.add_information(
                "clock_rtt", json.dumps(
                    {str(r): st["rtt"] for r, st in table.items()}))
            self.profile.add_information(
                "clock_drift", json.dumps(
                    {str(r): st["drift"] for r, st in table.items()}))

    # -- internals -------------------------------------------------------
    def _key(self, name: str) -> int:
        k = self._keys.get(name)
        if k is None:
            k = self._keys[name] = self.profile.add_event_class(name).key
        return k

    def _sb(self, th_id: int, name: str):
        sb = self._sbs.get(th_id)
        if sb is None:
            sb = self._sbs[th_id] = self.profile.stream(th_id, name)
        return sb

    # -- PINS handlers ---------------------------------------------------
    def _select(self, es, event, task) -> None:
        t0 = task.ready_at
        if t0 is None or not self.profile.enabled:
            return
        task.ready_at = None
        sb = self._sb(es.th_id, f"worker-{es.th_id}")
        sb.interval(self._key("queue_wait"), task.taskpool.taskpool_id,
                    self.profile.next_event_id(), hash(task.key), t0)

    def _deliver_dep(self, es, event, payload) -> None:
        if not self.profile.enabled:
            return
        task, succ_tc, succ_locals, _dflow = payload
        try:
            dst = hash(succ_tc.make_key(succ_locals))
        except Exception:
            return     # un-keyable successor: no edge to record
        sb = self._sb(es.th_id, f"worker-{es.th_id}")
        sb.trace(self._key("dep_edge"), EV_POINT,
                 task.taskpool.taskpool_id, self.profile.next_event_id(),
                 hash(task.key), {"dst": dst})

    def _dev_done(self, es, event, inf) -> None:
        """``inf``: the device module's in-flight entry of a finalized
        task; its ``step`` holds the launch step's interval."""
        step = inf.step
        if step is None or not self.profile.enabled:
            return
        task = inf.task
        t0, t1, clock = step.interval()
        info = {"lid": step.lid, "width": step.width, "clock": clock}
        if step.part is not None:
            info["part"] = step.part
        tpid, oid = task.taskpool.taskpool_id, hash(task.key)
        key = self._key(f"dev:{task.task_class.name}")
        eid = self.profile.next_event_id()
        sb = self._sb(es.th_id, f"device-{es.th_id}")
        sb.trace(key, EV_START, tpid, eid, oid, info, timestamp=t0)
        sb.trace(key, EV_END, tpid, eid, oid, timestamp=t1)

    # -- device-module API (called by devices/cuda.py) -------------------
    def stage(self, stream_id: int, stream_name: str, name: str,
              t_begin: float, oid: int = 0,
              t_end: Optional[float] = None) -> None:
        """One host-stage span (``STAGE_CLASSES``) of a device module's
        manager or completer, on its own stream: ``t_begin`` to
        ``t_end`` (default: now, stamped in C)."""
        if not self.profile.enabled:
            return
        sb = self._sb(stream_id, stream_name)
        key, eid = self._key(name), self.profile.next_event_id()
        if t_end is None:
            sb.interval(key, 0, eid, oid, t_begin)
        else:
            sb.trace(key, EV_START, 0, eid, oid, timestamp=t_begin)
            sb.trace(key, EV_END, 0, eid, oid, timestamp=t_end)

    # -- comm-layer API (called by comm/remote_dep.py) -------------------
    def next_corr(self) -> Tuple[int, int]:
        """A fresh (src_rank, event_seq) correlation id for one wire
        frame; the same id rides inside the frame and in both the
        sender's comm_send and the receiver's comm_recv events."""
        return (self.rank, next(self._corr))

    def comm_send(self, tag: int, dst: int, corr: Tuple[int, int],
                  oid: Optional[int], nbytes: int,
                  sent_at: float, tpid: int = 0,
                  src_rank: Optional[int] = None) -> None:
        if not self.profile.enabled:
            return
        # taskpool id rides the record: task identity is (pool, key
        # hash) — two pools' same-named tasks must not collide in the
        # merged DAG (the bench's warmup pool was the forcing case).
        # src_rank is the PRODUCER's rank (the activation's root): a
        # tree-forwarded frame is sent by an intermediate rank but its
        # oid belongs to the producer's trace — the DAG edge must point
        # there, not at the forwarder
        info = {"corr": corr, "tag": tag, "dst": dst, "nbytes": nbytes}
        if src_rank is not None and src_rank != self.rank:
            info["src_rank"] = src_rank
        self._comm_sb.trace(
            self._key("comm_send"), EV_POINT, tpid,
            self.profile.next_event_id(), oid or 0, info,
            timestamp=sent_at)

    def comm_recv(self, tag: int, src: int, corr, sent_at,
                  nbytes: int) -> None:
        if not self.profile.enabled:
            return
        self._comm_sb.trace(
            self._key("comm_recv"), EV_POINT, 0,
            self.profile.next_event_id(), 0,
            {"corr": tuple(corr), "tag": tag, "src": src,
             "sent_at": sent_at, "nbytes": nbytes})

    def dep_deliver(self, corr, oid: int, tpid: int = 0) -> None:
        if not self.profile.enabled:
            return
        self._comm_sb.trace(
            self._key("dep_deliver"), EV_POINT, tpid,
            self.profile.next_event_id(), oid,
            {"corr": tuple(corr) if corr is not None else None})

    # -- DTD lane events (called by dsl/dtd/insert.py) -------------------
    def dtd_event(self, op: str, tile, lane, ver: int,
                  val: Optional[float] = None) -> None:
        if not self.profile.enabled or "dtd" not in self.classes:
            return
        info = {"op": op, "tile": tile, "lane": lane, "ver": ver}
        if val is not None:
            info["val"] = val
        self._comm_sb.trace(self._key("dtd_lane"), EV_POINT, 0,
                            self.profile.next_event_id(), 0, info)


def install_causal_tracer(context, profile: Profile,
                          classes: Optional[Iterable[str]] = None
                          ) -> CausalTracer:
    return CausalTracer(profile, rank=context.rank,
                        classes=classes).install(context)
