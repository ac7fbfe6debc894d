"""Remote dependencies: dataflow activation across ranks.

Rebuild of the reference's remote-dep protocol (reference:
parsec/remote_dep.c + remote_dep_mpi.c — activation message carrying task
id + output data (remote_dep_wire_activate_t, remote_dep.h:41-48), eager
payload inlining vs receiver-initiated GET (remote_dep_mpi_get_start:1963),
delayed activations for not-yet-known taskpools (:1831), and collective
propagation along virtual topologies re-rooted at the source — star,
chain pipeline, binomial tree (remote_dep.c:334-357, selected by MCA
``runtime_comm_coll_bcast``)).

Flow: a completing task's release_deps finds successors on other ranks →
activations are buffered per (flow, payload), grouped by destination rank,
and flushed once per task as ONE message down the chosen bcast tree; each
receiving rank delivers its local successor deps (engine.deliver_dep) and
re-forwards to its tree children.  Large payloads travel by rendezvous:
the activation carries a handle, the receiver pulls with GET_REQ and the
source serves GET_REP from a refcounted handle table.

Global quiescence uses Safra's token algorithm over the message counters
(the counterpart of the reference's fourcounter termdet module,
mca/termdet/fourcounter): rank 0 circulates (color, balance); a clean
white round with zero balance means no task and no message is in flight
anywhere, and TERMINATE is broadcast.

The port's copy of the JAX package's comm/remote_dep.py.  Its deliberate
differences:

* payloads are torch tensors.  A producer's tile is snapshotted by
  ``CommEngine.pack`` inside ``flush_activations``, which runs in the
  producer's ``release_deps`` before any local successor is scheduled:
  a card tile is copied down on the launch stream, after its writer and
  before any in-place successor can be launched, so the bytes on the
  wire are the producer's.  A received payload lands as a host ``Data``
  copy holding a CPU tensor, which the device module stages in like any
  host tile;
* the recovery plane's hooks (core/recovery.py) are the JAX package's:
  the per-peer Safra reconcile with the incarnation fence, the ``_ep``
  stamp of a rejoined incarnation, ``forget_pool`` (the DTD backlog and
  the per-generation rendezvous-pull counts included), the DTD lanes'
  pool-generation fences, excused deaths in the quiescence ring,
  ``rearm_dynamic_hold`` and containment's hand-off;
* a send that finds a rank dead before its death reached the recovery
  plane waits for that hand-off (``CommEngine.wait_death_routed``)
  before it fails the pool: the JAX package's sender fails it when it
  loses that race.
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from parsec_tpu_torch.comm.engine import (CommEngine, TAG_ACTIVATE,
                                          TAG_BATCH, TAG_DTD, TAG_GET_REP,
                                          TAG_GET_REQ, TAG_TERMDET,
                                          TAG_UTRIG)
from parsec_tpu_torch.core import scheduling
from parsec_tpu_torch.core.engine import deliver_dep
from parsec_tpu_torch.core.errors import PeerFailedError
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import warning

params.register("comm_eager_limit", 64 * 1024,
                "payloads up to this many bytes ride inside the activation")
params.register("comm_coll_bcast", "binomial",
                "activation fan-out topology: star | chain | binomial")
params.register("comm_adaptive_eager", True,
                "adapt the eager/rendezvous threshold per peer from the "
                "transport's observed frame latency vs drain rate "
                "(starts at comm_eager_limit; backpressure halves it, a "
                "fast-draining pipe raises it toward the cap).  Only "
                "active on transports exporting peer_feedback (evloop)")
params.register("comm_eager_min", 4096,
                "adaptive floor: the per-peer eager threshold never "
                "drops below min(this, comm_eager_limit)")
params.register("comm_eager_cap_mult", 4,
                "adaptive ceiling: per-peer threshold may rise to "
                "comm_eager_limit * this when the peer's pipe drains "
                "fast (payloads that size skip the rendezvous "
                "round-trip)")
params.register("comm_backpressure_ms", 2.0,
                "projected per-peer queue drain delay above which "
                "payloads are demoted to rendezvous (the adaptive "
                "protocol's latency budget)")
params.register("comm_flush_window_ms", 0.0,
                "cross-TASK activation flush window in milliseconds: "
                "same-destination activations of tasks completing "
                "within the window pack into one framed batch "
                "(0 = off: coalescing stays per-task)")
params.register("comm_clock_sync", 1,
                "estimate per-peer clock offset + drift via a TAG_CLOCK "
                "ping exchange (re-probed periodically); recorded into "
                "causal-trace headers for cross-rank merge alignment "
                "(0 = off)")
params.register("comm_clock_probe_s", 5.0,
                "seconds between clock-offset probe rounds")

_handle_seq = itertools.count(1)


def _encode(arr) -> Tuple[bytes, str, Tuple[int, ...]]:
    p = CommEngine.pack(arr)
    return p["buf"], p["dtype"], p["shape"]


def _decode(buf, dtype: str, shape) -> torch.Tensor:
    return CommEngine.unpack({"buf": buf, "dtype": dtype, "shape": shape})


params.register("comm_handle_timeout", 600.0,
                "seconds before an unclaimed rendezvous handle is dropped "
                "(a receiver that never GETs — eager race, dead peer — "
                "must not strand the payload forever; a GET after the "
                "purge fails the RECEIVER with a clear miss, not the "
                "serving rank)")

params.register("comm_rdv_retry_s", 2.0,
                "initial rendezvous retry backoff: a GET_REQ with no "
                "reply is re-sent after this many seconds, doubling per "
                "attempt (the serving side keeps answered handles "
                "around for a grace period, so a duplicate pull is "
                "idempotent)")

params.register("comm_rdv_timeout_s", 60.0,
                "terminal rendezvous deadline: a pull still unanswered "
                "after this many seconds fails ITS taskpool with a "
                "structured PeerFailedError instead of waiting forever")

#: answered (refs == 0) rendezvous handles linger this long so a
#: retransmitted GET_REQ — retry backoff, duplicated frame — can be
#: re-served instead of surfacing a spurious miss.  Sized past the
#: default backoff horizon (comm_rdv_retry_s doubling: 2+4+8+16 = 30s)
#: so every retry a 60s comm_rdv_timeout_s allows finds the handle
_HANDLE_GRACE_S = 30.0


def _msg_nbytes(msg: dict) -> int:
    """Best-effort payload byte count of an app message (trace events)."""
    d = msg.get("data")
    if isinstance(d, tuple) and len(d) >= 2 and hasattr(d[1], "nbytes"):
        return int(d[1].nbytes)
    b = msg.get("buf")
    if hasattr(b, "nbytes"):
        return int(b.nbytes)
    return 0


class _Handle:
    __slots__ = ("data", "refs", "lock", "born", "dead_at", "served")

    def __init__(self, data, refs: int):
        self.data = data
        self.refs = refs
        self.lock = threading.Lock()
        self.born = time.monotonic()
        #: stamped when the last expected ref was served; the handle
        #: then lingers for _HANDLE_GRACE_S (idempotent re-serves)
        self.dead_at: Optional[float] = None
        #: ranks already served once: a RETRANSMITTED pull (retry
        #: backoff stamps a fresh _fid, so dedup cannot see it) must not
        #: consume another requester's ref
        self.served: set = set()


class RemoteDepEngine:
    """Attached to a Context as ``ctx.comm`` (reference: the remote_dep
    layer driven by the comm thread, remote_dep_mpi.c:461)."""

    def __init__(self, ce: CommEngine, context):
        self.ce = ce
        self.context = context
        context.comm = self
        # the inline-poll auto probe must see the affinity of NOW: a
        # fabric-carved worker is re-pinned between Context build and
        # comm attach, and a stale 1-core reading would never arm the
        # spare-core poll (context._recompute_db_spin)
        recompute = getattr(context, "_recompute_db_spin", None)
        if recompute is not None:
            recompute()
        self.rank = ce.rank
        self.nranks = ce.nranks
        self.eager = int(params.get("comm_eager_limit", 65536))
        self.bcast = params.get("comm_coll_bcast", "binomial")
        #: rendezvous handle table (guarded-by: _hlock)
        self._handles: Dict[int, _Handle] = {}
        self._hlock = threading.Lock()
        #: activations buffered during one task's release_deps
        #: (guarded-by: _outbox_lock)
        self._outbox: Dict[int, List] = {}
        self._outbox_lock = threading.Lock()
        #: activations for taskpools not yet registered locally
        #: (guarded-by: _dlock)
        self._delayed: List[Tuple[int, dict]] = []
        self._dlock = threading.Lock()
        # Safra token state (reference counterpart: termdet fourcounter).
        # Only ACTIVATE/GET traffic counts toward the balance; token and
        # barrier messages are part of the detection algorithm itself.
        self._color_black = False           # guarded-by: _term_lock
        self._term_lock = threading.Lock()
        self._terminated = threading.Event()
        self._app_sent = 0                  # guarded-by: _term_lock
        self._app_recv = 0                  # guarded-by: _term_lock
        #: per-peer twins of the Safra counters: a RECOVERY subtracts a
        #: dead rank's whole contribution in one critical section so
        #: the token balance reflects survivor traffic only
        #: (core/recovery.py; guarded-by: _term_lock)
        self._sent_to: Dict[int, int] = {}
        self._recv_from: Dict[int, int] = {}
        #: incarnation fencing: frames from ``src`` whose ``_ep`` is
        #: below the fence are stale traffic of a dead incarnation —
        #: dropped BEFORE the Safra credit (their sender's counters were
        #: reconciled away; guarded-by: _term_lock)
        self._fence_epoch: Dict[int, int] = {}
        self._peer_epoch: Dict[int, int] = {}   # guarded-by: _term_lock
        #: this engine's own incarnation (comm_epoch): stamped into app
        #: frames past epoch 0 so survivors can tell a rejoined rank's
        #: traffic from its dead predecessor's
        self._epoch = int(getattr(ce, "epoch", 0))
        self._retry_pending = False         # guarded-by: _dlock
        #: dynamic taskpools holding a runtime action until the
        #: pool-scoped quiescence round proves global drain (the
        #: reference's dynamic/fourcounter termdet role for
        #: %option dynamic pools; guarded-by: _term_lock)
        self._dyn_holds: List = []
        self._dyn_released = threading.Event()
        ce.on_error = self._on_handler_error
        #: peer-death containment: route a dead rank into the taskpools
        #: that touch it (per-pool error sinks) instead of poisoning the
        #: whole context
        ce.on_peer_dead = self._on_peer_dead
        #: Safra reconcile for injected frame faults (utils/faultinject):
        #: a dropped app frame un-counts its send, a duplicated one
        #: counts twice — the token balance stays convergent either way
        ce.on_frame_fault = self._on_frame_fault
        #: per-message wire id (origin_rank, seq): receivers drop
        #: duplicate deliveries (retransmits, injected dups) after
        #: crediting them in the Safra balance.  The sequence starts at
        #: epoch << 48 so a rejoined incarnation can never collide with
        #: ids its predecessor already burned into peers' dedup windows
        self._fid_seq = itertools.count(1 + (self._epoch << 48))
        self._seen_fids: set = set()
        self._fid_order: "deque" = deque()
        #: causal tracer (prof/causal.py) and flight recorder
        #: (prof/flightrec.py), attached through the ``tracer`` /
        #: ``flightrec`` properties below; ``_sinks`` is the maintained
        #: fan-out tuple every trace site iterates.  Empty = zero
        #: tracing work on every send/recv path
        self._tracer = None
        self._flightrec = None
        self._sinks: Tuple = ()
        #: protocol counters (exported through stats() -> bench bw/rtt;
        #: guarded-by: _proto_lock)
        self.proto: Dict[str, int] = {
            "act_eager": 0, "act_rdv": 0, "act_inline": 0,
            "eager_bytes": 0, "rdv_bytes": 0,
            "coalesced_batches": 0, "coalesced_msgs": 0,
            "eager_downshift": 0, "eager_upshift": 0,
        }
        #: per-peer adaptive eager state: dst -> {"eager": cur, "base":..}
        #: (guarded-by: _proto_lock)
        self._proto_peer: Dict[int, Dict[str, int]] = {}
        # adaptive-law constants cached off the task-retire hot path
        # (each params.get is a registry-lock round trip); the
        # comm_adaptive_eager SWITCH stays a live lookup so tests and
        # operators can flip it mid-run
        self._bp_budget = float(params.get("comm_backpressure_ms",
                                           2.0)) * 1e-3
        self._eager_floor_cfg = int(params.get("comm_eager_min", 4096))
        self._eager_cap_mult = max(
            1, int(params.get("comm_eager_cap_mult", 4)))
        #: guards proto counters + _proto_peer read-modify-writes:
        #: flush_activations runs concurrently on every worker stream
        self._proto_lock = threading.Lock()
        #: cross-task flush window: dst -> [(tag, msg), ...]
        #: (guarded-by: _flush_lock)
        self._flushbox: Dict[int, List] = {}
        self._flush_lock = threading.Lock()
        self._flush_deadline: Optional[float] = None  # guarded-by: _flush_lock
        # Progress model (reference: the comm thread + dep_cmd_queue,
        # remote_dep_mpi.c:461-503).  On a FUNNELLED transport (evloop)
        # the dep-engine work runs directly on the transport's single
        # loop thread: AM callbacks dispatch the handlers in place and
        # sends ride the loop's command ring — zero cross-thread
        # wakeups on the recv->handler->send data path.  On the
        # threaded transport, socket recv threads only ENQUEUE and one
        # dedicated comm-progress thread drains the command queue with
        # per-peer send aggregation (the older path, selectable via
        # PARSEC_MCA_COMM_TRANSPORT=threads for A/B attribution).
        self.funnelled = bool(getattr(ce, "FUNNELLED", False))
        self._cmdq: "queue_mod.Queue" = queue_mod.Queue()
        self._stop = False
        if self.funnelled:
            ce.tag_register(TAG_ACTIVATE, self._activate_cb)
            ce.tag_register(TAG_GET_REQ, self._get_req_cb)
            ce.tag_register(TAG_GET_REP, self._get_rep_cb)
            ce.tag_register(TAG_DTD, self._dtd_cb)
        else:
            ce.tag_register(TAG_ACTIVATE, self._enq_cb("activate"))
            ce.tag_register(TAG_GET_REQ, self._enq_cb("get_req"))
            ce.tag_register(TAG_GET_REP, self._enq_cb("get_rep"))
            ce.tag_register(TAG_DTD, self._enq_cb("dtd"))
        ce.tag_register(TAG_TERMDET, self._termdet_cb)
        ce.tag_register(TAG_BATCH, self._batch_cb)
        ce.tag_register(TAG_UTRIG, self._utrig_cb)
        #: pending GET completions: handle -> (tp_id, deliveries)
        self._pending_gets: Dict[Tuple[int, int], dict] = {}
        #: DTD messages that raced their pool's registration on this rank
        #: (guarded-by: _dlock)
        self._dtd_backlog: Dict[int, List] = {}
        #: outstanding DTD rendezvous pulls (Safra-visible in-flight work:
        #: the one-sided GET itself rides uncounted CE messages;
        #: guarded-by: _term_lock)
        self.dtd_refs_pending = 0
        #: per-pool share of dtd_refs_pending, so a recovery restart can
        #: forget exactly its pool's parked pulls (guarded-by: _term_lock)
        self._dtd_refs_tp: Dict[Tuple[int, int], int] = {}
        self._recv_handlers = {
            "activate": self._activate_cb,
            "get_req": self._get_req_cb,
            "get_rep": self._get_rep_cb,
            "dtd": self._dtd_cb,
        }
        #: cross-task flush window, cached at init (run-scoped knob)
        self._flush_window = float(params.get("comm_flush_window_ms", 0.0))
        #: clock alignment: probe every peer's offset at attach and
        #: periodically after (drift), through the transport's own
        #: progress machinery (the event loop / the progress thread)
        self._clock_on = bool(int(params.get("comm_clock_sync", 1))) \
            and self.nranks > 1
        self._clock_period = max(0.5,
                                 float(params.get("comm_clock_probe_s",
                                                  5.0)))
        #: active failure detection: TAG_HB heartbeats piggyback on the
        #: TAG_CLOCK probe cadence (capped at timeout/3 so a silent peer
        #: is declared within ~2x the timeout even with drifty timers)
        self._peer_timeout = float(params.get("comm_peer_timeout_s",
                                              15.0))
        self._hb_period = max(0.2, min(self._clock_period,
                                       self._peer_timeout / 3.0)) \
            if self._peer_timeout > 0 else 0.0
        self._hb_on = self._peer_timeout > 0 and self.nranks > 1
        #: rendezvous retry/backoff state (see _retry_rendezvous)
        self._rdv_retry = max(0.05, float(params.get("comm_rdv_retry_s",
                                                     2.0)))
        self._rdv_timeout = float(params.get("comm_rdv_timeout_s", 60.0))
        # telemetry plane wiring — BEFORE the progress machinery arms:
        # the first clock-probe round fires at attach on the loop
        # thread, and its accepted RTT must find on_clock_rtt wired
        # (the always-on registry serves TAG_METRICS pulls, an armed
        # flight recorder answers TAG_FLIGHT dump requests)
        m = getattr(context, "metrics", None)
        if m is not None:
            ce.metrics_provider = m.samples
            ce.on_clock_rtt = m.comm_frame_rtt.observe
        jr = getattr(context, "journal", None)
        if jr is not None:
            # control-plane black box: the journal learns this rank's
            # incarnation + clock table, the engine learns where
            # barrier/death events land and how to answer journal pulls
            jr.attach_comm(ce)
        fr = getattr(context, "_flightrec", None)
        if fr is not None:
            fr.attach_comm(self)
        rec = getattr(context, "recovery", None)
        if rec is not None:
            # recovery plane (core/recovery.py): wires the TAG_RECOVER
            # control lane's handler and the TAG_REJOIN validator, and
            # lets the transport accept reconnections from dead ranks
            # pending that handshake
            rec.attach_comm(self)
        if self.funnelled:
            self._progress = None
            ce.add_periodic(self._purge_stale_handles, 5.0)
            ce.add_periodic(self._retry_rendezvous,
                            max(0.25, self._rdv_retry / 2.0))
            if self._clock_on:
                ce.add_periodic(ce.probe_clocks, self._clock_period)
                ce.post(ce.probe_clocks)   # first round at attach
            if self._hb_on:
                ce.add_periodic(ce.heartbeat_tick, self._hb_period)
                ce.add_periodic(ce.check_peer_timeouts, self._hb_period)
            if self._flush_window > 0:
                ce.add_periodic(self._drain_flush_window,
                                max(self._flush_window * 5e-4, 0.001))
        else:
            self._progress = threading.Thread(
                target=self._progress_loop,
                name=f"parsec-comm-{self.rank}", daemon=True)
            self._progress.start()
            if self._clock_on:
                # attach-time first round, like the funnelled path's
                # ce.post above: a run shorter than the first timer
                # tick must still feed clock tables + the frame-RTT
                # histogram.  Safe off the progress thread: SocketCE's
                # probe_clocks pings ESTABLISHED peers only (never
                # parks in _connect); peers still dialing in are
                # covered by the progress loop's fast first-round retry
                try:
                    ce.probe_clocks()
                except OSError:
                    pass

    # ------------------------------------------------------------------
    # funnelled comm progress (reference: remote_dep_dequeue_main)
    # ------------------------------------------------------------------
    def _enq_cb(self, kind: str):
        def cb(src: int, msg: Any) -> None:
            self._cmdq.put(("recv", kind, src, msg))
        return cb

    # lint: on-loop (AM handler)
    def _batch_cb(self, src: int, msgs: List) -> None:
        """Unpack an aggregated frame into individual commands."""
        for tag, payload in msgs:
            self.ce.recv_msgs += 1   # each inner message counts
            self.ce._dispatch(tag, src, payload)

    def send_user_trigger(self, tp_id: int) -> None:
        """Broadcast a user-declared termination to every peer
        (reference: the user_trigger termdet's own AM tag)."""
        for r in range(self.nranks):
            if r != self.rank:
                try:
                    self.ce.send_am(TAG_UTRIG, r, {"tp": tp_id})
                except OSError:
                    pass   # dead peer; its loss is already routed

    # lint: on-loop (AM handler)
    def _utrig_cb(self, src: int, msg: dict) -> None:
        tp = self.context.taskpools.get(msg["tp"])
        if tp is None or tp.termdet is None:
            # raced registration: retry until the SPMD peer reaches
            # add_taskpool (bounded — a missing pool is a program error)
            tries = msg.get("_tries", 0)
            if tries >= 2400:   # ~2 minutes: the pool will never appear
                self.context.record_error(RuntimeError(
                    f"rank {self.rank}: user-trigger for taskpool "
                    f"{msg['tp']} which never registered (mismatched "
                    "SPMD insertion?)"), None)
                return
            if tries and tries % 200 == 0:   # ~every 10s of waiting
                warning("rank %d: user-trigger still waiting for "
                        "taskpool %s to register", self.rank, msg["tp"])
            t = threading.Timer(0.05, self._utrig_cb,
                                args=(src, {**msg, "_tries": tries + 1}))
            t.daemon = True
            t.start()
            return
        tp.termdet.trigger(tp, propagate=False)

    def memcpy_shift(self, dst_copy, src_copy) -> None:
        """Thread-shift a local payload copy onto the comm-progress
        thread (reference: parsec_remote_dep_memcpy's short-circuit,
        remote_dep_mpi.c:557 — local reshape copies ride the comm thread
        so workers never block on memcpy)."""
        if self.funnelled:
            self.ce.post(self._do_memcpy, dst_copy, src_copy)
        else:
            self._cmdq.put(("memcpy", dst_copy, src_copy))

    @staticmethod
    # lint: on-loop (posted onto the comm loop by memcpy_shift)
    def _do_memcpy(dst_copy, src_copy) -> None:
        dst_copy.payload.copy_(src_copy.payload)

    # lint: on-loop (periodic hook on the evloop thread)
    def _purge_stale_handles(self) -> None:
        """GC rendezvous handles no receiver ever pulled (reference gap
        closed: refcounted handles with no timeout would leak if a rank
        in the bcast tree dies or the eager race skips its GET).  Fully
        served handles linger for a short grace (dead_at) so a
        retransmitted GET_REQ can be re-served idempotently."""
        ttl = float(params.get("comm_handle_timeout", 600.0))
        now = time.monotonic()
        stale = []
        with self._hlock:
            for h, handle in list(self._handles.items()):
                if handle.dead_at is not None:
                    if now - handle.dead_at > _HANDLE_GRACE_S:
                        del self._handles[h]   # served; silent drop
                elif now - handle.born > ttl:
                    stale.append(h)
                    del self._handles[h]
        for h in stale:
            warning("rank %d: dropping unclaimed rendezvous handle %d "
                    "after %.0fs", self.rank, h, ttl)
        # the DTD's serve-once regions share the same abandonment GC
        self.ce.purge_once_regions(ttl)

    def _progress_loop(self) -> None:
        next_purge = time.monotonic() + 5.0
        # first clock round right after attach, like the funnelled
        # transport's attach-time post — safe now that SocketCE's
        # probe_clocks pings ESTABLISHED peers only (a short run must
        # still feed the frame-RTT histogram at least one round);
        # then every probe period for drift
        next_clock = time.monotonic() + 0.05 if self._clock_on \
            else float("inf")
        next_hb = time.monotonic() + self._hb_period if self._hb_on \
            else float("inf")
        next_rdv = time.monotonic() + self._rdv_retry
        while not self._stop:
            if time.monotonic() > next_purge:
                self._purge_stale_handles()
                next_purge = time.monotonic() + 5.0
            if time.monotonic() > next_clock:
                probed = 0
                try:
                    probed = self.ce.probe_clocks()
                except OSError:
                    pass
                # a round that reached nobody (peers still dialing in)
                # retries fast: short runs must still get their first
                # accepted sample into the frame-RTT histogram
                next_clock = time.monotonic() + \
                    (self._clock_period if probed else 0.1)
            if time.monotonic() > next_hb:
                try:
                    self.ce.heartbeat_tick()
                except OSError:
                    pass
                self.ce.check_peer_timeouts()
                next_hb = time.monotonic() + self._hb_period
            if time.monotonic() > next_rdv:
                self._retry_rendezvous()
                next_rdv = time.monotonic() + max(0.25,
                                                  self._rdv_retry / 2.0)
            self._drain_flush_window()
            try:
                cmd = self._cmdq.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            batch = [cmd]
            while True:
                try:
                    batch.append(self._cmdq.get_nowait())
                except queue_mod.Empty:
                    break
            #: per-destination send aggregation: consecutive outbound
            #: messages to one peer ride ONE wire frame
            sends: Dict[int, List[Tuple[int, Any]]] = {}
            for cmd in batch:
                try:
                    if cmd[0] == "send":
                        _, tag, dst, payload = cmd
                        sends.setdefault(dst, []).append((tag, payload))
                    elif cmd[0] == "recv":
                        _, kind, src, msg = cmd
                        self._recv_handlers[kind](src, msg)
                    elif cmd[0] == "memcpy":
                        _, dst_copy, src_copy = cmd
                        self._do_memcpy(dst_copy, src_copy)
                except Exception as exc:
                    self._on_handler_error(exc)
            for dst, msgs in sends.items():
                try:
                    if dst in self.ce.dead_peers:
                        continue   # undeliverable; the death was routed
                    if len(msgs) == 1:
                        self.ce.send_am(msgs[0][0], dst, msgs[0][1])
                    else:
                        self.ce.send_am(TAG_BATCH, dst, msgs)
                        # the BATCH frame carried len(msgs) app messages
                        # in one send; the counters already accounted
                        # each at enqueue time
                except OSError:
                    # the lane died mid-send (EOF, dead-peer raise,
                    # SNDTIMEO): the transport's death path already
                    # routed a CONTAINED PeerFailedError into the
                    # touched pools — recording it again here would be
                    # context-GLOBAL and poison every pool on the rank
                    pass
                except Exception as exc:
                    self._on_handler_error(exc)

    def _on_handler_error(self, exc: Exception) -> None:
        self.context.record_error(exc, None)

    # ------------------------------------------------------------------
    # robustness: fault reconcile, dedup, rendezvous retry, containment
    # ------------------------------------------------------------------
    def _on_frame_fault(self, kind: str, tag: int, payload,
                        dst: int = -1) -> None:
        """Safra reconcile for injected frame faults: the counters must
        reflect what actually crossed the wire, or the token never sees
        a zero balance again (a permanent hang the PLAN did not ask
        for).  Only Safra-counted tags matter.  The per-destination
        twin moves WITH the global counter — recovery_reconcile
        subtracts a dead rank's contribution wholesale, and a drift
        between the two would push the post-recovery balance negative
        forever."""
        if tag == TAG_BATCH:
            n = len(payload) if isinstance(payload, list) else 1
        elif tag in (TAG_ACTIVATE, TAG_GET_REQ, TAG_GET_REP, TAG_DTD):
            n = 1
        else:
            return
        d = n if kind == "dup" else -n
        with self._term_lock:
            if dst >= 0 and dst in self._fence_epoch \
                    and dst not in self._sent_to:
                # the injector's delay timer outlived the peer AND its
                # recovery: recovery_reconcile already erased this
                # lane's whole count — subtracting the held frame again
                # would drive the survivor balance permanently negative
                # and the token would never see zero
                return
            self._app_sent += d
            if dst >= 0:
                self._sent_to[dst] = self._sent_to.get(dst, 0) + d

    def _is_dup(self, msg) -> bool:
        """Receiver-side dedup by wire id.  Called AFTER the Safra recv
        credit (the duplicate's send was also counted), bounded memory.
        Runs on the single comm/progress thread of either transport."""
        fid = msg.get("_fid") if isinstance(msg, dict) else None
        if fid is None:
            return False
        if fid in self._seen_fids:
            warning("rank %d: dropped duplicate app message %s",
                    self.rank, fid)
            return True
        self._seen_fids.add(fid)
        self._fid_order.append(fid)
        if len(self._fid_order) > 8192:
            self._seen_fids.discard(self._fid_order.popleft())
        return False

    # lint: on-loop (periodic hook)
    def _retry_rendezvous(self) -> None:
        """Bounded retry with exponential backoff for parked rendezvous
        pulls, and a terminal deadline: a GET whose source died or never
        answers fails ITS taskpool with a structured PeerFailedError
        instead of waiting forever."""
        if not self._pending_gets:
            return
        now = time.monotonic()
        for key, pend in list(self._pending_gets.items()):
            root, handle = key
            exc = None
            if root in self.ce.dead_peers:
                exc = PeerFailedError(
                    root, f"rank {self.rank}: rendezvous source rank "
                          f"{root} died (handle {handle})",
                    detector="rendezvous")
            elif now - pend["sent_at"] > self._rdv_timeout:
                exc = PeerFailedError(
                    root, f"rank {self.rank}: rendezvous pull of handle "
                          f"{handle} from rank {root} unanswered after "
                          f"{self._rdv_timeout:g}s "
                          f"({pend['attempts'] + 1} attempts)",
                    detector="rendezvous")
            if exc is not None:
                if self._pending_gets.pop(key, None) is not None:
                    self._contain_pool(pend["tp"], exc)
                continue
            if now >= pend["next_at"]:
                pend["attempts"] += 1
                pend["next_at"] = now + self._rdv_retry \
                    * (2 ** pend["attempts"])
                warning("rank %d: re-sending rendezvous GET %s to rank "
                        "%d (attempt %d)", self.rank, handle, root,
                        pend["attempts"] + 1)
                try:
                    self._send_app(TAG_GET_REQ, root,
                                   {"handle": handle, "from": self.rank})
                except (PeerFailedError, OSError):
                    # lint: contained (the next sweep sees dead_peers
                    # and fails the pull's pool with the terminal error)
                    pass

    def _on_peer_dead(self, rank: int, exc: Exception) -> None:
        """Containment — with a second exit: a dead peer's taskpools
        (parked rendezvous pulls rooted there, pools that exchanged
        traffic with it via Taskpool.peer_ranks) are first offered to
        the RECOVERY plane (core/recovery.py), which re-executes their
        lost lineage on the survivors; whatever recovery does not take
        fails through the per-pool error route (Context.record_pool_error)
        exactly as before.  Only when nothing can be attributed AND no
        recovery excused the death does the failure land on the context
        globally."""
        pools: Dict[int, Any] = {}
        for key in [k for k in list(self._pending_gets) if k[0] == rank]:
            pend = self._pending_gets.pop(key, None)
            if pend is not None:
                pools[id(pend["tp"])] = pend["tp"]
        for tp in list(self.context.taskpools.values()):
            if rank in getattr(tp, "peer_ranks", ()):
                pools[id(tp)] = tp
        live = [tp for tp in pools.values()
                if not getattr(tp, "completed", False)
                and not getattr(tp, "cancelled", False)]
        handled = False
        rec = getattr(self.context, "recovery", None)
        if rec is not None:
            handled, live = rec.on_peer_dead(rank, exc, live)
        routed = False
        for tp in live:
            routed = True
            self.context.record_pool_error(tp, exc)
        if not routed and not handled:
            self.context.record_error(exc, None)

    def _contain_pool(self, tp, exc: Exception) -> None:
        """Pool-scoped containment with recovery awareness: secondary
        failures of a generation that is already being rebuilt (dead-
        child sends, parked pulls of the torn run) are swallowed — the
        restart owns that pool's fate — everything else routes through
        Context.record_pool_error as before."""
        rec = getattr(self.context, "recovery", None)
        if rec is not None and isinstance(exc, PeerFailedError):
            # a send that saw the rank dead before its death reached the
            # recovery plane: the plane decides once it has it
            self.ce.wait_death_routed(exc.rank)
            if rec.recovering(tp) and rec.excused(exc.rank):
                return
        self.context.record_pool_error(tp, exc)

    # -- recovery reconcile (core/recovery.py) ---------------------------
    def peer_fence(self, src: int) -> int:
        with self._term_lock:
            return self._fence_epoch.get(src, 0)

    def note_peer_epoch(self, src: int, epoch: int) -> None:
        """A rejoined incarnation announced ``epoch``: frames at or
        above it pass the fence, its dead predecessor's stay out."""
        with self._term_lock:
            self._peer_epoch[src] = epoch
            self._fence_epoch.setdefault(src, 0)

    def recovery_reconcile(self, dead: int) -> None:
        """Subtract a dead rank's whole contribution from the Safra
        balance and fence its future stragglers, in ONE critical
        section — after this the token sees exactly the in-flight
        traffic among survivors, so termination detection converges
        once the re-inserted sub-DAG drains (the generalization of the
        on_frame_fault drop reconcile)."""
        with self._term_lock:
            fence = self._fence_epoch[dead] = \
                self._peer_epoch.get(dead, 0) + 1
            sent = self._sent_to.pop(dead, 0)
            recv = self._recv_from.pop(dead, 0)
            self._app_sent -= sent
            self._app_recv -= recv
        jr = getattr(self.context, "journal", None)
        if jr is not None:
            jr.emit("safra_reconcile", peer=dead, fence=fence,
                    sent=sent, recv=recv)

    def forget_pool(self, tp) -> None:
        """Drop every parked/queued protocol item of a pool's torn
        generation (recovery restart): delayed activations, outbox and
        flush-window frames, parked rendezvous pulls, DTD backlog and
        pending-pull counts.  Safra stays balanced: inbound items were
        credited at receive, outbound ones were counted only if they
        reached _send_app (queued-not-sent outbox entries were not)."""
        tpid = tp.taskpool_id
        with self._dlock:
            self._delayed = [(s, m) for (s, m) in self._delayed
                             if not (isinstance(m, dict)
                                     and m.get("tp") == tpid)]
            self._dtd_backlog.pop(tpid, None)
        with self._outbox_lock:
            for key in [k for k, edges in list(self._outbox.items())
                        if edges and edges[0][0].taskpool is tp]:
                self._outbox.pop(key, None)
        with self._flush_lock:
            for dst in list(self._flushbox):
                kept = [(t, m) for (t, m) in self._flushbox[dst]
                        if not (isinstance(m, dict)
                                and m.get("tp") == tpid)]
                if kept:
                    self._flushbox[dst] = kept
                else:
                    del self._flushbox[dst]
        for key, pend in list(self._pending_gets.items()):
            if pend.get("tp") is tp:
                self._pending_gets.pop(key, None)
        with self._term_lock:
            # every generation of this pool: the restart re-registers
            # what the new generation actually pulls
            for key in [k for k in self._dtd_refs_tp if k[0] == tpid]:
                self.dtd_refs_pending -= self._dtd_refs_tp.pop(key)

    def debug_state(self) -> Dict[str, Any]:
        """Protocol-state snapshot for the hang autopsy (Context.wait's
        soft deadline): termdet balance, parked work, per-peer liveness."""
        now = time.monotonic()
        with self._term_lock:
            out: Dict[str, Any] = {
                "app_sent": self._app_sent, "app_recv": self._app_recv,
                "balance": self._app_sent - self._app_recv,
                "color_black": self._color_black,
                "dyn_holds": len(self._dyn_holds),
                "dtd_refs_pending": self.dtd_refs_pending,
            }
        with self._dlock:
            out["delayed_activations"] = len(self._delayed)
            out["dtd_backlog"] = sum(len(v)
                                     for v in self._dtd_backlog.values())
        out["pending_gets"] = {
            f"{root}:{h}": {"attempts": p.get("attempts", 0),
                            "age_s": round(now - p.get("sent_at", now), 2)}
            for (root, h), p in list(self._pending_gets.items())}
        with self._hlock:
            out["serving_handles"] = len(self._handles)
        with self._flush_lock:
            out["flush_window_msgs"] = sum(len(v)
                                           for v in self._flushbox.values())
        out["dead_peers"] = sorted(self.ce.dead_peers)
        out["peers"] = self.ce.peer_debug()
        return out

    # ------------------------------------------------------------------
    # sender side
    # ------------------------------------------------------------------
    def remote_dep_activate(self, es, task, flow, dep, succ_tc, succ_locals,
                            copy) -> None:
        """Buffer one remote successor edge; flushed per task
        (reference: parsec_remote_dep_activate aggregating rank bits)."""
        from parsec_tpu_torch.data.reshape import as_dtt, needs_reshape
        dst = succ_tc.rank_of(succ_locals)
        dtt = as_dtt(dep.dtt)
        if dtt is not None and needs_reshape(copy, dtt):
            # pre-send reshape: the converted payload is what travels
            # (reference: parsec_reshape.c remote pre-send path)
            copy = task.taskpool.reshape.get_copy(copy, dtt)
        with self._outbox_lock:
            self._outbox.setdefault(id(task), []).append(
                (task, flow, copy, dst, succ_tc.name, dict(succ_locals),
                 dep.end.flow))

    def flush_activations(self, es, task) -> None:
        """Group the task's buffered edges by flow payload and pack
        EVERY same-destination activation of the completing task into
        one framed batch (reference: remote_dep.c aggregating all of a
        task's output deps per rank into one activation message — one
        frame/syscall per dependency edge bundle, not per edge).  With
        ``comm_flush_window_ms`` > 0 the batch additionally holds for a
        short window so activations of OTHER tasks completing within it
        coalesce too."""
        with self._outbox_lock:
            edges = self._outbox.pop(id(task), None)
        if not edges:
            return
        byflow: Dict[Tuple, dict] = {}
        for (_t, flow, copy, dst, tc_name, locs, dflow) in edges:
            # group by (flow, payload copy): pre-send reshapes may split
            # one flow into several distinct payloads
            ent = byflow.setdefault((flow.name, id(copy)),
                                    {"copy": copy, "targets": {}})
            ent["targets"].setdefault(dst, []).append((tc_name, locs, dflow))
        tp = task.taskpool
        per_child: Dict[int, List[Tuple[int, dict]]] = {}
        for fname, ent in byflow.items():
            copy = ent["copy"]
            targets = ent["targets"]
            ranks = sorted(targets)
            msg = {
                "tp": tp.taskpool_id,
                "pe": tp.run_epoch,   # recovery generation fence
                "root": self.rank,
                "src_task": str(task),
                "deliveries": {r: targets[r] for r in ranks},
                "ranks": ranks,
            }
            tp.peer_ranks.update(ranks)   # containment attribution
            lin = tp._lineage
            if lin is not None:
                # recovery lineage: the recorded dests seed the
                # minimal-replay plan (tasks that fed a dead rank must
                # re-run so the re-executed partition is re-fed)
                lin.note_send(task, ranks)
            if self._sinks:
                # producer identity for the causal DAG: the same oid the
                # task_profiler's exec interval carries (forwarders keep
                # it, so tree hops still attribute to the producer)
                msg["_oid"] = hash(task.key)
            children = self._children(msg, self.rank)
            if copy is not None:
                # the send snapshot (module docstring): a card tile is
                # copied home here, ordered after its writer
                buf, dt, shape = _encode(copy.payload)
                nbytes = getattr(buf, "nbytes", len(buf))
                thr = min((self._peer_eager(c) for c in children),
                          default=self.eager)
                if nbytes <= thr:
                    msg["data"] = ("eager", buf, dt, shape)
                    with self._proto_lock:
                        self.proto["act_eager"] += 1
                        self.proto["eager_bytes"] += nbytes
                else:
                    h = next(_handle_seq)
                    with self._hlock:
                        self._handles[h] = _Handle((buf, dt, shape),
                                                   refs=len(ranks))
                    msg["data"] = ("get", h, dt, shape)
                    with self._proto_lock:
                        self.proto["act_rdv"] += 1
                        self.proto["rdv_bytes"] += nbytes
            else:
                msg["data"] = None
                with self._proto_lock:
                    self.proto["act_inline"] += 1
            for child in children:
                per_child.setdefault(child, []).append((TAG_ACTIVATE, msg))
        if not per_child:
            return
        window = self._flush_window
        if window > 0:
            with self._flush_lock:
                for child, items in per_child.items():
                    self._flushbox.setdefault(child, []).extend(items)
                if self._flush_deadline is None:
                    self._flush_deadline = time.monotonic() + window * 1e-3
            self._drain_flush_window()   # opportunistic: past-due drains
        else:
            for child, items in per_child.items():
                try:
                    self._send_batch(child, items)
                except PeerFailedError as exc:
                    # a dead child must not cut off its live siblings:
                    # route into the owning pool (the window>0 path's
                    # drain does the same per child)
                    self._contain_pool(tp, exc)

    # lint: on-loop (periodic hook + opportunistic worker calls)
    def _drain_flush_window(self, force: bool = False) -> None:
        """Ship the cross-task flush window once its deadline passed
        (driven by the transport's periodic hook / the progress loop)."""
        if not self._flushbox:
            return
        with self._flush_lock:
            if not self._flushbox:
                return
            if not force and self._flush_deadline is not None and \
                    time.monotonic() < self._flush_deadline:
                return
            box, self._flushbox = self._flushbox, {}
            self._flush_deadline = None
        for child, items in box.items():
            try:
                self._send_batch(child, items)
            except PeerFailedError as exc:
                # window drains run on the comm/progress thread, where
                # nothing catches for us: route into the owning pools
                for tpid in {p.get("tp") for _t, p in items
                             if isinstance(p, dict)}:
                    tp = self.context.taskpools.get(tpid)
                    if tp is not None:
                        self._contain_pool(tp, exc)

    # -- adaptive eager/rendezvous threshold (reference: the eager-limit
    # MCA of remote_dep_mpi.c, made per-peer and feedback-driven) --------
    def _peer_eager(self, dst: int) -> int:
        """Per-peer eager threshold: starts at ``comm_eager_limit``;
        observed backpressure (projected queue drain delay or frame
        latency above the budget) halves it — big payloads then ride
        rendezvous so receivers pull when ready — while a fast-draining
        pipe raises it toward the cap, skipping the GET round-trip."""
        base = self.eager
        if not params.get("comm_adaptive_eager", True):
            return base
        fb_fn = getattr(self.ce, "peer_feedback", None)
        fb = fb_fn(dst) if fb_fn is not None else None
        budget = self._bp_budget
        floor = min(self._eager_floor_cfg, base)
        cap = base * self._eager_cap_mult
        now = time.monotonic()
        # the read-modify-write below is shared across worker streams
        # completing tasks concurrently: a lost adjustment would leave a
        # congested peer's threshold half-lowered
        with self._proto_lock:
            st = self._proto_peer.get(dst)
            if st is None or st["base"] != base:
                # (re)base: tests and benches mutate self.eager mid-run
                st = self._proto_peer[dst] = {"eager": base, "base": base,
                                              "adj_at": 0.0}
            if fb is None:
                return st["eager"]
            # one adjustment per feedback window: a burst of queries
            # within one budget interval sees the SAME stale EWMA
            # sample — shifting once per query would multiply the step
            # and thrash the threshold instead of converging
            if now - st.get("adj_at", 0.0) < budget:
                return st["eager"]
            rate = fb.get("rate_ewma") or 0.0
            pending = fb.get("out_bytes") or 0
            delay = fb.get("delay_ewma") or 0.0
            if rate > 0:
                proj = pending / rate
            else:
                proj = 0.0 if pending < (64 << 10) else 2.0 * budget
            if proj > budget or delay > 4.0 * budget:
                if st["eager"] > floor:
                    st["eager"] = max(floor, st["eager"] // 2)
                    st["adj_at"] = now
                    self.proto["eager_downshift"] += 1
            elif proj < budget / 8.0 and delay < budget / 2.0 and \
                    st["eager"] < cap:
                st["eager"] = min(cap, st["eager"] * 2)
                st["adj_at"] = now
                self.proto["eager_upshift"] += 1
            return st["eager"]

    def stats(self) -> Dict[str, Any]:
        """Protocol + transport counters for the bench's bw/rtt modes
        and the prof gauges."""
        with self._proto_lock:
            out: Dict[str, Any] = dict(self.proto)
            out["peer_eager"] = {r: st["eager"]
                                 for r, st in self._proto_peer.items()}
        out.update(self.ce.stats.as_dict())
        out["msgs_sent"] = self.ce.sent_msgs
        out["msgs_recv"] = self.ce.recv_msgs
        out["transport"] = getattr(self.ce, "TRANSPORT",
                                   "evloop" if self.funnelled
                                   else "threads")
        extra = getattr(self.ce, "extra_stats", None)
        if extra is not None:
            # transport-specific counters (the shm ring exports
            # ring_full stalls + doorbell traffic through here)
            out.update(extra())
        # per-peer comm-delay estimate for the live attribution plane
        # (prof/liveattr.py), folded at SCRAPE time from state the
        # transport already maintains: the clock-probe min-RTT table
        # (one-way wire+dispatch ~ rtt/2) plus the queue->wire drain
        # EWMA of the adaptive protocol's feedback, where the
        # transport keeps one — zero new hot-path work
        delays: Dict[int, float] = {}
        try:
            for r, st in self.ce.clock_table().items():
                delays[r] = float(st.get("rtt", 0.0)) / 2.0
            fb_fn = getattr(self.ce, "peer_feedback", None)
            if fb_fn is not None:
                for r in list(delays):
                    fb = fb_fn(r)
                    if fb and fb.get("delay_ewma"):
                        delays[r] += float(fb["delay_ewma"])
        except Exception:   # a torn-down transport must not kill stats
            pass
        out["peer_comm_delay_s"] = delays
        return out

    # -- bcast topologies (reference: remote_dep.c:334-357, virtual
    # topologies re-rooted at the source) ----------------------------------
    def _children(self, msg: dict, me: int) -> List[int]:
        """My children in the tree over [root] + receiver ranks."""
        nodes = [msg["root"]] + list(msg["ranks"])
        i = nodes.index(me)
        n = len(nodes)
        if self.bcast == "star":
            return nodes[1:] if i == 0 else []
        if self.bcast == "chain":
            return [nodes[i + 1]] if i + 1 < n else []
        # binomial: children of position i are i + 2^j for 2^j < lsb(i)
        # (root's lsb is unbounded); parent(i) = i - lsb(i)
        kids = []
        lsb = i & -i if i else n
        m = 1
        while m < lsb and i + m < n:
            kids.append(nodes[i + m])
            m <<= 1
        return kids

    def _send_tree(self, msg: dict) -> None:
        """Forward down the bcast tree.  A dead child must not cut off
        its LIVE siblings: every child is attempted, and the first
        failure re-raises after the loop for the caller's pool
        routing."""
        first: Optional[PeerFailedError] = None
        for child in self._children(msg, self.rank):
            try:
                self._send_app(TAG_ACTIVATE, child, msg)
            except PeerFailedError as exc:
                if first is None:
                    first = exc
        if first is not None:
            raise first

    def _stamp_fid(self, payload) -> None:
        """Give an app message its wire id (origin rank, seq) — the
        receiver-side dedup key.  Stamped only at the ORIGINATOR (tree
        forwarders relay the id), so one logical message keeps one id
        across every hop and retransmit copies are recognizable."""
        if isinstance(payload, dict) and "_fid" not in payload:
            payload["_fid"] = (self.rank, next(self._fid_seq))

    def _stamp_ep(self, payload) -> None:
        """Incarnation mark, re-stamped PER HOP (unlike the fid): the
        receiver's fence is keyed by the rank it physically received
        the frame from, so ``_ep`` must name the LAST sender's
        incarnation — a rejoined rank relaying an epoch-0 originator's
        activation down the bcast tree must not have the relay fenced
        as its dead predecessor's straggler.  First incarnations
        (epoch 0) stamp nothing — a fence only ever exists for ranks
        that died, and a rejoiner is epoch >= 1 by construction."""
        if self._epoch and isinstance(payload, dict):
            payload["_ep"] = self._epoch

    def _dead_peer_guard(self, dst: int) -> None:
        if dst in self.ce.dead_peers:
            raise PeerFailedError(
                dst, f"rank {self.rank}: send to dead rank {dst}",
                detector="send")

    def _send_app(self, tag: int, dst: int, payload) -> None:
        """Application-message send: counted and blackening (Safra).
        On the event-loop transport the frame goes straight onto the
        loop's command ring; on the threaded transport it funnels
        through the comm-progress thread which aggregates per-peer
        (reference: remote_dep_dequeue_send).  A send to a DEAD rank
        raises a structured PeerFailedError instead of silently
        queueing — callers route it into the owning taskpool."""
        self._dead_peer_guard(dst)
        self._stamp_fid(payload)
        self._stamp_ep(payload)
        with self._term_lock:
            self._color_black = True
            self._app_sent += 1
            self._sent_to[dst] = self._sent_to.get(dst, 0) + 1
        if self._sinks:
            payload = self._traced(tag, dst, payload)
        self._post_send(tag, dst, payload)

    def _send_batch(self, dst: int, items: List[Tuple[int, Any]]) -> None:
        """Send several application messages to one destination as ONE
        wire frame (TAG_BATCH); each inner message stays individually
        counted for Safra (the receiver's _batch_cb mirrors this)."""
        self._dead_peer_guard(dst)
        for _tag, p in items:
            self._stamp_fid(p)
            self._stamp_ep(p)
        with self._term_lock:
            self._color_black = True
            self._app_sent += len(items)
            self._sent_to[dst] = self._sent_to.get(dst, 0) + len(items)
        if self._sinks:
            # per inner message: each gets its own correlation id; the
            # receiver's _batch_cb re-dispatches them individually, so
            # every flow edge survives coalescing
            items = [(tag, self._traced(tag, dst, p)) for tag, p in items]
        if len(items) == 1:
            self._post_send(items[0][0], dst, items[0][1])
            return
        with self._proto_lock:
            self.proto["coalesced_batches"] += 1
            self.proto["coalesced_msgs"] += len(items)
        self._post_send(TAG_BATCH, dst, list(items))

    # -- causal tracing (prof/causal.py) + flight recorder: every traced
    # app frame carries a send timestamp + (src_rank, event_seq)
    # correlation id; matched comm_send/comm_recv events become the
    # merged trace's flow edges.  The ``tracer``/``flightrec``
    # properties maintain ``_sinks`` so every site below fans out over
    # ONE tuple.
    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, value) -> None:
        self._tracer = value
        self._resinks()

    @property
    def flightrec(self):
        return self._flightrec

    @flightrec.setter
    def flightrec(self, value) -> None:
        self._flightrec = value
        self._resinks()

    def _resinks(self) -> None:
        # tracer FIRST: its counter issues the correlation id when both
        # are live, so the ring's flow edges match the full trace's
        self._sinks = tuple(s for s in (self._tracer, self._flightrec)
                            if s is not None)

    def _traced(self, tag: int, dst: int, payload):
        sinks = self._sinks
        if not sinks or not isinstance(payload, dict):
            return payload
        corr = sinks[0].next_corr()
        now = time.perf_counter()
        # shallow copy: tree forwarding reuses one msg dict for several
        # children — each SEND is its own flow edge with its own id
        payload = dict(payload, _corr=corr, _sent_at=now)
        tp = payload.get("tp")
        root = payload.get("root")
        tpid = tp if isinstance(tp, int) else 0
        src_rank = root if isinstance(root, int) else None
        nbytes = _msg_nbytes(payload)
        for sink in sinks:
            sink.comm_send(tag, dst, corr, payload.get("_oid"),
                           nbytes, now, tpid=tpid, src_rank=src_rank)
        return payload

    def _trace_recv(self, tag: int, src: int, msg) -> None:
        sinks = self._sinks
        if not sinks or not isinstance(msg, dict):
            return
        corr = msg.get("_corr")
        if corr is None:
            return
        sent_at = msg.get("_sent_at")
        nbytes = _msg_nbytes(msg)
        for sink in sinks:
            sink.comm_recv(tag, src, corr, sent_at, nbytes)

    def _post_send(self, tag: int, dst: int, payload) -> None:
        if self.funnelled:
            self.ce.send_am(tag, dst, payload)
        else:
            self._cmdq.put(("send", tag, dst, payload))

    # ------------------------------------------------------------------
    # receiver side
    # ------------------------------------------------------------------
    def _on_app_recv(self, src: int, msg=None) -> bool:
        """Safra credit for one received app message; returns False —
        and credits NOTHING — when the frame is fenced: a straggler of
        a dead incarnation whose counters recovery_reconcile already
        subtracted (crediting it would push the survivor balance
        negative forever).  The fence check and the credit share one
        critical section so a concurrent reconcile can never see half
        of either."""
        with self._term_lock:
            fence = self._fence_epoch.get(src)
            if fence is not None:
                ep = msg.get("_ep", 0) if isinstance(msg, dict) else 0
                if ep < fence:
                    return False
            self._color_black = True   # Safra: receiving blackens
            self._app_recv += 1
            self._recv_from[src] = self._recv_from.get(src, 0) + 1
        return True

    # lint: on-loop (AM handler: runs in place on the evloop thread)
    def _activate_cb(self, src: int, msg: dict) -> None:
        self._trace_recv(TAG_ACTIVATE, src, msg)
        if not self._on_app_recv(src, msg):   # exactly once per message
            return            # fenced: stale incarnation straggler
        if self._is_dup(msg):
            return            # retransmit/injected dup: already acted on
        self._try_activation(src, msg)

    def _try_activation(self, src: int, msg: dict) -> None:
        from parsec_tpu_torch.core.taskpool import TaskpoolState
        tp = self.context.taskpools.get(msg["tp"])
        if tp is not None and msg.get("pe", 0) < tp.run_epoch:
            # a torn recovery generation's activation (this pool already
            # restarted past it): the Safra credit landed, the delivery
            # is void — the restart re-enumerated every dependence
            return
        if tp is None or tp.state < TaskpoolState.RUNNING \
                or msg.get("pe", 0) > tp.run_epoch:
            # unknown taskpool, known but startup hasn't counted local
            # tasks yet, known but mid-recovery-restart (state rewound
            # below RUNNING parks EVERYTHING until the new generation's
            # structures exist), or a peer that finished ITS restart
            # before we even began ours (pe from the future): releasing
            # now would land in structures about to be torn down
            # (reference: delayed activations, remote_dep_mpi.c:1831).
            # One daemon timer at a time closes the race where the pool
            # became RUNNING and drained the queue between our state
            # check and the append.
            with self._dlock:
                self._delayed.append((src, msg))
                arm = not self._retry_pending
                if arm:
                    self._retry_pending = True
            if arm:
                t = threading.Timer(0.05, self.retry_delayed)
                t.daemon = True
                t.start()
            return
        self._process_activation(tp, msg)

    def retry_delayed(self) -> None:
        """Re-run activations that raced taskpool registration
        (reference: delayed activate queue, remote_dep_mpi.c:1831)."""
        with self._dlock:
            delayed, self._delayed = self._delayed, []
            self._retry_pending = False
        for src, msg in delayed:
            self._try_activation(src, msg)

    def _process_activation(self, tp, msg: dict) -> None:
        tp.peer_ranks.add(msg["root"])   # containment attribution
        # forward down the tree first (pipeline: data flows while we
        # work); a dead child fails THIS pool, not the whole context
        try:
            self._send_tree(msg)
        except PeerFailedError as exc:
            self._contain_pool(tp, exc)
        data = msg["data"]
        deliveries = msg["deliveries"].get(self.rank) or \
            msg["deliveries"].get(str(self.rank))
        if not deliveries:
            return
        corr = msg.get("_corr")
        if data is None:
            self._deliver(tp, deliveries, None, corr=corr)
        elif data[0] == "eager":
            _, buf, dt, shape = data
            self._deliver(tp, deliveries, _decode(buf, dt, shape),
                          corr=corr)
        else:   # rendezvous: pull the payload from the root
            _, handle, dt, shape = data
            key = (msg["root"], handle)
            now = time.monotonic()
            self._pending_gets[key] = {"tp": tp, "deliveries": deliveries,
                                       "corr": corr, "sent_at": now,
                                       "attempts": 0,
                                       "next_at": now + self._rdv_retry}
            try:
                self._send_app(TAG_GET_REQ, msg["root"],
                               {"handle": handle, "from": self.rank})
            except PeerFailedError as exc:
                self._pending_gets.pop(key, None)
                self._contain_pool(tp, exc)

    # lint: on-loop (AM handler)
    def _get_req_cb(self, src: int, msg: dict) -> None:
        self._trace_recv(TAG_GET_REQ, src, msg)
        if not self._on_app_recv(src, msg):
            return
        if self._is_dup(msg):
            return
        h = msg["handle"]
        with self._hlock:
            handle = self._handles.get(h)
        if handle is None:
            # purged (TTL) or never existed: report the miss to the
            # rank that actually cannot proceed — the requester — rather
            # than crashing the serving rank (the requester is still
            # alive by definition; if it died, the send guard raises
            # into _safe_dispatch and the death was already routed)
            try:
                self._send_app(TAG_GET_REP, src,
                               {"handle": h, "miss": True,
                                "root": self.rank})
            except PeerFailedError:
                # lint: contained (the requester died; its death was
                # already routed into the pools that touch it)
                pass
            return
        buf, dt, shape = handle.data
        try:
            self._send_app(TAG_GET_REP, src,
                           {"handle": h, "buf": buf, "dtype": dt,
                            "shape": shape, "root": self.rank})
        except PeerFailedError:
            # lint: contained (requester died — its death was already
            # routed; keep the handle for live readers)
            return
        with handle.lock:
            # fully-served handles LINGER (dead_at) for a grace period
            # instead of dropping instantly: a retransmitted GET_REQ
            # (retry backoff, duplicated frame) re-serves idempotently —
            # and decrements refs only ONCE per requester, else a slow
            # requester's retry would consume a sibling's ref and start
            # the grace purge while that sibling's pull is still parked
            if src not in handle.served:
                handle.served.add(src)
                handle.refs -= 1
                if handle.refs <= 0 and handle.dead_at is None:
                    handle.dead_at = time.monotonic()

    # lint: on-loop (AM handler)
    def _get_rep_cb(self, src: int, msg: dict) -> None:
        self._trace_recv(TAG_GET_REP, src, msg)
        if not self._on_app_recv(src, msg):
            return
        if self._is_dup(msg):
            return
        key = (msg["root"], msg["handle"])
        pend = self._pending_gets.pop(key, None)
        if pend is None:
            return
        if msg.get("miss"):
            # contained: the pull's OWNING pool fails, not the context
            # (the handle expired server-side — TTL or a grace window
            # the retry backoff outlived)
            self._contain_pool(pend["tp"], PeerFailedError(
                src, f"rank {self.rank}: rendezvous payload "
                     f"{msg['handle']} from rank {src} expired before "
                     "our GET (comm_handle_timeout)",
                detector="rendezvous"))
            return
        arr = _decode(msg["buf"], msg["dtype"], msg["shape"])
        self._deliver(pend["tp"], pend["deliveries"], arr,
                      corr=pend.get("corr"))

    # ------------------------------------------------------------------
    # distributed DTD traffic (reference: the DTD two-sided protocol —
    # remote deps tracked by (tile, rank) with delayed release,
    # remote_dep_mpi.c:519, insert_function.c:3014-3163)
    # ------------------------------------------------------------------
    def dtd_send(self, dst: int, msg: dict) -> None:
        """Counted application send for the DTD layer (Safra-visible).
        Raises PeerFailedError when ``dst`` is dead — callers on worker
        threads route it into the pool via record_error."""
        tp = self.context.taskpools.get(msg.get("tp"))
        if tp is not None:
            tp.peer_ranks.add(dst)
            # recovery generation: a survivor mid-restart parks frames
            # of its already-recovered peer instead of losing them
            msg.setdefault("pe", tp.run_epoch)
        self._send_app(TAG_DTD, dst, msg)

    def dtd_ref_done(self, ref_key=None) -> None:
        """One rendezvous pull completed (locked: the counter is shared
        between the progress thread and socket recv threads).
        ``ref_key`` is the (taskpool_id, pool-generation) the pull was
        credited under in _dtd_cb.  A pull whose pool a recovery
        already forgot (forget_pool subtracted that generation's whole
        share) must NOT decrement again — the double-count would drive
        the global below zero, and a truthy negative keeps _local_idle
        False forever; the generation in the key also stops a
        pre-restart pull's completion from eating the NEW generation's
        count."""
        with self._term_lock:
            if ref_key is not None:
                n = self._dtd_refs_tp.get(ref_key)
                if n is None:
                    return   # forgotten by a recovery restart
                if n <= 1:
                    self._dtd_refs_tp.pop(ref_key, None)
                else:
                    self._dtd_refs_tp[ref_key] = n - 1
            self.dtd_refs_pending -= 1

    # lint: on-loop (AM handler)
    def _dtd_cb(self, src: int, msg: dict) -> None:
        self._trace_recv(TAG_DTD, src, msg)
        # For rendezvous refs the pending-pull count must become visible
        # ATOMICALLY with the message credit: crediting first opens a
        # window where the Safra token sees an even balance and empty
        # queues while the pull hasn't been registered yet.  A duplicate
        # is credited (its send was counted too) but must NOT register a
        # second pull — the leaked pending count would hang termination
        from parsec_tpu_torch.core.taskpool import TaskpoolState
        dup = self._is_dup(msg)
        tp = self.context.taskpools.get(msg.get("tp")) \
            if isinstance(msg, dict) else None
        pe = msg.get("pe", 0) if isinstance(msg, dict) else 0
        # a torn generation's message is credited (its sender is live
        # and counted) but takes NO side effects — in particular its
        # 'ref' must not register a pull nobody will ever complete
        stale = tp is not None and pe < tp.run_epoch
        with self._term_lock:
            fence = self._fence_epoch.get(src)
            if fence is not None and \
                    (msg.get("_ep", 0) if isinstance(msg, dict)
                     else 0) < fence:
                return   # stale incarnation: no credit, no delivery
            self._color_black = True
            self._app_recv += 1
            self._recv_from[src] = self._recv_from.get(src, 0) + 1
            if not dup and not stale and isinstance(msg, dict) \
                    and "ref" in msg:
                # keyed by (pool, generation): a restart's forget_pool
                # subtracts exactly the torn generation's share, and a
                # pre-restart pull completing late cannot eat the new
                # generation's count (dtd_ref_done misses its key)
                key = (msg.get("tp"), pe)
                self.dtd_refs_pending += 1
                self._dtd_refs_tp[key] = \
                    self._dtd_refs_tp.get(key, 0) + 1
        if dup or stale:
            return
        if tp is not None:
            tp.peer_ranks.add(src)
        incoming = getattr(tp, "_dtd_incoming", None)
        if incoming is not None and pe <= tp.run_epoch and \
                (tp.run_epoch == 0
                 or tp.state >= TaskpoolState.RUNNING):
            # past a restart (run_epoch > 0) frames additionally wait
            # for the rebuilt structures (state back at RUNNING) in the
            # backlog; the pristine-pool fast path is unchanged
            incoming(src, msg)
            return
        with self._dlock:   # pool not registered here yet: backlog
            self._dtd_backlog.setdefault(msg["tp"], []).append((src, msg))
        # re-check: the pool may have registered — and drained an empty
        # backlog — between the lookup above and the append (the drain
        # pops under _dlock, so a second drain cannot double-deliver).
        # The SAME deliverability gate as above applies: a pool parked
        # below RUNNING by a recovery restart must keep the frame in
        # the backlog, or the mid-restart parking would be a no-op
        # (immediate re-drain into the half-torn structures)
        tp = self.context.taskpools.get(msg["tp"])
        if tp is not None \
                and getattr(tp, "_dtd_incoming", None) is not None \
                and (tp.run_epoch == 0
                     or tp.state >= TaskpoolState.RUNNING):
            self.dtd_drain_backlog(tp)

    def dtd_drain_backlog(self, tp) -> None:
        """Deliver DTD messages that arrived before ``tp`` registered.
        Generation-aware: frames of a torn generation drop (their Safra
        credit already landed), frames from a generation we have not
        reached yet re-park for the next drain."""
        with self._dlock:
            backlog = self._dtd_backlog.pop(tp.taskpool_id, [])
        keep = []
        for src, msg in backlog:
            pe = msg.get("pe", 0) if isinstance(msg, dict) else 0
            if pe < tp.run_epoch:
                continue   # torn generation: credited, void
            if pe > tp.run_epoch:
                keep.append((src, msg))
                continue
            tp._dtd_incoming(src, msg)
        if keep:
            with self._dlock:
                self._dtd_backlog.setdefault(tp.taskpool_id,
                                             []).extend(keep)

    def _deliver(self, tp, deliveries, array: Optional[torch.Tensor],
                 corr=None) -> None:
        """Release the incoming deps locally (reference:
        remote_dep_release_incoming, remote_dep.c:964).  ``corr`` is
        the activation frame's correlation id: each delivered successor
        gets a dep_deliver trace event binding the cross-rank flow edge
        to the consumer task."""
        from parsec_tpu_torch.data.data import Coherency, Data
        ready = []
        copy = None
        if array is not None:
            # ONE shared copy for every local consumer of this payload —
            # exactly how local successors share the producer's copy
            # (_decode already returned a private array)
            datum = Data(nb_elts=array.nbytes)
            copy = datum.create_copy(0, payload=array,
                                     coherency=Coherency.SHARED, version=1)
        from parsec_tpu_torch.data.reshape import as_dtt, needs_reshape
        sinks = self._sinks
        replay_filter = tp._replay_filter
        for tc_name, locs, dflow in deliveries:
            tc = tp.task_classes.get(tc_name)
            if tc is None:
                raise RuntimeError(f"unknown task class {tc_name!r}")
            if replay_filter is not None and \
                    tc.make_key(tc.complete_locals(locs)) \
                    not in replay_filter:
                # minimal-replay restart: a re-sending peer's activation
                # for a consumer whose output is already materialized
                # here — the Safra credit landed at receive; the
                # delivery itself is redundant and must not instantiate
                # an uncounted task into the restarted generation
                continue
            if sinks:
                try:
                    oid = hash(tc.make_key(locs))
                except Exception:
                    oid = None   # un-keyable locals: skip the trace
                if oid is not None:
                    for sink in sinks:
                        sink.dep_deliver(corr, oid, tpid=tp.taskpool_id)
            dcopy = copy
            if copy is not None:
                # receiver-side datatype resolution: the consumer's IN
                # dtt governs what it is handed (reference:
                # remote_dep_get_datatypes, remote_dep_mpi.c:832)
                fl = tc.flow(dflow)
                dep = fl.active_input(locs) if fl is not None else None
                dtt = as_dtt(dep.dtt) if dep is not None else None
                if dtt is not None and needs_reshape(copy, dtt):
                    dcopy = tp.reshape.get_copy(copy, dtt)
            t = deliver_dep(tp, tc, locs, dflow, dcopy, None)
            if t is not None:
                ready.append(t)
        if ready:
            scheduling.schedule(self.context.streams[0], ready)

    # ------------------------------------------------------------------
    # global quiescence: Safra's token (counterpart of termdet/fourcounter)
    # ------------------------------------------------------------------
    def _local_idle(self) -> bool:
        """Idle = no active pools AND no parked/unfinished protocol state;
        a delayed activation or pending GET is in-flight work the message
        balance alone does not capture."""
        ctx = self.context
        with self._dlock:
            if self._delayed or self._dtd_backlog:
                return False
        if self._pending_gets or self.dtd_refs_pending or \
                not self._cmdq.empty():
            return False
        if self._flushbox:
            self._drain_flush_window(force=True)
            return False
        rec = getattr(ctx, "recovery", None)
        if rec is not None and rec.busy():
            # a queued/active restart is about to rewind a pool: the
            # gang is NOT done, even if every counter reads zero right
            # now (the completed-pool-grace window)
            return False
        with ctx._lock:
            return ctx._active_taskpools == 0

    def _wait_recovery_idle(self, deadline) -> None:
        """Sole-survivor quiescence short-circuits must not outrun a
        queued recovery restart (the multi-rank rings are covered by
        the idle predicates; a lone rank has no ring to hold it)."""
        rec = getattr(self.context, "recovery", None)
        if rec is None:
            return
        while rec.busy():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"rank {self.rank}: recovery still restarting "
                    "pools at the quiescence deadline")
            time.sleep(0.01)

    def _balance(self) -> int:
        with self._term_lock:
            return self._app_sent - self._app_recv

    def _live_peers(self) -> List[int]:
        """Peers still in the gang: not declared dead.  After a
        recovery excused a death, the Safra ring and the quiescence
        collectives run over exactly these ranks."""
        dead = self.ce.dead_peers
        return [r for r in range(self.nranks)
                if r != self.rank and r not in dead]

    def recovery_coordinator(self) -> int:
        """Lowest live rank — the deterministic coordinator of every
        TAG_RECOVER round (dead-set agreement, DTD skip agreement,
        the completed-pool retirement handshake).  Every survivor
        computes the same value from its dead set, so the rounds need no
        leader election."""
        return min([self.rank] + self._live_peers())

    def _next_live(self, r: int) -> Optional[int]:
        """The ring successor of ``r`` among live ranks (self counts as
        live); None when this rank is the only survivor."""
        dead = self.ce.dead_peers
        for i in range(1, self.nranks):
            cand = (r + i) % self.nranks
            if cand == self.rank or cand not in dead:
                return cand
        return None

    def _ring_root(self) -> int:
        """The Safra initiator: the LOWEST live rank (rank 0 unless its
        death was routed around by a recovery — a survivor ring must
        still have exactly one token source)."""
        dead = self.ce.dead_peers
        for r in range(self.nranks):
            if r == self.rank or r not in dead:
                return r
        return self.rank

    # lint: on-loop (AM handler)
    def _termdet_cb(self, src: int, msg: dict) -> None:
        if src in self.ce.dead_peers:
            # a stale token/terminate of a dead (possibly recovered-
            # around) rank must not steer the survivor ring
            return
        kind = msg.get("kind")
        if kind == "terminate":
            root = self._ring_root()
            if self.rank != root:
                nxt = self._next_live(self.rank)
                if nxt is not None and nxt != root:
                    try:
                        self.ce.send_am(TAG_TERMDET, nxt,
                                        {"kind": "terminate"})
                    except OSError:
                        pass   # dead next rank; its waiters fail fast
            self._terminated.set()
            return
        if kind == "dyn_release":
            root = self._ring_root()
            if self.rank != root:
                nxt = self._next_live(self.rank)
                if nxt is not None and nxt != root:
                    try:
                        self.ce.send_am(TAG_TERMDET, nxt,
                                        {"kind": "dyn_release"})
                    except OSError:
                        pass
            self._release_dyn_holds()
            return
        # token: wait until locally idle, then forward
        threading.Thread(target=self._forward_token,
                         args=(msg, kind == "dyn_token"),
                         daemon=True).start()

    def _forward_token(self, token: dict, dyn: bool = False) -> None:
        try:
            self._forward_token_inner(token, dyn)
        except OSError:
            # the next rank in the ring died mid-forward: quiescence
            # waiters fail fast through dead_peers; don't kill the
            # daemon thread with a loose traceback
            pass

    def _forward_token_inner(self, token: dict, dyn: bool) -> None:
        idle = self._dyn_idle if dyn else self._local_idle
        done_evt = self._dyn_released if dyn else self._terminated
        kind = "dyn_token" if dyn else "token"
        while not idle():
            if done_evt.wait(0.01):
                return
        with self._term_lock:
            my_black = self._color_black
            self._color_black = False
        root = self._ring_root()
        if self.rank == root:
            # token returned home: token.balance sums the live ring's
            # other ranks; the initiator's own balance joins only HERE
            # (adding it at send time too would double-count it and
            # never reach zero)
            clean = (not token["black"]) and not my_black and \
                token["balance"] + self._balance() == 0 and \
                token["rounds"] >= 1
            nxt = self._next_live(self.rank)
            if clean:
                if nxt is not None and nxt != root:
                    self.ce.send_am(
                        TAG_TERMDET, nxt,
                        {"kind": "dyn_release" if dyn else "terminate"})
                if dyn:
                    self._release_dyn_holds()
                else:
                    self._terminated.set()
            else:
                if nxt is None or nxt == root:
                    # the ring shrank to this rank mid-round (peers
                    # died and were excused): the waiter loop's re-kick
                    # handles it — a sole survivor short-circuits in
                    # wait_quiescence/resolve_dynamic_holds instead
                    return
                self.ce.send_am(TAG_TERMDET, nxt, {
                    "kind": kind, "black": False, "balance": 0,
                    "rounds": token["rounds"] + 1})
        else:
            nxt = self._next_live(self.rank)
            if nxt is None:
                return   # sole survivor mid-round; the waiter re-kicks
            self.ce.send_am(TAG_TERMDET, nxt, {
                "kind": kind,
                "black": token["black"] or my_black,
                "balance": token["balance"] + self._balance(),
                "rounds": token["rounds"]})

    # -- dynamic-pool termination (reference: the DISTRIBUTED termdet
    # behind ptgpp --dynamic-termdet; here a pool-scoped Safra round) ----
    def register_dynamic_hold(self, tp) -> None:
        """A DynamicTaskpool took a runtime-action hold at attach; it is
        released only when resolve_dynamic_holds proves global drain."""
        with self._term_lock:
            self._dyn_holds.append(tp)

    def rearm_dynamic_hold(self, tp) -> None:
        """Recovery restart of a DynamicTaskpool: the pool keeps (or
        regains) exactly one registration, so the restarted generation
        still resolves through the pool-scoped quiescence round
        instead of stranding the hold across the restart."""
        with self._term_lock:
            if tp not in self._dyn_holds:
                self._dyn_holds.append(tp)

    def _dyn_idle(self) -> bool:
        """Locally drained MODULO the dynamic holds: every non-held pool
        done, every held pool at zero tasks with only its hold pending,
        and no parked protocol state (the Safra balance covers messages
        in flight)."""
        ctx = self.context
        with self._dlock:
            if self._delayed or self._dtd_backlog:
                return False
        if self._pending_gets or self.dtd_refs_pending or \
                not self._cmdq.empty():
            return False
        if self._flushbox:
            self._drain_flush_window(force=True)
            return False
        rec = getattr(ctx, "recovery", None)
        if rec is not None and rec.busy():
            return False   # a restart is rebuilding a held pool
        with self._term_lock:
            # a CONTAINED/cancelled dyn pool released its active-pool
            # slot but its hold entry lingers: counting it would wedge
            # the ring forever on a pool that can never drain
            holds = [tp for tp in self._dyn_holds
                     if getattr(tp, "_dyn_hold", False)
                     and not tp.cancelled and not tp.completed]
        with ctx._lock:
            if ctx._active_taskpools != len(holds):
                return False
        return all(tp.nb_tasks == 0 and tp.nb_pending_actions == 1
                   for tp in holds)

    def _release_dyn_holds(self) -> None:
        with self._term_lock:
            holds, self._dyn_holds = self._dyn_holds, []
        for tp in holds:
            if getattr(tp, "_dyn_hold", False):
                tp._dyn_hold = False
                tp.termdet.taskpool_addto_runtime_actions(tp, -1)
        self._dyn_released.set()

    def _drive_ring(self, idle_fn, done_evt, kind: str, on_done,
                    what: str, deadline: Optional[float]) -> None:
        """ONE Safra-ring driver for both quiescence flavors (the full
        context drain and the dynamic-hold round differ only in their
        idle predicate, completion event, token kind, and release
        action).  The ring root (lowest live rank — rank 0 unless its
        death was excused) launches the token once locally idle and
        RELAUNCHES it when an excused death shrinks the ring mid-round
        (the dead rank may have eaten the token; rounds restart, so a
        clean decision still needs one full white pass of the new
        ring); an UNEXCUSED death fails the waiter fast as before."""
        def kick():
            while not idle_fn():
                if done_evt.wait(0.01):
                    return
            with self._term_lock:
                self._color_black = False
            nxt = self._next_live(self.rank)
            if nxt is None or nxt == self.rank:
                on_done()
                return
            try:
                self.ce.send_am(TAG_TERMDET, nxt, {
                    "kind": kind, "black": False, "balance": 0,
                    "rounds": 0})
            except OSError:
                pass   # dead ring: the waiter below fails fast
        # kick is defined unconditionally: the mid-wait re-kick may run
        # on a rank that only became the ring root after rank 0's
        # excused death
        if self.rank == self._ring_root():
            threading.Thread(target=kick, daemon=True).start()
        seen_dead = set(self.ce.dead_peers)
        while not done_evt.wait(0.05):
            fatal = self.ce.dead_peers - self.ce.excused_peers
            if fatal:
                rec = getattr(self.context, "recovery", None)
                if rec is not None and rec.enabled:
                    # the excusal runs on the DECLARING comm thread a
                    # few instructions after the dead mark; this poll
                    # can land in that window when the GIL deschedules
                    # the declarer — give the excusal one bounded beat
                    # before calling the death fatal (recovery-off
                    # keeps the immediate containment)
                    grace = time.monotonic() + 0.5
                    while fatal and time.monotonic() < grace:
                        time.sleep(0.01)
                        fatal = self.ce.dead_peers - \
                            self.ce.excused_peers
            if fatal:
                dead = sorted(fatal)
                raise PeerFailedError(
                    dead[0], f"rank {self.rank}: {what} with dead "
                             f"peer(s) {dead}")
            if not self._live_peers():
                # sole survivor: local idle = global — once the
                # death's queued restart finished re-arming (the
                # completed-pool-grace race).  Checked EVERY iteration,
                # not only on a dead-set delta: a token sent to a peer
                # that died in the window between this ring starting
                # and seen_dead's snapshot is lost with no delta to
                # observe, and the ring would wait on it forever
                self._wait_recovery_idle(deadline)
                on_done()
                return
            if self.ce.dead_peers != seen_dead:
                seen_dead = set(self.ce.dead_peers)
                if self.rank == self._ring_root():
                    threading.Thread(target=kick, daemon=True).start()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"rank {self.rank}: {what} not reached")

    def resolve_dynamic_holds(self, timeout: Optional[float] = None) -> None:
        """Block until every rank's dynamic pools drained with no
        discovery message in flight, then release their holds everywhere
        (called by Context.wait before the completion wait).  ``None``
        waits indefinitely — Context.wait(timeout=None) must not impose
        a spurious hard deadline on distributed dynamic pools."""
        with self._term_lock:
            if not self._dyn_holds:
                return
        if self.nranks == 1 or not self._live_peers():
            # single rank, or the sole survivor of a recovered gang:
            # local drain IS global drain — once no restart is queued
            # over the held pools
            self._wait_recovery_idle(
                None if timeout is None
                else time.monotonic() + timeout)
            self._release_dyn_holds()
            self._dyn_released.clear()
            return
        self._drive_ring(
            self._dyn_idle, self._dyn_released, "dyn_token",
            self._release_dyn_holds, "dynamic-pool termination",
            None if timeout is None else time.monotonic() + timeout)
        self._dyn_released.clear()

    def wait_quiescence(self, timeout: float = 120.0) -> None:
        """Block until every rank is idle and no message is in flight
        (called by Context.wait when distributed).  Runs over the LIVE
        ring: a recovery-excused death narrows the collective to the
        survivors; an unexcused one still fails fast."""
        if self.nranks == 1 or not self._live_peers():
            # sole survivor: local idle is global idle — but a queued
            # recovery restart must finish re-arming first, or the
            # caller retires/reads pools the restore is rewinding
            self._wait_recovery_idle(time.monotonic() + timeout)
            return
        self._drive_ring(
            self._local_idle, self._terminated, "token",
            self._terminated.set, "global termination",
            time.monotonic() + timeout)
        self._terminated.clear()

    def fini(self) -> None:
        self._stop = True
        self._drain_flush_window(force=True)
        if self._progress is not None:
            self._progress.join(timeout=5)
        self.ce.fini()
