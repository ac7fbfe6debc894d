"""Comm-engine: transport-neutral active messages + one-sided emulation.

Rebuild of the reference's comm-engine seam (reference:
parsec/parsec_comm_engine.h:161-183 ``parsec_comm_engine_t`` vtable — AM
tag register/send, put/get with memory handles, progress, capabilities;
the funnelled MPI module parsec_mpi_funnelled.c is its only in-tree
implementation).  ``SocketCE`` implements the vtable over localhost TCP:
one listener per rank (port base+rank), lazily-connected peer sockets,
length-prefixed pickled frames, and one receiver thread per peer
dispatching AM callbacks — the threading stands in for the reference's
dedicated comm thread; sends are multi-threaded behind per-peer locks
(capability CE_MT in the reference's terms).

The port's copy of the JAX package's comm/engine.py.  Its deliberate
differences:

* tiles are torch tensors: ``pack`` snapshots a tensor (card or host)
  into one owned host array and carries the torch dtype's name, and
  ``unpack`` rebuilds a CPU tensor over the received buffer.  bf16, which
  numpy lacks, travels as its raw 16-bit words (no ``ml_dtypes``);
* no silent tier: the native frame path (``comm_frame_native``, default
  1) raises when commext does not build;
* left out, each with the plane that calls it: the ``TAG_FLIGHT`` dump
  handler (the flight recorder is not ported), the ``TAG_REJOIN`` /
  ``TAG_RECOVER`` lanes and the incarnation epoch (the recovery plane),
  and the comm fault directives (``kill_rank`` and the frame faults of
  utils/faultinject.py, which raises on them).  Their wire tags stay
  reserved so the tag numbering matches the JAX package's.
"""

from __future__ import annotations

import os
import pickle
import select
import selectors
import socket
import struct
import threading
import time
from collections import deque
from itertools import islice
from typing import Any, Callable, Dict, List, Optional

from parsec_tpu_torch.core.errors import PeerFailedError
from parsec_tpu_torch.utils.debug_history import mark
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose, warning

params.register("comm_port_base", 0,
                "TCP port base for the socket comm engine (0 = from env "
                "PARSEC_COMM_PORT_BASE or 23500)")
params.register("comm_hosts", "",
                "comma-separated per-rank host list for multi-host (DCN) "
                "runs — rank i listens on 0.0.0.0 and peers dial "
                "hosts[i]; empty = single-node loopback (also read from "
                "env PARSEC_COMM_HOSTS)")

# AM tag space (reference: parsec_comm_engine.h:29-38)
TAG_ACTIVATE = 1
TAG_GET_REQ = 2
TAG_GET_REP = 3
TAG_TERMDET = 4
TAG_BARRIER = 5
TAG_DTD = 6       # distributed DTD data/flush traffic
TAG_BATCH = 7     # aggregated same-destination messages [(tag, payload)...]
TAG_UTRIG = 8     # user-trigger termination declaration
TAG_PUT = 9       # one-sided put into a registered region
TAG_GET1 = 10     # one-sided get request
TAG_GET1_REP = 11
TAG_CLOCK = 12    # clock-offset ping/pong (causal-trace alignment)
TAG_HB = 13       # heartbeat (active failure detection of HUNG peers)
TAG_METRICS = 14  # telemetry pull/push (cross-rank /metrics aggregation)
# 15-17 are the JAX package's flight-recorder dump, elastic-rejoin and
# recovery lanes: reserved here, with no handler (planes not ported)
TAG_USER = 18     # first tag available to applications

#: frame header: (tag, pickle length, out-of-band buffer count).  Large
#: array payloads ride OUT OF BAND (pickle protocol 5): the pickle holds
#: only metadata while each buffer is scatter-gathered onto the socket
#: unserialized and received straight into its own bytearray — the
#: dataflow-bandwidth path does no full-payload serialization copy
_LEN = struct.Struct("!IQI")
_BUFLEN = struct.Struct("!Q")

#: wire-format guard (a malformed or cross-version frame must fail its
#: CONNECTION with a cause, not corrupt the recv thread):
#: connections handshake magic+version+rank; frames are bounded and
#: undecodable ones sever the peer
_HANDSHAKE = struct.Struct("!4sII")   # (magic, proto version, rank)
_WIRE_MAGIC = b"PTCE"
_WIRE_VERSION = 2   # v2: protocol-5 out-of-band buffer frames

params.register("comm_max_frame_mb", 4096,
                "largest acceptable frame payload in MiB; a length field "
                "beyond this is treated as stream corruption and severs "
                "the connection")


params.register("comm_sockbuf_mb", 4,
                "SO_SNDBUF/SO_RCVBUF request per peer socket in MiB "
                "(0 = system default).  Default-sized buffers make "
                "sender and receiver ping-pong on a small window; "
                "MB-class buffers let the kernel stream the frame")

params.register("comm_sockbuf_bytes", 0,
                "exact SO_SNDBUF/SO_RCVBUF request in BYTES (overrides "
                "comm_sockbuf_mb when > 0).  Test hook: a tiny send "
                "buffer forces the event-loop transport through its "
                "partial-write resume path")

params.register("comm_clock_samples", 4,
                "ping samples per clock-offset probe round; the "
                "minimum-RTT sample's midpoint estimate wins (error "
                "bounded by that sample's rtt/2 under asymmetric delay)")

params.register("comm_peer_timeout_s", 15.0,
                "declare a peer dead after this many seconds of total "
                "wire silence (heartbeats ride the control lane at "
                "timeout/3, piggybacking on the TAG_CLOCK probe "
                "machinery, so a HUNG peer — open socket, nothing "
                "flowing — is detected, not just a closed one; "
                "0 disables active detection)")

params.register("comm_transport", "evloop",
                "socket transport module: 'evloop' (single-threaded "
                "nonblocking event loop owning every peer socket — the "
                "reference's dedicated-comm-thread analog) or 'threads' "
                "(one blocking receiver thread per peer + per-peer send "
                "locks; the older path, kept for A/B attribution)")


def _bump_sockbufs(s: socket.socket) -> None:
    nbytes = int(params.get("comm_sockbuf_bytes", 0))
    if nbytes <= 0:
        mb = int(params.get("comm_sockbuf_mb", 4))
        if mb <= 0:
            return
        nbytes = mb << 20
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            s.setsockopt(socket.SOL_SOCKET, opt, nbytes)
        except OSError:
            pass    # best-effort: the kernel clamps to its limits


#: torch dtypes numpy has no counterpart of travel as raw words of the
#: same width and are re-viewed on receipt (bf16 without ml_dtypes)
_RAW_WORDS = {"bfloat16": "int16"}


def _torch_dtype_name(t) -> str:
    return str(t.dtype).rpartition(".")[2]


def clock_offset_estimate(samples):
    """Peer clock offset (``clock_peer - clock_mine``, seconds) and rtt
    from ping samples ``[(t0, t1, t2), ...]`` — t0 = ping send and t2 =
    pong arrival on OUR clock, t1 = the peer's stamp on ITS clock.  The
    minimum-RTT sample's midpoint estimate ``t1 - (t0 + t2) / 2`` wins:
    queuing delay only ever inflates rtt, so the tightest round trip is
    the closest to symmetric, and the estimate's error is bounded by
    that sample's rtt/2 even under fully asymmetric path delay (the
    NTP/Cristian bound)."""
    best = min(samples, key=lambda s: s[2] - s[0])
    t0, t1, t2 = best
    return t1 - (t0 + t2) / 2.0, t2 - t0


class CommStats:
    """Transport-level counters (both transports bump them), the wire
    side of the bench's bw/rtt protocol breakdown."""

    FIELDS = ("frames_sent", "frames_recv", "bytes_sent", "bytes_recv",
              "syscalls_send", "syscalls_recv", "partial_writes",
              "wakeups", "frames_parsed_native")

    __slots__ = FIELDS

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, 0)

    def as_dict(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in self.FIELDS}


def _dial_peer(host: str, port: int, myrank: int,
               deadline_s: float = 30.0) -> socket.socket:
    """Connect-with-retry + handshake write — the wire setup shared by
    BOTH transports (buffers sized BEFORE connect so the TCP window
    negotiates large; the peer may not be listening yet)."""
    deadline = time.monotonic() + deadline_s
    s = None
    while True:
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            _bump_sockbufs(s)
            s.settimeout(5)
            s.connect((host, port))
            s.settimeout(None)
            break
        except OSError:
            # socket() itself may have raised, leaving s unbound for
            # this iteration — a bare close() would turn the retry
            # into a NameError escaping the deadline logic
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass
            s = None
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    s.sendall(_HANDSHAKE.pack(_WIRE_MAGIC, _WIRE_VERSION, myrank))
    return s


_nat_parts = None
_nat_parts_tried = False


def _native_parts():
    """commext.frame_parts when the native frame path is on (resolved
    once per process — the A/B knob is read at the first engine).  A
    commext that does not build raises NativeBuildError, every time."""
    global _nat_parts, _nat_parts_tried
    if not _nat_parts_tried:
        from parsec_tpu_torch.comm.frames import params as _p
        if int(_p.get("comm_frame_native", 1)):
            from parsec_tpu_torch.native import load_commext
            _nat_parts = load_commext().frame_parts
        _nat_parts_tried = True
    return _nat_parts


def _frame_parts(tag: int, payload: Any) -> List[Any]:
    """Serialize one AM into its wire parts (header, pickle body, then
    per-buffer length + raw buffer).  Large array payloads ride OUT OF
    BAND (pickle protocol 5) — no full-payload serialization copy.
    The part-list assembly (every length header) is one C call when
    the native frame path is armed (commext.frame_parts)."""
    bufs: List[Any] = []
    raws: List[Any] = []
    if payload is not None:
        data = pickle.dumps(payload, protocol=5,
                            buffer_callback=bufs.append)
        try:
            raws = [pb.raw() for pb in bufs]
        except BufferError:
            # a non-contiguous exporter: fall back to in-band
            data = pickle.dumps(payload, protocol=5)
            raws = []
    else:
        data = b""
    nat = _native_parts()
    if nat is not None:
        return nat(tag, data, raws)
    parts: List[Any] = [_LEN.pack(tag, len(data), len(raws)), data]
    for raw in raws:
        parts.append(_BUFLEN.pack(raw.nbytes))
        parts.append(raw)
    return parts


class CommEngine:
    """Vtable (reference: parsec_comm_engine_t — AM tag register/send,
    registered-memory one-sided put/get, pack/unpack, progress, sync,
    capability flags parsec_comm_engine.h:161-183)."""

    #: capability flags (reference: the CE capabilities the remote-dep
    #: layer queries to pick eager vs rendezvous and threading mode)
    CAP_ONESIDED = True     # put/get over registered regions
    CAP_MT = True           # sends are thread-safe
    #: transport name recorded in stats()/bench protocol breakdowns
    TRANSPORT = "base"

    def __init__(self, rank: int, nranks: int):
        # the native frame path must build before any wire state exists
        # (no silent tier: a failed build raises NativeBuildError here)
        _native_parts()
        self.rank = rank
        self.nranks = nranks
        #: registered memory regions: id -> writable host tensor
        #: (reference: memory registration handles of ce.mem_register;
        #: guarded-by: _reg_lock)
        self._regions: Dict[int, Any] = {}
        self._region_seq = 0                        # guarded-by: _reg_lock
        self._once_regions: Dict[int, float] = {}   # guarded-by: _reg_lock
        self._reg_lock = threading.Lock()
        #: completion callbacks of outstanding one-sided ops
        #: (guarded-by: _reg_lock)
        self._osc: Dict[int, Callable] = {}
        self._osc_seq = 0                           # guarded-by: _reg_lock
        self._callbacks: Dict[int, Callable] = {}   # guarded-by: _cb_lock
        #: messages for tags nobody registered yet — replayed on register
        #: (the reference posts persistent recvs per tag at init; here a
        #: peer may send before this rank finishes wiring its handlers;
        #: guarded-by: _cb_lock)
        self._undelivered: Dict[int, List] = {}
        self._cb_lock = threading.Lock()
        # message counters (engine-level stats; the remote-dep layer keeps
        # its own application-message counters for termination detection)
        self.sent_msgs = 0
        self.recv_msgs = 0
        self.stats = CommStats()
        # flat generation-numbered barrier state (gather-to-0 + release;
        # reference: ce.sync) — shared by every transport
        self._bar_lock = threading.Lock()
        self._bar_cond = threading.Condition(self._bar_lock)
        self._bar_gen = 0                        # guarded-by: _bar_cond
        #: gen -> set of arrived SOURCE ranks (not a bare count: a
        #: rank that arrived and then died+was-excused must not satisfy
        #: the shrunk survivor quorum in its place; guarded-by: _bar_cond)
        self._bar_arrived: Dict[int, set] = {}
        self._bar_released: set = set()          # guarded-by: _bar_cond
        self._bar_aborted: set = set()           # guarded-by: _bar_cond
        # registered HERE, next to the state it serves: a transport
        # that forgot the registration would hang every barrier to its
        # timeout with nothing pointing at the cause
        self.tag_register(TAG_BARRIER, self._barrier_cb)
        #: per-peer clock alignment (causal traces): rank ->
        #: {offset (clock_peer - clock_mine, perf_counter seconds),
        #:  rtt, drift (s/s), measured_at (monotonic)} — fed by the
        #: TAG_CLOCK ping exchange, re-probed periodically by the
        #: remote-dep progress/event loop (guarded-by: _clock_lock)
        self.clock: Dict[int, Dict[str, float]] = {}
        self._clock_lock = threading.Lock()
        self._clock_pend: Dict[int, List] = {}   # guarded-by: _clock_lock
        self.tag_register(TAG_CLOCK, self._clock_cb)
        #: set by the remote-dep layer: fatal handler errors fail the rank
        #: fast instead of silently dropping the message
        self.on_error: Optional[Callable[[Exception], None]] = None
        #: set by the remote-dep layer: peer-death containment — routes a
        #: PeerFailedError to the taskpools that touch the dead rank
        #: instead of poisoning the whole context; falls back to on_error
        self.on_peer_dead: Optional[Callable[[int, Exception], None]] = None
        #: ranks whose connection died mid-run (failure detection);
        #: barrier and quiescence waiters observe this and fail fast
        self.dead_peers: set = set()
        #: dead ranks a recovery plane routed around.  The port has none
        #: (it comes with the JAX package's core/recovery.py), so this
        #: stays empty and every death fails the collectives that need
        #: the rank; the barrier and quiescence code read it as the JAX
        #: package's does
        self.excused_peers: set = set()
        #: failure detection: monotonic stamp of the last frame each peer
        #: delivered (ANY tag counts as liveness; TAG_HB only guarantees
        #: a floor of traffic on an otherwise-quiet control lane)
        self._last_heard: Dict[int, float] = {}
        self._hb_check_at = time.monotonic()
        self.tag_register(TAG_HB, self._hb_cb)
        #: telemetry plane (prof/metrics.py): a provider returns this
        #: rank's sample list for TAG_METRICS pulls; replies to OUR
        #: pulls land in _metrics_replies keyed by request id
        self.metrics_provider: Optional[Callable[[], Any]] = None
        #: every ACCEPTED clock-probe round trip feeds the frame-RTT
        #: histogram (control-lane protocol latency over time, not
        #: just the latest per-peer gauge)
        self.on_clock_rtt: Optional[Callable[[float], None]] = None
        self._metrics_cond = threading.Condition()
        self._metrics_replies: Dict[int, Dict[int, Any]] = {}  # guarded-by: _metrics_cond
        self._metrics_req = 0                    # guarded-by: _metrics_cond
        self.tag_register(TAG_METRICS, self._metrics_cb)
        #: control-plane journal (prof/journal.py): the Context's
        #: journal attaches here so barrier/death events land in it,
        #: and a provider serves cross-rank journal pulls riding the
        #: SAME TAG_METRICS req/reply machinery (zero new wire tags)
        self.journal = None
        self.journal_provider: Optional[Callable[[], Any]] = None
        #: starved-checker rebase accounting (observability of the
        #: failure detector): per-peer silence-clock rebases; written
        #: only by the single thread running check_peer_timeouts
        self.hb_rebase_total = 0
        self._hb_rebases: Dict[int, int] = {}
        #: heartbeat inter-arrival tracking (predictive health plane,
        #: prof/health.py): per-peer EWMA of TAG_HB gaps plus a
        #: mean-absolute-deviation jitter estimate.  Written only on
        #: the comm receive thread (_hb_cb); read at scrape time
        #: (hb_stats) — a degrading-but-alive peer shows up here as
        #: gap inflation long before the silence timeout fires
        self._hb_arrivals: Dict[int, Dict[str, float]] = {}

    def tag_register(self, tag: int, cb: Callable[[int, Any], None]) -> None:
        """cb(src_rank, payload) runs on the comm receive thread."""
        with self._cb_lock:
            self._callbacks[tag] = cb
            backlog = self._undelivered.pop(tag, [])
        for src, payload in backlog:
            cb(src, payload)

    def tag_unregister(self, tag: int) -> None:
        with self._cb_lock:
            self._callbacks.pop(tag, None)

    def send_am(self, tag: int, dst: int, payload: Any) -> None:
        raise NotImplementedError

    def fini(self) -> None:
        pass

    # -- collective: flat barrier, generation-numbered (gather-to-0 +
    # release; reference: ce.sync) --------------------------------------
    # lint: on-loop (AM callback: runs on the comm loop/recv thread)
    def _barrier_cb(self, src: int, payload: Any) -> None:
        kind, gen = payload
        with self._bar_cond:
            if kind == "arrive":
                self._bar_arrived.setdefault(gen, set()).add(src)
            elif kind == "abort":
                self._bar_aborted.add(gen)
            else:
                self._bar_released.add(gen)
            self._bar_cond.notify_all()

    def _bar_fatal(self) -> set:
        """Dead peers a barrier must FAIL on: excused ranks (a recovery
        routed around them — core/recovery.py) narrowed the collective
        to the survivors, every other death still aborts the round.
        Empty excused set == the pre-recovery semantics exactly."""
        return self.dead_peers - self.excused_peers

    def _bar_live(self) -> List[int]:
        """Barrier participants: every rank not EXCUSED (self included).
        A non-excused dead rank stays a participant — its absence fails
        the round exactly as before recovery existed; only a recovery's
        excusal narrows the collective.  The root is the lowest
        participant, so survivor-only barriers keep working when rank 0
        itself died and was excused."""
        return [r for r in range(self.nranks)
                if r == self.rank or r not in self.excused_peers]

    def _journal_barrier(self, gen: int, root: int, outcome: str) -> None:
        """Journal one barrier round's terminal state (the generation
        numbers are protocol state the rejoin handshake re-syncs — a
        divergent generation is exactly a black-box question)."""
        jr = self.journal
        if jr is not None:
            jr.emit("barrier", gen=gen, outcome=outcome, root=root,
                    peers=self._bar_live())

    def barrier(self, timeout: float = 60.0) -> None:
        with self._bar_cond:
            # under the lock: two app threads racing barrier() must not
            # read the same generation number (found by PCL-LOCK when
            # the guarded-by annotations landed)
            self._bar_gen += 1
            gen = self._bar_gen
        if self.nranks == 1:
            return
        live = self._bar_live()
        root = live[0]
        if len(live) == 1:
            # every peer is dead; with all of them excused this is a
            # survivor-of-one barrier (trivially met), otherwise the
            # fatal check below raises as before
            if self._bar_fatal():
                self._journal_barrier(gen, root, "dead")
                raise ConnectionError(
                    f"rank {self.rank}: barrier with dead peer(s) "
                    f"{sorted(self.dead_peers)}")
            self._journal_barrier(gen, root, "ok")
            return
        with self._bar_cond:
            # GC residue of past generations (stragglers landing after a
            # waiter gave up re-add entries nobody will consume — a
            # resident engine must not accumulate them across failed
            # rounds)
            self._bar_arrived = {g: c for g, c in self._bar_arrived.items()
                                 if g >= gen}
            self._bar_released = {g for g in self._bar_released if g >= gen}
            self._bar_aborted = {g for g in self._bar_aborted if g >= gen}
        if self.rank == root:
            # arrivals needed re-evaluate per wakeup: a participant
            # dying AND being excused mid-round shrinks the quorum
            # instead of stranding the root; an unexcused death keeps
            # the quorum unreachable so the fatal path aborts the round
            def quorum() -> int:
                return sum(1 for r in range(self.nranks)
                           if r != self.rank
                           and r not in self.excused_peers)

            def arrived() -> int:
                # live arrivals only: an arrival from a since-excused
                # rank must not stand in for a survivor still working
                return len(set(self._bar_arrived.get(gen, ()))
                           - self.excused_peers)
            with self._bar_cond:
                ok = self._bar_cond.wait_for(
                    lambda: arrived() >= quorum() or self._bar_fatal(),
                    timeout=timeout)
                failed = (self._bar_fatal() and arrived() < quorum())
                if not failed:
                    if not ok:
                        self._bar_arrived.pop(gen, None)
                        self._journal_barrier(gen, root, "timeout")
                        raise TimeoutError(
                            f"rank {self.rank}: barrier timeout")
                    self._bar_arrived.pop(gen, None)
                else:
                    # failure paths must not leak this generation (a
                    # resident service keeps the engine alive across
                    # failed barriers)
                    self._bar_arrived.pop(gen, None)
            if failed:
                # a peer died before arriving: fail the SURVIVORS fast
                # too — an abort releases their wait with the cause
                # instead of letting them ride out the full timeout
                for r in range(self.nranks):
                    if r == self.rank or r in self.dead_peers:
                        continue
                    try:
                        self.send_am(TAG_BARRIER, r, ("abort", gen))
                    except OSError:
                        pass
                self._journal_barrier(gen, root, "dead")
                raise ConnectionError(
                    f"rank {self.rank}: barrier with dead peer(s) "
                    f"{sorted(self.dead_peers)}")
            for r in range(self.nranks):
                if r == self.rank or r in self.dead_peers:
                    continue
                try:
                    self.send_am(TAG_BARRIER, r, ("release", gen))
                except OSError:
                    # a rank that arrived and then died must not strand
                    # the release of later-ranked survivors
                    warning("rank %d: barrier release to dead rank %d "
                            "skipped", self.rank, r)
            self._journal_barrier(gen, root, "ok")
        else:
            self.send_am(TAG_BARRIER, root, ("arrive", gen))
            with self._bar_cond:
                # A SIBLING that passed this barrier and exited before
                # our release arrived is orderly shutdown (final-barrier
                # race), so sibling death alone does not fail us — the
                # root aborts the round if a sibling died mid-barrier,
                # and only the root's own (unexcused) death can strand
                # our release.
                # the captured root dying fails this round FAST whether
                # or not a recovery later excuses it: an excused root
                # still sends neither release nor abort for a round it
                # entered dead — only barriers ENTERED after the
                # excusal re-elect a live root
                ok = self._bar_cond.wait_for(
                    lambda: gen in self._bar_released
                    or gen in self._bar_aborted
                    or root in self.dead_peers,
                    timeout=timeout)
                if gen not in self._bar_released and \
                        (gen in self._bar_aborted
                         or root in self.dead_peers):
                    aborted = gen in self._bar_aborted
                    self._bar_aborted.discard(gen)
                    self._journal_barrier(
                        gen, root, "abort" if aborted else "dead")
                    raise ConnectionError(
                        f"rank {self.rank}: barrier with dead peer(s) "
                        f"{sorted(self.dead_peers)}"
                        + (" (aborted by the root)" if aborted else ""))
                if not ok:
                    self._bar_released.discard(gen)
                    self._bar_aborted.discard(gen)
                    self._journal_barrier(gen, root, "timeout")
                    raise TimeoutError(
                        f"rank {self.rank}: barrier timeout "
                        f"(dead peers: {sorted(self.dead_peers) or None})")
                self._bar_released.discard(gen)
                self._bar_aborted.discard(gen)
                self._journal_barrier(gen, root, "ok")

    # -- clock alignment (causal traces): Cristian-style ping exchange --
    # lint: on-loop (periodic hook on the comm loop/progress thread)
    def probe_clocks(self, samples: Optional[int] = None) -> int:
        """Fire one offset-probe round at every live peer: ``samples``
        pings whose pongs fold into ``self.clock`` asynchronously (the
        estimator keeps the minimum-RTT sample).  TAG_CLOCK rides the
        control lane (_CTL_TAGS) so a ping measures protocol latency,
        not the bulk queue it would otherwise sit behind.  Returns the
        number of peers probed — the threaded progress loop retries
        quickly until the FIRST round actually went out."""
        if self.nranks == 1:
            return 0
        n = samples if samples is not None \
            else max(1, int(params.get("comm_clock_samples", 4)))
        probed = 0
        for r in range(self.nranks):
            if r == self.rank or r in self.dead_peers:
                continue
            probed += 1
            for _ in range(n):
                try:
                    self.send_am(TAG_CLOCK, r,
                                 {"k": "ping", "n": n,
                                  "t0": time.perf_counter()})
                except OSError:
                    break
        return probed

    # lint: on-loop (AM callback)
    def _clock_cb(self, src: int, msg: dict) -> None:
        if msg.get("k") == "ping":
            try:
                self.send_am(TAG_CLOCK, src,
                             {"k": "pong", "n": msg.get("n", 1),
                              "t0": msg["t0"],
                              "t1": time.perf_counter()})
            except OSError:
                pass
            return
        t2 = time.perf_counter()
        with self._clock_lock:
            pend = self._clock_pend.setdefault(src, [])
            pend.append((msg["t0"], msg["t1"], t2))
            if len(pend) < msg.get("n", 1):
                return
            samples, self._clock_pend[src] = list(pend), []
        self._clock_update(src, samples)

    def _clock_update(self, src: int, samples: List) -> None:
        off, rtt = clock_offset_estimate(samples)
        now = time.monotonic()
        accepted = True
        with self._clock_lock:
            st = self.clock.get(src)
            if st is None:
                self.clock[src] = {"offset": off, "rtt": rtt,
                                   "drift": 0.0, "measured_at": now}
            else:
                dt = now - st["measured_at"]
                # a round whose best rtt is much worse than what we
                # have seen is congestion, not clock motion — keep the
                # old estimate unless it has gone stale (then anything
                # beats extrapolating a minute-old offset)
                if rtt > 2.0 * st["rtt"] and dt < 60.0:
                    accepted = False
                else:
                    if dt > 1.0:
                        st["drift"] = (off - st["offset"]) / dt
                    st["offset"] = off
                    # the ACCEPTED sample's rtt, not an all-time
                    # minimum: the recorded value must bound the
                    # stored offset's error (rtt/2), and a ratcheted
                    # floor would make the congestion veto above
                    # monotonically stricter as host load rises
                    st["rtt"] = rtt
                    st["measured_at"] = now
        if not accepted:
            return
        cb = self.on_clock_rtt
        if cb is not None:
            try:
                cb(rtt)
            except Exception:   # telemetry must never hurt clock sync
                pass

    def clock_table(self) -> Dict[int, Dict[str, float]]:
        """Snapshot of the per-peer alignment state (trace headers)."""
        with self._clock_lock:
            return {r: dict(st) for r, st in self.clock.items()}

    # -- telemetry plane: TAG_METRICS pull/push -------------------------
    # lint: on-loop (AM callback: builds a snapshot — short lock holds
    # in the registry — and replies on the control lane)
    def _metrics_cb(self, src: int, msg: dict) -> None:
        if msg.get("k") in ("pull", "jpull"):
            # "pull" = telemetry snapshot, "jpull" = control-plane
            # journal snapshot; both reply with a req-correlated push
            # so one reply/wait machinery serves both
            provider = self.metrics_provider if msg["k"] == "pull" \
                else self.journal_provider
            try:
                samples = provider() if provider is not None else []
            except Exception:   # a broken provider must not kill the loop
                samples = []
            try:
                self.send_am(TAG_METRICS, src,
                             {"k": "push", "req": msg.get("req"),
                              "rank": self.rank, "samples": samples})
            except OSError:
                pass   # puller died; its gather times out
            return
        with self._metrics_cond:
            pend = self._metrics_replies.get(msg.get("req"))
            if pend is not None:
                pend[int(msg.get("rank", src))] = msg.get("samples") or []
                self._metrics_cond.notify_all()

    def _gather(self, kind: str, timeout: float) -> Dict[int, Any]:
        """One req-correlated pull round at every live peer (the shared
        machinery under gather_metrics/gather_journals).  Blocks the
        CALLER — scrape threads (service/server.py), never the comm
        loop itself."""
        targets = [r for r in range(self.nranks)
                   if r != self.rank and r not in self.dead_peers]
        if not targets:
            return {}
        with self._metrics_cond:
            self._metrics_req += 1
            req = self._metrics_req
            self._metrics_replies[req] = {}
        reached = []
        for r in targets:
            try:
                self.send_am(TAG_METRICS, r, {"k": kind, "req": req})
                reached.append(r)
            except OSError:
                pass   # died since the dead_peers check: don't wait on it
        with self._metrics_cond:
            if reached:
                self._metrics_cond.wait_for(
                    lambda: len(self._metrics_replies[req])
                    >= len(reached),
                    timeout=timeout)
            return self._metrics_replies.pop(req, {})

    def gather_metrics(self, timeout: float = 2.0) -> Dict[int, Any]:
        """Pull every live peer's telemetry snapshot over TAG_METRICS;
        returns rank -> sample list (missing ranks timed out or died)."""
        return self._gather("pull", timeout)

    def gather_journals(self, timeout: float = 2.0) -> Dict[int, Any]:
        """Pull every live peer's control-plane journal snapshot (the
        job-port ``{"op": "journal"}`` surface and the hang autopsy's
        clock-aligned tail both ride this); rank -> snapshot dict."""
        out = self._gather("jpull", timeout)
        return {r: snap for r, snap in out.items()
                if isinstance(snap, dict) and snap}

    # -- active failure detection: heartbeats + silence timeout ---------
    # lint: on-loop (AM callback)
    def _hb_cb(self, src: int, payload: Any) -> None:
        # receipt alone is the LIVENESS signal (_note_heard at the
        # framer); the arrival TIME additionally feeds the health
        # plane: per-peer inter-arrival EWMA + jitter, folded here at
        # heartbeat cadence (a handful of floats per period — nowhere
        # near the task hot path) and read by prof/health.py scrapes
        now = time.monotonic()
        st = self._hb_arrivals.get(src)
        if st is None:
            self._hb_arrivals[src] = {"at": now, "ewma": 0.0,
                                      "jit": 0.0, "n": 0.0}
            return
        gap = now - st["at"]
        st["at"] = now
        if st["n"] < 1.0:
            st["ewma"] = gap
        else:
            st["ewma"] += 0.3 * (gap - st["ewma"])
            st["jit"] += 0.3 * (abs(gap - st["ewma"]) - st["jit"])
        st["n"] += 1.0

    def hb_stats(self) -> Dict[int, Dict[str, float]]:
        """Per-peer heartbeat inter-arrival estimates for the health
        plane: smoothed gap (``ewma_s``), mean-absolute-deviation
        jitter (``jitter_s``), sample count and current silence age.
        Scrape-time accessor; the fold itself runs in _hb_cb."""
        now = time.monotonic()
        out: Dict[int, Dict[str, float]] = {}
        for r, st in list(self._hb_arrivals.items()):
            out[r] = {"ewma_s": round(st["ewma"], 6),
                      "jitter_s": round(st["jit"], 6),
                      "n": int(st["n"]),
                      "age_s": round(now - st["at"], 6)}
        return out

    def _note_heard(self, src: Optional[int]) -> None:
        if src is not None:
            self._last_heard[src] = time.monotonic()

    # lint: on-loop (periodic hook)
    def heartbeat_tick(self) -> None:
        """One heartbeat round at every live peer; rides the control
        lane so it measures protocol liveness, not bulk-queue depth.
        Driven by the remote-dep progress machinery on the TAG_CLOCK
        probe cadence (capped at comm_peer_timeout_s / 3)."""
        if self.nranks == 1:
            return
        for r in range(self.nranks):
            if r == self.rank or r in self.dead_peers:
                continue
            try:
                self._hb_send(r)
            except OSError:
                pass

    def _hb_send(self, r: int) -> None:
        """One heartbeat frame to ``r``.  Transports whose send path can
        BLOCK must override with a nonblocking discipline: the caller is
        the single progress thread that also runs check_peer_timeouts,
        and a detector wedged behind a hung peer's full send buffer (or
        a not-yet-dialed-in rank's 30s connect wait) cannot detect the
        very hang it exists to catch."""
        self.send_am(TAG_HB, r, None)

    # lint: on-loop (periodic hook)
    def check_peer_timeouts(self) -> None:
        """Declare peers silent past ``comm_peer_timeout_s`` dead — the
        detector for HUNG peers, whose sockets never close.  A starved
        checker (GIL/compile storm froze US, not them) rebases instead
        of declaring: our own silence proves nothing about theirs.

        The rebase is PER PEER: only peers
        whose last frame predates the stall window restart their
        silence clock — we were frozen for their whole silence, so it
        proves nothing.  A peer heard DURING the stall (socket recv
        threads, or the loop between stalls, kept stamping
        ``_last_heard``) keeps its real silence age, so one wedged
        SO_SNDTIMEO send no longer resets every OTHER peer's detection
        latency.  Rebases are counted per peer (``hb_rebase_total`` /
        ``hb_rebases``) so the detector's own behavior is observable
        in the metrics plane."""
        timeout = float(params.get("comm_peer_timeout_s", 15.0))
        if timeout <= 0 or self.nranks == 1:
            return
        now = time.monotonic()
        stall_start = self._hb_check_at
        starved = now - stall_start > timeout
        self._hb_check_at = now
        for r, at in list(self._last_heard.items()):
            if r in self.dead_peers:
                continue
            if starved:
                # a starved round never DECLARES — a process-wide
                # freeze (GIL/compile storm) may have parked unread
                # frames in the kernel, so every age is suspect.  But
                # only peers whose last frame predates the stall
                # restart their clock; one heard DURING the stall
                # keeps its true age, and the next healthy check —
                # one period away — declares on it if the silence is
                # real
                if at <= stall_start:
                    self._last_heard[r] = now
                    self.hb_rebase_total += 1
                    self._hb_rebases[r] = self._hb_rebases.get(r, 0) + 1
                continue
            if now - at > timeout:
                self.declare_peer_dead(r, PeerFailedError(
                    r, f"rank {self.rank}: no frames from rank {r} for "
                       f"{now - at:.1f}s (comm_peer_timeout_s="
                       f"{timeout:g})", detector="heartbeat"))

    def hb_rebases(self) -> Dict[int, int]:
        """Per-peer starved-checker rebase counts (metrics export)."""
        return dict(self._hb_rebases)

    def declare_peer_dead(self, r: int, exc: Exception) -> None:
        """Shared death path (EOF, corruption, heartbeat silence): mark,
        drop the transport state, wake barrier waiters, and route the
        failure through containment."""
        if r in self.dead_peers or self._stop_requested():
            return
        warning("rank %d: declaring rank %d dead: %s", self.rank, r, exc)
        jr = self.journal
        if jr is not None:
            jr.emit("peer_dead", peer=r,
                    detector=getattr(exc, "detector", "unknown"))
        self.dead_peers.add(r)
        self._drop_peer(r)
        with self._bar_cond:
            self._bar_cond.notify_all()
        self._peer_failure(r, exc)

    def _stop_requested(self) -> bool:
        return bool(getattr(self, "_stop", False))

    def _drop_peer(self, r: int) -> None:
        pass   # transports close the peer's socket / clear its queues

    def _peer_failure(self, r: int, exc: Exception) -> None:
        cb = self.on_peer_dead
        if cb is not None:
            try:
                cb(r, exc)
                return
            except Exception as route_exc:   # containment must not mask
                warning("rank %d: peer-death containment failed: %s",
                        self.rank, route_exc)
        if self.on_error is not None:
            self.on_error(exc)

    def peer_debug(self) -> Dict[int, Dict[str, Any]]:
        """Per-peer liveness/queue snapshot for the hang autopsy."""
        now = time.monotonic()
        out: Dict[int, Dict[str, Any]] = {}
        for r, at in list(self._last_heard.items()):   # recv threads insert
            out[r] = {"last_heard_age_s": round(now - at, 3),
                      "dead": r in self.dead_peers}
            reb = self._hb_rebases.get(r)
            if reb:
                out[r]["hb_rebases"] = reb
        for r in list(self.dead_peers):
            out.setdefault(r, {"dead": True})
        return out

    # -- pack/unpack (reference: ce.pack/unpack) ------------------------
    @staticmethod
    def pack(arr) -> dict:
        """Snapshot an array payload for the wire.  ONE owned copy here
        — the snapshot contract: the source tile may be mutated in place
        by later tasks before the comm thread serializes the frame, so
        the payload must be frozen at encode time.  The copy stays an
        ndarray and ships OUT OF BAND (pickle protocol 5 + gather-send),
        so this is the only copy on the send path (tobytes + in-band
        pickling + the join used to make three).

        A card tensor is copied down synchronously on the calling
        thread's current stream — the device module's launch stream, so
        the copy is ordered after the kernel that wrote the tile, and it
        has completed before this returns (devices/cuda.py, "Ordering").
        The wire carries the torch dtype's name; bf16 travels as its raw
        16-bit words (numpy has no bf16)."""
        import numpy as np
        import torch
        from parsec_tpu_torch.data.data import materialize
        t = materialize(arr)
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t))
        t = t.detach().to("cpu", copy=True,
                          memory_format=torch.contiguous_format)
        name = _torch_dtype_name(t)
        raw = _RAW_WORDS.get(name)
        a = (t.view(getattr(torch, raw)) if raw else t).numpy()
        return {"buf": a, "dtype": name, "shape": tuple(t.shape)}

    @staticmethod
    def unpack(msg: dict):
        """A CPU tensor over the received payload.  Out-of-band delivery
        hands an ndarray that already views the freshly received
        (private, writable) buffer, so no copy is made."""
        import numpy as np
        import torch
        buf = msg["buf"]
        name = msg["dtype"]
        raw = _RAW_WORDS.get(name)
        if isinstance(buf, np.ndarray):
            a = buf.view(raw or name)
        else:
            a = np.frombuffer(buf, dtype=raw or name).copy()
        t = torch.from_numpy(a)
        if raw:
            t = t.view(getattr(torch, name))
        return t.reshape(msg["shape"])

    # -- registered memory + one-sided put/get (reference: ce.mem_register
    # / ce.put:793 / ce.get:896 of parsec_mpi_funnelled.c — emulated over
    # two-sided AM exactly like the reference's MPI module) --------------
    def mem_register(self, array, once: bool = False) -> int:
        """Expose a writable host tensor to one-sided access (the JAX
        package's regions are numpy arrays); returns the region handle
        peers name in put/get.  ``once`` auto-unregisters after the first
        successful GET (rendezvous payloads: exactly one consumer pulls,
        then the region is gone)."""
        with self._reg_lock:
            self._region_seq += 1
            rid = self._region_seq
            self._regions[rid] = array
            if once:
                self._once_regions[rid] = time.monotonic()
        return rid

    def mem_unregister(self, rid: int) -> None:
        with self._reg_lock:
            self._regions.pop(rid, None)
            self._once_regions.pop(rid, None)

    def purge_once_regions(self, ttl: float) -> int:
        """Drop serve-once regions nobody pulled within ``ttl`` seconds
        (a consumer that died or errored out must not strand the
        producer's payload snapshot forever); returns the count purged.
        Driven by the comm-progress purge alongside the rendezvous
        handle GC."""
        now = time.monotonic()
        purged = 0
        with self._reg_lock:
            for rid, born in list(self._once_regions.items()):
                if now - born > ttl:
                    del self._once_regions[rid]
                    self._regions.pop(rid, None)
                    purged += 1
        if purged:
            warning("rank %d: dropped %d unclaimed serve-once region(s) "
                    "after %.0fs", self.rank, purged, ttl)
        return purged

    def _register_onesided(self) -> None:
        """Wire the put/get emulation tags (called by subclasses once
        transport recv is up)."""
        self.tag_register(TAG_PUT, self._put_cb)
        self.tag_register(TAG_GET1, self._get1_cb)
        self.tag_register(TAG_GET1_REP, self._get1_rep_cb)

    def put(self, dst: int, local_array, remote_rid: int,
            on_complete: Optional[Callable] = None) -> None:
        """Write ``local_array`` into peer ``dst``'s registered region;
        ``on_complete(error=None)`` runs on the comm thread once the
        remote copy landed — or failed (reference: mpi_no_thread_put)."""
        with self._reg_lock:
            self._osc_seq += 1
            op = self._osc_seq
            if on_complete is not None:
                self._osc[op] = ("put", on_complete)
        self.send_am(TAG_PUT, dst, {"rid": remote_rid, "op": op,
                                    "from": self.rank,
                                    **self.pack(local_array)})

    def get(self, dst: int, remote_rid: int,
            on_data: Callable) -> None:
        """Fetch peer ``dst``'s registered region; ``on_data(array)``
        runs on the comm thread (``None`` on failure; reference:
        mpi_no_thread_get)."""
        with self._reg_lock:
            self._osc_seq += 1
            op = self._osc_seq
            self._osc[op] = ("get", on_data)
        self.send_am(TAG_GET1, dst, {"rid": remote_rid, "op": op,
                                     "from": self.rank})

    def _osc_fail(self, dst: int, op: int, why: str) -> None:
        """An op that cannot complete still gets a terminal reply — a
        silent drop would leak the originator's callback and hang its
        waiter."""
        self.send_am(TAG_GET1_REP, dst, {"op": op, "error": why})

    # lint: on-loop (AM callback)
    def _put_cb(self, src: int, msg: dict) -> None:
        # hold the lock across the copy: concurrent put/get on one
        # region from different peer recv threads must not tear
        with self._reg_lock:
            target = self._regions.get(msg["rid"])
            if target is not None:
                try:
                    # zero-copy source view straight into the region
                    target.copy_(self.unpack(msg).reshape(target.shape))
                except (TypeError, ValueError, RuntimeError) as exc:
                    self._osc_fail(msg["from"], msg["op"], str(exc))
                    return
        if target is None:
            warning("rank %d: PUT into unknown region %s", self.rank,
                    msg["rid"])
            self._osc_fail(msg["from"], msg["op"], "unknown region")
            return
        self.send_am(TAG_GET1_REP, msg["from"],
                     {"op": msg["op"], "ack": True})

    # lint: on-loop (AM callback)
    def _get1_cb(self, src: int, msg: dict) -> None:
        with self._reg_lock:
            target = self._regions.get(msg["rid"])
            packed = self.pack(target) if target is not None else None
            if packed is not None and msg["rid"] in self._once_regions:
                del self._once_regions[msg["rid"]]
                del self._regions[msg["rid"]]
        if packed is None:
            warning("rank %d: GET of unknown region %s", self.rank,
                    msg["rid"])
            self._osc_fail(msg["from"], msg["op"], "unknown region")
            return
        self.send_am(TAG_GET1_REP, msg["from"],
                     {"op": msg["op"], **packed})

    # lint: on-loop (AM callback)
    def _get1_rep_cb(self, src: int, msg: dict) -> None:
        with self._reg_lock:
            ent = self._osc.pop(msg["op"], None)
        if ent is None:
            return
        kind, cb = ent
        err = msg.get("error")
        if err is not None:
            warning("rank %d: one-sided op %d failed at peer %d: %s",
                    self.rank, msg["op"], src, err)
        if kind == "put":
            cb(err)
        else:
            cb(None if err is not None else self.unpack(msg))

    def _dispatch(self, tag: int, src: int, payload: Any) -> None:
        mark("recv tag=%d src=%d", tag, src)
        with self._cb_lock:
            cb = self._callbacks.get(tag)
            if cb is None:
                self._undelivered.setdefault(tag, []).append((src, payload))
                return
        cb(src, payload)

    def _safe_dispatch(self, tag: int, src: int, payload: Any) -> None:
        try:
            self._dispatch(tag, src, payload)
        except Exception as exc:   # handler error must not kill the loop,
            warning("rank %d: AM handler tag=%d failed: %s",
                    self.rank, tag, exc)
            if self.on_error is not None:   # ...but must fail the rank
                self.on_error(exc)

    def _deliver_frames(self, frames, src: int, native: bool,
                        sever: Callable[[str], None],
                        alive: Callable[[], bool]) -> bool:
        """Shared delivery of parser-completed frames (the evloop and
        shm transports' one dispatch loop): stats, unpickle, dispatch.  ``sever(why)`` is the transport's
        corruption path; ``alive()`` says whether to keep dispatching
        after a handler ran (it may have torn the peer down).  Returns
        False when the caller must stop reading this peer."""
        for tag, body, oob in frames:
            self.recv_msgs += 1
            self.stats.frames_recv += 1
            if native:
                self.stats.frames_parsed_native += 1
            self._note_heard(src)
            if body is not None:
                try:
                    payload = pickle.loads(body, buffers=oob)
                except Exception as exc:
                    sever(f"undecodable frame tag={tag}: {exc}")
                    return False
            else:
                payload = None
            self._safe_dispatch(tag, src, payload)
            if not alive():
                return False
        return True


class SocketCE(CommEngine):
    """TCP active-message engine (the mpi_funnelled analog)."""

    TRANSPORT = "threads"

    def __init__(self, rank: int, nranks: int,
                 port_base: Optional[int] = None):
        super().__init__(rank, nranks)
        if port_base is None:
            port_base = int(params.get("comm_port_base", 0)) or \
                int(os.environ.get("PARSEC_COMM_PORT_BASE", 23500))
        self.port_base = port_base
        # multi-host address book (the DCN story: one rank per host, the
        # same engine; reference: the MPI module gets this from mpiexec)
        hosts = str(params.get("comm_hosts", "") or
                    os.environ.get("PARSEC_COMM_HOSTS", "")).strip()
        self._hosts = [h.strip() for h in hosts.split(",")] if hosts else []
        if self._hosts and len(self._hosts) != nranks:
            raise ValueError(
                f"comm_hosts names {len(self._hosts)} hosts for "
                f"{nranks} ranks")
        #: canonical peer sockets + per-peer send serialization; both
        #: resized by accept/connect/death paths on different threads
        #: (guarded-by: _plock)
        self._peers: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}  # guarded-by: _plock
        self._plock = threading.Lock()
        self._stop = False
        self._threads: List[threading.Thread] = []
        self._register_onesided()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # buffer size must be set BEFORE listen(): accepted sockets
        # inherit it, and the receive window is negotiated at the
        # handshake (man 7 tcp)
        _bump_sockbufs(self._listener)
        self._listener.bind(("0.0.0.0" if self._hosts else "127.0.0.1",
                             self.port_base + rank))
        self._listener.listen(nranks)
        t = threading.Thread(target=self._accept_loop,
                             name=f"ce-accept-{rank}", daemon=True)
        t.start()
        self._threads.append(t)
        # Deterministic connection direction: the HIGHER rank initiates to
        # each lower rank, eagerly at init, so a pair can never cross-
        # connect simultaneously and close each other's canonical socket.
        for dst in range(rank):
            self._connect(dst)

    # -- connection management -------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _bump_sockbufs(conn)
            self._bound_send(conn)
            # peer announces magic + protocol version + rank first: a
            # stranger or cross-version peer fails ITS connection here
            hdr = self._recv_exact(conn, _HANDSHAKE.size)
            if hdr is None:
                conn.close()
                continue
            magic, ver, src = _HANDSHAKE.unpack(hdr)
            if magic != _WIRE_MAGIC or ver != _WIRE_VERSION:
                warning("rank %d: rejected connection with bad handshake "
                        "(magic=%r version=%r)", self.rank, magic, ver)
                conn.close()
                continue
            if src in self.dead_peers:
                # no rejoin protocol (the recovery plane is not ported):
                # a dead rank's reconnection would be a half-connected
                # zombie (frames dispatched while every reply is refused
                # by the dead-peer guard)
                warning("rank %d: rejected reconnection from dead rank "
                        "%d", self.rank, src)
                conn.close()
                continue
            with self._plock:
                self._peers.setdefault(src, conn)
                self._send_locks.setdefault(src, threading.Lock())
            self._note_heard(src)
            t = threading.Thread(target=self._recv_loop, args=(conn, src),
                                 name=f"ce-recv-{self.rank}<-{src}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _connect(self, dst: int) -> socket.socket:
        with self._plock:
            s = self._peers.get(dst)
            if s is not None:
                return s
        if dst > self.rank:
            # the higher rank owns the initiation: wait for its inbound
            deadline = time.monotonic() + 30
            while True:
                with self._plock:
                    s = self._peers.get(dst)
                if s is not None:
                    return s
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"rank {self.rank}: no connection from {dst}")
                time.sleep(0.01)
        peer_host = self._hosts[dst] if self._hosts else "127.0.0.1"
        s = _dial_peer(peer_host, self.port_base + dst, self.rank)
        self._bound_send(s)
        with self._plock:
            self._peers[dst] = s
            self._send_locks.setdefault(dst, threading.Lock())
        self._note_heard(dst)
        t = threading.Thread(target=self._recv_loop, args=(s, dst),
                             name=f"ce-recv-{self.rank}<-{dst}", daemon=True)
        t.start()
        self._threads.append(t)
        return s

    # -- framing -----------------------------------------------------------
    def _bound_send(self, s: socket.socket) -> None:
        """Bound blocking sends with SO_SNDTIMEO (send-only; recv loops
        keep blocking indefinitely by design): a hung peer that stopped
        draining must not wedge the single progress thread — which also
        runs check_peer_timeouts — inside sendmsg forever.  2x the
        detection timeout: a lane that cannot drain one frame in that
        long is dead for every practical purpose."""
        pt = float(params.get("comm_peer_timeout_s", 15.0))
        if pt <= 0:
            return
        t = 2.0 * pt
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                         struct.pack("ll", int(t), int((t % 1.0) * 1e6)))
        except OSError:
            pass

    def _recv_exact(self, conn: socket.socket, n: int,
                    src: Optional[int] = None) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            self.stats.syscalls_recv += 1
            self.stats.bytes_recv += len(chunk)
            # liveness per CHUNK, not per completed frame: a frame whose
            # transmission outlasts comm_peer_timeout_s must not get its
            # actively-sending peer declared dead mid-transfer
            self._note_heard(src)
            buf += chunk
        return buf

    def _recv_into(self, conn: socket.socket, n: int,
                   src: Optional[int] = None) -> Optional[bytearray]:
        """Receive ``n`` bytes straight into one buffer (no quadratic
        bytes-concatenation; the out-of-band payload path)."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            try:
                r = conn.recv_into(view[got:], n - got)
            except OSError:
                return None
            if r == 0:
                return None
            self.stats.syscalls_recv += 1
            self.stats.bytes_recv += r
            self._note_heard(src)   # per chunk (see _recv_exact)
            got += r
        return buf

    def _recv_loop(self, conn: socket.socket, src: int) -> None:
        max_ln = int(params.get("comm_max_frame_mb", 4096)) << 20
        while not self._stop:
            hdr = self._recv_exact(conn, _LEN.size, src)
            if hdr is None:
                self._peer_lost(src)
                return
            tag, ln, nbufs = _LEN.unpack(hdr)
            if ln > max_ln or nbufs > 4096:
                # corrupt stream (or hostile length): sever THIS
                # connection with a cause instead of trying to consume
                # an absurd frame
                self._peer_corrupt(src, conn,
                                   f"frame length {ln}/{nbufs} bufs "
                                   f"exceeds the {max_ln >> 20} MiB "
                                   f"bound (tag={tag})")
                return
            data = self._recv_exact(conn, ln, src) if ln else b""
            if data is None:
                self._peer_lost(src)
                return
            oob: List[bytearray] = []
            corrupt = None
            for _ in range(nbufs):
                bhdr = self._recv_exact(conn, _BUFLEN.size, src)
                if bhdr is None:
                    self._peer_lost(src)
                    return
                (bln,) = _BUFLEN.unpack(bhdr)
                if bln > max_ln:
                    corrupt = f"oob buffer length {bln} (tag={tag})"
                    break
                buf = self._recv_into(conn, bln, src)
                if buf is None:
                    self._peer_lost(src)
                    return
                oob.append(buf)
            if corrupt is not None:
                self._peer_corrupt(src, conn, corrupt)
                return
            self.recv_msgs += 1
            self.stats.frames_recv += 1
            self._note_heard(src)
            try:
                payload = pickle.loads(data, buffers=oob) if data else None
            except Exception as exc:
                # undecodable frame = wire corruption: fail the
                # connection, not the handler path
                self._peer_corrupt(src, conn,
                                   f"undecodable frame tag={tag}: {exc}")
                return
            try:
                self._dispatch(tag, src, payload)
            except Exception as exc:   # handler error must not kill recv,
                warning("rank %d: AM handler tag=%d failed: %s",
                        self.rank, tag, exc)
                if self.on_error is not None:   # ...but must fail the rank
                    self.on_error(exc)

    def _peer_corrupt(self, src: int, conn: socket.socket,
                      why: str) -> None:
        try:
            conn.close()
        except OSError:
            pass
        self.declare_peer_dead(src, PeerFailedError(
            src, f"rank {self.rank}: protocol corruption from rank "
                 f"{src}: {why}", detector="corrupt"))

    def _peer_lost(self, src: int) -> None:
        """Failure detection: a peer's socket closed while we are still
        running (the reference has NO fault tolerance — it aborts; here
        the loss surfaces as a contained PeerFailedError AND wakes
        barrier/quiescence waiters so they fail fast with a cause
        instead of hanging to their timeouts)."""
        self.declare_peer_dead(src, PeerFailedError(
            src, f"rank {self.rank}: peer rank {src} disconnected "
                 "mid-run"))

    def _drop_peer(self, r: int) -> None:
        with self._plock:
            s = self._peers.pop(r, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def probe_clocks(self, samples: Optional[int] = None) -> int:
        # clock pings ride send_am, and send_am to an undialed higher
        # rank parks in _connect's 30s wait — which would starve the
        # progress thread that also runs the failure detectors (the
        # _hb_send lesson).  Probe ESTABLISHED peers only; a peer still
        # dialing in gets its first round once the progress loop sees
        # it established (the fast first-round retry).
        if self.nranks == 1:
            return 0
        n = samples if samples is not None \
            else max(1, int(params.get("comm_clock_samples", 4)))
        with self._plock:
            established = [r for r in self._peers
                           if r != self.rank and
                           r not in self.dead_peers]
        for r in established:
            for _ in range(n):
                try:
                    self.send_am(TAG_CLOCK, r,
                                 {"k": "ping", "n": n,
                                  "t0": time.perf_counter()})
                except OSError:
                    break
        return len(established)

    def _hb_send(self, r: int) -> None:
        # NEVER block the progress thread on a heartbeat: only beat
        # ESTABLISHED connections (send_am to an undialed higher rank
        # parks in _connect's 30s wait), skip when a send is already in
        # flight on the lane, and skip when the kernel buffer is full —
        # a hung peer that stopped draining would otherwise wedge the
        # thread that runs check_peer_timeouts behind a blocking
        # sendmsg.  A skipped beat only delays the PEER's view of us by
        # one tick; our own view of them rides _last_heard regardless.
        with self._plock:
            s = self._peers.get(r)
        lock = self._send_locks.get(r)
        if s is None or lock is None or not lock.acquire(blocking=False):
            return
        try:
            try:
                if hasattr(select, "poll"):
                    # poll has no FD_SETSIZE: select.select raises
                    # ValueError for fds >= 1024 (a resident service
                    # holds thousands) and that would kill the thread
                    po = select.poll()
                    po.register(s.fileno(), select.POLLOUT)
                    writable = bool(po.poll(0))
                else:
                    writable = bool(select.select([], [s], [], 0)[1])
            except (OSError, ValueError):
                return
            if not writable:
                return   # send buffer full: beating it would block
            self.sent_msgs += 1
            self.stats.frames_sent += 1
            self._sendmsg_all(s, _frame_parts(TAG_HB, None))
        finally:
            lock.release()

    def send_am(self, tag: int, dst: int, payload: Any = None) -> None:
        mark("send_am tag=%d dst=%d", tag, dst)
        if dst == self.rank:
            # local delivery short-circuit (counts as a message so the
            # termination balance stays symmetric)
            self.sent_msgs += 1
            self.recv_msgs += 1
            self._dispatch(tag, self.rank, payload)
            return
        if dst in self.dead_peers:
            # the closed socket used to raise OSError from sendmsg; now
            # that death drops the peer entry, raise the same class
            # rather than re-dialing a corpse for 30s
            raise OSError(f"peer rank {dst} is dead")
        parts = _frame_parts(tag, payload)
        s = self._connect(dst)
        with self._send_locks[dst]:
            self.sent_msgs += 1
            self.stats.frames_sent += 1
            try:
                self._sendmsg_all(s, parts)
            except (socket.timeout, BlockingIOError):
                # SO_SNDTIMEO fired (_bound_send): the peer stopped
                # draining for 2x comm_peer_timeout_s and the frame is
                # torn mid-stream — fail the lane like an EOF so the
                # progress thread (which also runs the hung-peer
                # detector) is never wedged inside sendmsg
                try:
                    s.close()
                except OSError:
                    pass
                self._peer_lost(dst)
                raise OSError(
                    f"rank {self.rank}: send to rank {dst} timed out "
                    "(peer not draining)")

    def _sendmsg_all(self, s: socket.socket, parts: List[Any]) -> None:
        """Gather-send every part (scatter-gather keeps large array
        buffers out of any join copy); loops on partial sends."""
        views = [memoryview(p) for p in parts if len(p)]
        while views:
            sent = s.sendmsg(views)
            self.stats.syscalls_send += 1
            self.stats.bytes_sent += sent
            while sent and views:
                head = views[0]
                if sent >= head.nbytes:
                    sent -= head.nbytes
                    views.pop(0)
                else:
                    views[0] = head[sent:]
                    sent = 0

    def fini(self) -> None:
        self._stop = True
        try:
            # close() alone leaves the port LISTENING while the accept
            # thread is blocked in accept() (the kernel socket ref is
            # held by the syscall): shutdown() wakes it so the port is
            # actually released before fini returns
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._plock:
            for s in self._peers.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._peers.clear()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=1)
        debug_verbose(5, "rank %d CE down: sent=%d recv=%d",
                      self.rank, self.sent_msgs, self.recv_msgs)


# ---------------------------------------------------------------------------
# event-loop transport (the single-threaded comm engine)
# ---------------------------------------------------------------------------

#: control-plane tags jump the per-peer output queue ahead of bulk data
#: frames (a termination token or GET request must not wait behind a
#: multi-MB payload drain); a partially-written frame is never preempted
_CTL_TAGS = frozenset((TAG_TERMDET, TAG_BARRIER, TAG_GET_REQ, TAG_UTRIG,
                       TAG_CLOCK, TAG_HB, TAG_METRICS))

#: receive state machine stages
_ST_HS, _ST_HDR, _ST_BODY, _ST_BLEN, _ST_BUF = range(5)

_IOV_CAP = 64          # views gathered per sendmsg (Linux IOV_MAX=1024)
_RECV_BUDGET = 4 << 20  # bytes drained per readable event before yielding
_EWMA = 0.2            # feedback smoothing for the adaptive protocol


class _EvPeer:
    """Per-connection state of the event loop: an incremental receive
    parser (frames assemble across partial reads, large payloads
    ``recv_into`` their own preallocated buffer directly) plus
    priority-ordered output queues with partial-write resume."""

    __slots__ = (
        "rank", "sock", "born", "registered",
        # receive state machine
        "r_stage", "r_want", "r_got", "r_view", "r_buf", "r_small",
        "r_tag", "r_ln", "r_nbufs", "r_body", "r_oob",
        # native frame parser (comm/frames.py make_parser): when set,
        # the receive path feeds it instead of the inline machinery
        "fparser", "fp_native",
        # send side: queued frames -> wire-committed views -> kernel
        "q_ctl", "q_bulk", "wire", "marks", "out_bytes", "want_write",
        # adaptive-protocol feedback (updated as frames drain)
        "delay_ewma", "rate_ewma",
    )

    def __init__(self, rank: Optional[int], sock: Optional[socket.socket]):
        self.rank = rank
        self.sock = sock
        self.born = time.monotonic()
        self.registered = False
        self.r_small = bytearray(_LEN.size)
        self.r_stage = _ST_HDR
        self.r_want = _LEN.size
        self.r_got = 0
        self.r_view = memoryview(self.r_small)
        self.r_buf: Optional[bytearray] = None
        self.r_tag = self.r_ln = self.r_nbufs = 0
        self.r_body: Any = b""
        self.r_oob: List[bytearray] = []
        self.fparser = None
        self.fp_native = False
        self.q_ctl: deque = deque()
        self.q_bulk: deque = deque()
        self.wire: deque = deque()   # memoryviews committed to wire order
        self.marks: deque = deque()  # [bytes_left, t_enq, total] per frame
        self.out_bytes = 0
        self.want_write = False
        self.delay_ewma: Optional[float] = None
        self.rate_ewma: Optional[float] = None


class EventLoopCE(CommEngine):
    """Single-threaded nonblocking event-loop transport: ONE comm thread
    owns accept, recv, AND send for every peer socket through a
    ``selectors`` loop — the reference's dedicated-comm-thread model
    (parsec_remote_dep.c progress thread making nonblocking MPI progress
    over all peers) rebuilt over TCP.  A 2-rank exchange on one core
    costs zero cross-thread wakeups on the data path: the AM callback
    runs on the loop thread, and a handler's reply frames go straight to
    ``sendmsg`` from the same stack.

    Cross-thread sends (workers flushing activations, user code) ride a
    lock-free command ring (``collections.deque``) with one self-pipe
    wakeup, written only when the loop is parked in ``select``.  Sends
    become per-peer priority-ordered output queues drained on EPOLLOUT
    with vectored ``sendmsg`` gather writes (many small frames coalesce
    into one syscall) and explicit backpressure: a partial write parks
    the remaining views in per-peer resume state and registers write
    interest instead of spinning.

    The remote-dep layer detects ``FUNNELLED`` and folds its progress
    loop in here (no separate progress thread, no per-peer recv
    threads); ``post``/``add_periodic`` are its hooks.
    """

    FUNNELLED = True   # callbacks + sends are funnelled onto ONE thread
    CAP_MT = True      # send_am remains thread-safe (via the ring)
    TRANSPORT = "evloop"

    def __init__(self, rank: int, nranks: int,
                 port_base: Optional[int] = None):
        super().__init__(rank, nranks)
        if port_base is None:
            port_base = int(params.get("comm_port_base", 0)) or \
                int(os.environ.get("PARSEC_COMM_PORT_BASE", 23500))
        self.port_base = port_base
        hosts = str(params.get("comm_hosts", "") or
                    os.environ.get("PARSEC_COMM_HOSTS", "")).strip()
        self._hosts = [h.strip() for h in hosts.split(",")] if hosts else []
        if self._hosts and len(self._hosts) != nranks:
            raise ValueError(
                f"comm_hosts names {len(self._hosts)} hosts for "
                f"{nranks} ranks")
        self._max_frame = int(params.get("comm_max_frame_mb", 4096)) << 20
        self._peers: Dict[int, _EvPeer] = {}
        self._anon: set = set()          # accepted, handshake pending
        self._stop = False
        self._sel = selectors.DefaultSelector()
        self._ring: deque = deque()
        self._sleeping = False
        rfd, wfd = os.pipe()
        os.set_blocking(rfd, False)
        os.set_blocking(wfd, False)
        self._wake_r, self._wake_w = rfd, wfd
        self._scratch = bytearray(256 << 10)
        self._scratch_mv = memoryview(self._scratch)
        self._timers: List[list] = []
        self._register_onesided()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        _bump_sockbufs(self._listener)
        self._listener.bind(("0.0.0.0" if self._hosts else "127.0.0.1",
                             self.port_base + rank))
        self._listener.listen(nranks)
        self._listener.setblocking(False)
        self._sel.register(self._listener, selectors.EVENT_READ,
                           ("accept", None))
        self._sel.register(rfd, selectors.EVENT_READ, ("wake", None))
        self._thread = threading.Thread(target=self._loop,
                                        name=f"ce-loop-{rank}", daemon=True)
        self._thread.start()
        # Deterministic connection direction (same as the threaded
        # transport): the HIGHER rank initiates to each lower rank at
        # init; a send to a not-yet-dialed-in higher rank just queues.
        self._post(("timer", self._check_unconnected, 5.0))
        try:
            for dst in range(rank):
                self._dial(dst)
        except OSError:
            # a failed dial must not abandon a half-built engine: the
            # loop thread, selector, pipe fds, and the bound listener
            # would leak (and block a rebind of this port)
            self.fini()
            raise

    # -- public loop hooks (the remote-dep layer's progress seam) -------
    def post(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the loop thread (the reference's
        dep_cmd_queue analog)."""
        self._post(("call", fn, args))

    def add_periodic(self, fn: Callable[[], None], period: float) -> None:
        """Run ``fn()`` on the loop thread every ``period`` seconds
        (handle GC, flush windows)."""
        self._post(("timer", fn, float(period)))

    def peer_feedback(self, dst: int) -> Optional[Dict[str, Any]]:
        """Adaptive-protocol feedback: queued bytes not yet on the wire,
        EWMA of frame queue->wire latency, EWMA drain rate (bytes/s)."""
        peer = self._peers.get(dst)
        if peer is None:
            return None
        return {"out_bytes": peer.out_bytes,
                "delay_ewma": peer.delay_ewma,
                "rate_ewma": peer.rate_ewma}

    def peer_debug(self) -> Dict[int, Dict[str, Any]]:
        out = super().peer_debug()
        for r, peer in list(self._peers.items()):
            ent = out.setdefault(r, {})
            ent["out_bytes"] = peer.out_bytes
            ent["connected"] = peer.sock is not None
        return out

    # -- command ring ----------------------------------------------------
    def _post(self, cmd: tuple) -> None:
        self._ring.append(cmd)
        if self._sleeping and self._wake_w >= 0:
            try:
                os.write(self._wake_w, b"\0")
                self.stats.wakeups += 1
            except (BlockingIOError, OSError):
                pass   # pipe full = wakeups already pending

    def _drain_ring(self) -> None:
        ring = self._ring
        while ring:
            try:
                cmd = ring.popleft()
            except IndexError:
                return
            op = cmd[0]
            try:
                if op == "send":
                    self._send_now(cmd[1], cmd[2], cmd[3])
                elif op == "call":
                    cmd[1](*cmd[2])
                elif op == "local":
                    self.recv_msgs += 1
                    self._safe_dispatch(cmd[1], self.rank, cmd[2])
                elif op == "adopt":
                    self._adopt(cmd[1], cmd[2])
                elif op == "timer":
                    self._timers.append(
                        [time.monotonic() + cmd[2], cmd[2], cmd[1]])
                elif op == "stop":
                    self._stop = True
            except Exception as exc:
                self._handler_error(exc)

    def _handler_error(self, exc: Exception) -> None:
        warning("rank %d: comm-loop command failed: %s", self.rank, exc)
        if self.on_error is not None:
            self.on_error(exc)

    # -- the loop --------------------------------------------------------
    def _loop(self) -> None:
        sel = self._sel
        while not self._stop:
            self._drain_ring()
            if self._stop:
                break
            self._run_timers()
            self._sleeping = True
            if self._ring:
                self._sleeping = False
                continue
            try:
                events = sel.select(self._next_timeout())
            except OSError:
                self._sleeping = False
                continue
            self._sleeping = False
            for key, mask in events:
                kind, peer = key.data
                try:
                    if kind == "accept":
                        self._on_accept()
                    elif kind == "wake":
                        try:
                            os.read(self._wake_r, 4096)
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        if mask & selectors.EVENT_WRITE and \
                                peer.sock is not None:
                            self._flush(peer)
                        if mask & selectors.EVENT_READ and \
                                peer.sock is not None:
                            self._on_read(peer)
                except Exception as exc:   # the loop must survive
                    self._handler_error(exc)
        self._shutdown_drain()

    def _shutdown_drain(self, deadline: float = 5.0) -> None:
        """Orderly shutdown ships what is already queued (a barrier
        release posted just before the stop flag flipped must reach the
        peers — the threaded transport sent it synchronously), bounded
        so dead peers cannot hang teardown."""
        end = time.monotonic() + deadline
        while time.monotonic() < end:
            self._drain_ring()
            pending = [p for p in self._peers.values()
                       if p.sock is not None and
                       (p.wire or p.q_ctl or p.q_bulk)]
            if not pending and not self._ring:
                return
            for p in pending:
                self._flush(p)
            # post-stop bounded drain: the loop is already exiting and
            # nothing else runs on this thread
            time.sleep(0.002)   # lint: allow-blocking (teardown drain)

    def _next_timeout(self) -> float:
        if not self._timers:
            return 0.5
        now = time.monotonic()
        due = min(t[0] for t in self._timers) - now
        return min(0.5, max(0.0, due))

    def _run_timers(self) -> None:
        if not self._timers:
            return
        now = time.monotonic()
        for t in self._timers:
            if now >= t[0]:
                t[0] = now + t[1]
                try:
                    t[2]()
                except Exception as exc:
                    self._handler_error(exc)

    def _check_unconnected(self) -> None:
        """A peer with queued frames that never dialed in is a failure,
        not a silent stall (the threaded transport's 30s connect
        deadline, ported to the nonblocking world)."""
        now = time.monotonic()
        for rank, peer in list(self._peers.items()):
            if peer.sock is None and peer.out_bytes and \
                    now - peer.born > 30 and rank not in self.dead_peers:
                self._clear_peer_queues(peer)
                # the shared death sequence (mark, wake barrier
                # waiters, containment route) — one path per detector
                self.declare_peer_dead(rank, PeerFailedError(
                    rank, f"rank {self.rank}: no connection from rank "
                          f"{rank} after 30s (frames queued)",
                    detector="connect"))

    # -- connection management ------------------------------------------
    def _dial(self, dst: int) -> None:   # lint: off-loop (init thread)
        """Blocking connect + handshake (init thread), then hand the
        socket to the loop."""
        peer_host = self._hosts[dst] if self._hosts else "127.0.0.1"
        s = _dial_peer(peer_host, self.port_base + dst, self.rank)
        s.setblocking(False)
        self._post(("adopt", s, dst))

    def _attach_parser(self, peer: _EvPeer) -> None:
        """Arm the native frame parser for a post-handshake stream
        (comm_frame_native); None keeps the inline Python machinery —
        which IS the A/B fallback path here."""
        from parsec_tpu_torch.comm.frames import make_parser
        peer.fparser, peer.fp_native = make_parser(self._max_frame)

    def _adopt(self, sock: socket.socket, rank: int) -> None:
        peer = self._peers.get(rank)
        if peer is not None and peer.sock is None:
            peer.sock = sock       # frames queued before connect: keep
            peer.born = time.monotonic()
        else:
            peer = _EvPeer(rank, sock)
            self._peers[rank] = peer
        # outbound stream: WE sent the handshake, the peer's bytes are
        # frames from the first one — parse natively when available
        self._attach_parser(peer)
        self._sel.register(sock, selectors.EVENT_READ, ("peer", peer))
        peer.registered = True
        self._note_heard(rank)
        self._flush(peer)

    def _on_accept(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _bump_sockbufs(conn)
            conn.setblocking(False)
            peer = _EvPeer(None, conn)
            peer.r_stage = _ST_HS
            peer.r_want = _HANDSHAKE.size
            peer.r_got = 0
            peer.r_buf = None
            peer.r_view = memoryview(peer.r_small)
            self._anon.add(peer)
            self._sel.register(conn, selectors.EVENT_READ, ("peer", peer))
            peer.registered = True

    def _close_peer(self, peer: _EvPeer) -> None:
        sock = peer.sock
        peer.sock = None
        self._anon.discard(peer)
        if sock is not None:
            if peer.registered:
                try:
                    self._sel.unregister(sock)
                except (KeyError, ValueError, OSError):
                    pass
                peer.registered = False
            try:
                sock.close()
            except OSError:
                pass

    @staticmethod
    def _clear_peer_queues(peer: _EvPeer) -> None:
        # frames can never reach a dead peer: drop them (and stop
        # accumulating — _send_now discards for dead ranks), else a
        # resident service leaks every later token/activation to it
        peer.q_ctl.clear()
        peer.q_bulk.clear()
        peer.wire.clear()
        peer.marks.clear()
        peer.out_bytes = 0

    def _peer_down(self, peer: _EvPeer, cause: Optional[str],
                   detector: str = "close") -> None:
        """Failure detection: the connection fails WITH its cause — the
        engine contract.  Local transport teardown happens here; the
        shared death sequence (mark, wake barrier waiters, containment
        route) is declare_peer_dead's — ONE path for every detector."""
        self._close_peer(peer)
        self._clear_peer_queues(peer)
        src = peer.rank
        if src is None:
            return   # a stranger that never handshook has no identity
        self.declare_peer_dead(src, PeerFailedError(
            src, f"rank {self.rank}: peer rank {src} disconnected mid-run"
            + (f": {cause}" if cause else ""), detector=detector))

    def _sever(self, peer: _EvPeer, why: str) -> None:
        warning("rank %d: protocol corruption from rank %s: %s",
                self.rank, peer.rank, why)
        self._peer_down(peer, why, detector="corrupt")

    def _drop_peer(self, r: int) -> None:
        """Close a declared-dead peer's transport state (declare_peer_dead
        contract); hops onto the loop thread when called off it."""
        if threading.current_thread() is not self._thread:
            self._post(("call", self._drop_peer, (r,)))
            return
        peer = self._peers.get(r)
        if peer is not None:
            self._close_peer(peer)
            self._clear_peer_queues(peer)

    # -- send path -------------------------------------------------------
    def send_am(self, tag: int, dst: int, payload: Any = None) -> None:
        mark("send_am tag=%d dst=%d", tag, dst)
        if dst == self.rank:
            # local delivery short-circuit (counts as a message so the
            # termination balance stays symmetric); same posted-FIFO
            # rule as the remote branch below
            self.sent_msgs += 1
            if threading.current_thread() is self._thread and \
                    not self._ring:
                self.recv_msgs += 1
                self._dispatch(tag, self.rank, payload)
            else:
                self._post(("local", tag, payload))
            return
        if threading.current_thread() is self._thread:
            # per-destination FIFO across threads: a loop-thread send
            # (handler reply) must not overtake worker sends already
            # POSTED but not yet drained — the DTD lane protocol owes
            # its total write-chain order to this
            if self._ring:
                self._ring.append(("send", tag, dst, payload))
            else:
                self._send_now(tag, dst, payload)
        else:
            self._post(("send", tag, dst, payload))

    def _send_now(self, tag: int, dst: int, payload: Any) -> None:
        if dst in self.dead_peers:
            return        # undeliverable; the loss already surfaced
        peer = self._peers.get(dst)
        if peer is None:
            # not yet dialed in (higher-rank peer owns the initiation):
            # frames queue on a placeholder and flush at adoption
            peer = self._peers[dst] = _EvPeer(dst, None)
        self.sent_msgs += 1
        self.stats.frames_sent += 1
        self._enqueue(peer, tag, payload)
        if peer.sock is not None:
            self._flush(peer)

    def _enqueue(self, peer: _EvPeer, tag: int, payload: Any) -> None:
        parts = _frame_parts(tag, payload)
        views = [memoryview(p) for p in parts if len(p)]
        nbytes = sum(v.nbytes for v in views)
        q = peer.q_ctl if tag in _CTL_TAGS else peer.q_bulk
        q.append((time.monotonic(), nbytes, views))
        peer.out_bytes += nbytes

    def _flush(self, peer: _EvPeer) -> None:
        sock = peer.sock
        if sock is None:
            return
        stats = self.stats
        while True:
            # commit queued frames to wire order (control first; a
            # partially-sent frame is never preempted)
            while len(peer.wire) < _IOV_CAP and (peer.q_ctl or peer.q_bulk):
                t_enq, nb, views = (peer.q_ctl.popleft() if peer.q_ctl
                                    else peer.q_bulk.popleft())
                peer.wire.extend(views)
                peer.marks.append([nb, t_enq, nb])
            if not peer.wire:
                self._set_write(peer, False)
                return
            iov = list(islice(peer.wire, _IOV_CAP))
            try:
                sent = sock.sendmsg(iov)
            except (BlockingIOError, InterruptedError):
                stats.partial_writes += 1
                self._set_write(peer, True)
                return
            except OSError as exc:
                self._peer_down(peer, f"send failed: {exc}")
                return
            stats.syscalls_send += 1
            stats.bytes_sent += sent
            peer.out_bytes -= sent
            short = sent < sum(v.nbytes for v in iov)
            self._consume(peer, sent)
            if short:
                # kernel send buffer full mid-frame: park the resume
                # state, drain the rest on EPOLLOUT (backpressure)
                stats.partial_writes += 1
                self._set_write(peer, True)
                return

    def _consume(self, peer: _EvPeer, sent: int) -> None:
        wire = peer.wire
        while sent:
            head = wire[0]
            if sent >= head.nbytes:
                sent -= head.nbytes
                self._mark_drained(peer, head.nbytes)
                wire.popleft()
            else:
                wire[0] = head[sent:]
                self._mark_drained(peer, sent)
                sent = 0

    @staticmethod
    def _mark_drained(peer: _EvPeer, n: int) -> None:
        marks = peer.marks
        while n and marks:
            m = marks[0]
            take = n if n < m[0] else m[0]
            m[0] -= take
            n -= take
            if m[0] == 0:
                marks.popleft()
                dt = time.monotonic() - m[1]
                # feedback for the adaptive eager protocol: observed
                # frame queue->wire latency and drain rate
                if dt > 0:
                    rate = m[2] / dt
                    peer.rate_ewma = rate if peer.rate_ewma is None \
                        else (1 - _EWMA) * peer.rate_ewma + _EWMA * rate
                peer.delay_ewma = dt if peer.delay_ewma is None \
                    else (1 - _EWMA) * peer.delay_ewma + _EWMA * dt

    def _set_write(self, peer: _EvPeer, want: bool) -> None:
        if peer.want_write == want or peer.sock is None:
            return
        peer.want_write = want
        ev = selectors.EVENT_READ | \
            (selectors.EVENT_WRITE if want else 0)
        try:
            self._sel.modify(peer.sock, ev, ("peer", peer))
        except (KeyError, ValueError, OSError):
            pass

    # -- receive path ----------------------------------------------------
    def _on_read(self, peer: _EvPeer) -> None:
        if peer.fparser is not None:
            self._on_read_native(peer)
            return
        budget = _RECV_BUDGET
        scratch = self._scratch
        smv = self._scratch_mv
        stats = self.stats
        while budget > 0 and peer.sock is not None:
            rem = peer.r_want - peer.r_got
            if peer.r_buf is not None and rem >= len(scratch):
                # bulk stage: receive straight into the frame's own
                # preallocated buffer (zero-copy out-of-band path)
                want = rem if rem < budget else budget
                try:
                    n = peer.sock.recv_into(
                        peer.r_view[peer.r_got:peer.r_got + want])
                except (BlockingIOError, InterruptedError):
                    return
                except OSError as exc:
                    self._peer_down(peer, f"recv failed: {exc}")
                    return
                if n == 0:
                    self._eof(peer)
                    return
                stats.syscalls_recv += 1
                stats.bytes_recv += n
                # liveness per chunk, not per completed frame: a bulk
                # frame outlasting comm_peer_timeout_s on the wire must
                # not get its actively-sending peer declared dead
                self._note_heard(peer.rank)
                peer.r_got += n
                budget -= n
                if peer.r_got == peer.r_want and not self._advance(peer):
                    return
                if n < want:
                    return        # socket drained
            else:
                # buffered stage: one read, then carve every complete
                # small frame out of it (frames/syscall coalescing)
                try:
                    n = peer.sock.recv_into(scratch)
                except (BlockingIOError, InterruptedError):
                    return
                except OSError as exc:
                    self._peer_down(peer, f"recv failed: {exc}")
                    return
                if n == 0:
                    self._eof(peer)
                    return
                stats.syscalls_recv += 1
                stats.bytes_recv += n
                self._note_heard(peer.rank)   # per chunk (see above)
                budget -= n
                if not self._feed(peer, smv[:n]):
                    return
                if n < len(scratch):
                    return        # socket drained

    def _on_read_native(self, peer: _EvPeer) -> None:
        """Receive path over the native frame parser: the per-frame
        state machine runs in ONE C crossing per read (commext.c), and
        an in-progress large payload is recv_into'd straight into the
        parser's own buffer — the zero-copy out-of-band path."""
        budget = _RECV_BUDGET
        scratch = self._scratch
        smv = self._scratch_mv
        stats = self.stats
        fp = peer.fparser
        while budget > 0 and peer.sock is not None:
            tgt = fp.bulk_target()
            want = len(tgt) if tgt is not None else len(scratch)
            try:
                n = peer.sock.recv_into(tgt if tgt is not None
                                        else scratch)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self._peer_down(peer, f"recv failed: {exc}")
                return
            if n == 0:
                self._eof(peer)
                return
            stats.syscalls_recv += 1
            stats.bytes_recv += n
            # liveness per chunk, not per completed frame (see the
            # fallback path's rationale)
            self._note_heard(peer.rank)
            budget -= n
            try:
                frames = fp.bulk_commit(n) if tgt is not None \
                    else fp.feed(smv[:n])
            except ValueError as exc:
                self._sever(peer, str(exc))
                return
            if frames and not self._dispatch_frames(peer, frames):
                return
            if n < want:
                return        # socket drained

    def _dispatch_frames(self, peer: _EvPeer, frames) -> bool:
        """Deliver parser-completed frames; False = stop reading this
        peer (severed / handed off by a handler)."""
        return self._deliver_frames(
            frames, peer.rank, peer.fp_native,
            lambda why: self._sever(peer, why),
            lambda: peer.sock is not None)

    def _feed(self, peer: _EvPeer, mv: memoryview) -> bool:
        while len(mv):
            if peer.fparser is not None:
                # the handshake completed inside this read and armed
                # the parser: the remaining bytes are frame stream
                try:
                    frames = peer.fparser.feed(mv)
                except ValueError as exc:
                    self._sever(peer, str(exc))
                    return False
                return self._dispatch_frames(peer, frames) if frames \
                    else peer.sock is not None
            take = peer.r_want - peer.r_got
            if take > len(mv):
                take = len(mv)
            peer.r_view[peer.r_got:peer.r_got + take] = mv[:take]
            peer.r_got += take
            mv = mv[take:]
            if peer.r_got == peer.r_want and not self._advance(peer):
                return False
        return True

    def _expect_hdr(self, peer: _EvPeer) -> None:
        peer.r_stage = _ST_HDR
        peer.r_want = _LEN.size
        peer.r_got = 0
        peer.r_buf = None
        peer.r_view = memoryview(peer.r_small)

    def _advance(self, peer: _EvPeer) -> bool:
        """One receive stage filled; returns False when the peer was
        severed or the socket handed off (stop reading it)."""
        st = peer.r_stage
        if st == _ST_HS:
            magic, ver, src = _HANDSHAKE.unpack_from(peer.r_small)
            if magic != _WIRE_MAGIC or ver != _WIRE_VERSION:
                warning("rank %d: rejected connection with bad handshake "
                        "(magic=%r version=%r)", self.rank, magic, ver)
                self._close_peer(peer)
                return False
            peer.rank = src
            if src in self.dead_peers:
                # no rejoin protocol (the recovery plane is not ported):
                # accepting a dead rank would create a half-connected
                # zombie (its frames dispatched and Safra-counted while
                # _send_now drops every reply)
                warning("rank %d: rejected reconnection from dead rank "
                        "%d", self.rank, src)
                self._close_peer(peer)
                return False
            existing = self._peers.get(src)
            if existing is not None and existing is not peer:
                if existing.sock is None:
                    # frames queued before the peer dialed in: adopt
                    peer.q_ctl.extend(existing.q_ctl)
                    peer.q_bulk.extend(existing.q_bulk)
                    peer.out_bytes += existing.out_bytes
                else:
                    warning("rank %d: duplicate connection from rank %d "
                            "rejected", self.rank, src)
                    self._close_peer(peer)
                    return False
            self._peers[src] = peer
            self._anon.discard(peer)
            self._note_heard(src)
            self._expect_hdr(peer)
            # handshake done: the rest of the stream is frames — hand
            # it to the native parser (any bytes that followed the
            # handshake in this same read are routed by _feed)
            self._attach_parser(peer)
            self._flush(peer)
            return peer.sock is not None
        if st == _ST_HDR:
            tag, ln, nbufs = _LEN.unpack_from(peer.r_small)
            if ln > self._max_frame or nbufs > 4096:
                self._sever(peer, f"frame length {ln}/{nbufs} bufs "
                                  f"exceeds the {self._max_frame >> 20} "
                                  f"MiB bound (tag={tag})")
                return False
            peer.r_tag, peer.r_ln, peer.r_nbufs = tag, ln, nbufs
            peer.r_body = b""
            peer.r_oob = []
            if ln:
                buf = bytearray(ln)
                peer.r_buf = buf
                peer.r_view = memoryview(buf)
                peer.r_stage = _ST_BODY
                peer.r_want = ln
                peer.r_got = 0
                return True
            return self._next_buf(peer)
        if st == _ST_BODY:
            peer.r_body = peer.r_buf
            return self._next_buf(peer)
        if st == _ST_BLEN:
            (bln,) = _BUFLEN.unpack_from(peer.r_small)
            if bln > self._max_frame:
                self._sever(peer, f"oob buffer length {bln} "
                                  f"(tag={peer.r_tag})")
                return False
            if bln == 0:
                peer.r_oob.append(bytearray(0))
                return self._next_buf(peer)
            buf = bytearray(bln)
            peer.r_buf = buf
            peer.r_view = memoryview(buf)
            peer.r_stage = _ST_BUF
            peer.r_want = bln
            peer.r_got = 0
            return True
        if st == _ST_BUF:
            peer.r_oob.append(peer.r_buf)
            return self._next_buf(peer)
        return True

    def _next_buf(self, peer: _EvPeer) -> bool:
        if len(peer.r_oob) < peer.r_nbufs:
            peer.r_stage = _ST_BLEN
            peer.r_want = _BUFLEN.size
            peer.r_got = 0
            peer.r_buf = None
            peer.r_view = memoryview(peer.r_small)
            return True
        return self._frame_done(peer)

    def _frame_done(self, peer: _EvPeer) -> bool:
        self.recv_msgs += 1
        self.stats.frames_recv += 1
        self._note_heard(peer.rank)
        tag = peer.r_tag
        body, oob = peer.r_body, peer.r_oob
        src = peer.rank
        self._expect_hdr(peer)   # reset BEFORE dispatch (handlers send)
        if body:
            try:
                payload = pickle.loads(body, buffers=oob)
            except Exception as exc:
                self._sever(peer, f"undecodable frame tag={tag}: {exc}")
                return False
        else:
            payload = None
        self._safe_dispatch(tag, src, payload)
        return peer.sock is not None

    def _eof(self, peer: _EvPeer) -> None:
        if peer.fparser is not None:
            if peer.fparser.idle():
                self._peer_down(peer, None)  # closed between frames
            else:
                self._peer_down(peer, "peer died mid-frame")
            return
        if peer.r_stage == _ST_HDR and peer.r_got == 0:
            self._peer_down(peer, None)      # closed between frames
        elif peer.r_stage == _ST_HS:
            self._close_peer(peer)           # stranger never handshook
        else:
            self._peer_down(
                peer, f"peer died mid-frame (stage={peer.r_stage}, "
                      f"{peer.r_got}/{peer.r_want} bytes of tag="
                      f"{peer.r_tag})")

    # -- teardown --------------------------------------------------------
    def fini(self) -> None:
        self._stop = True
        self._post(("stop",))
        wake_w = self._wake_w
        if wake_w >= 0:
            try:
                os.write(wake_w, b"\0")
            except OSError:
                pass
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5)
        try:
            self._listener.close()
        except OSError:
            pass
        for peer in list(self._peers.values()) + list(self._anon):
            sock = peer.sock
            peer.sock = None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        try:
            self._sel.close()
        except (OSError, RuntimeError):
            pass
        # invalidate BEFORE closing: a second fini must not write to or
        # close a recycled fd number belonging to someone else
        fds = (self._wake_r, self._wake_w)
        self._wake_r = self._wake_w = -1
        for fd in fds:
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
        debug_verbose(5, "rank %d CE down: sent=%d recv=%d %s",
                      self.rank, self.sent_msgs, self.recv_msgs,
                      self.stats.as_dict())


def make_ce(rank: int, nranks: int,
            port_base: Optional[int] = None) -> CommEngine:
    """Transport factory: ``comm_transport`` MCA knob (env
    ``PARSEC_MCA_COMM_TRANSPORT``) selects ``evloop`` (default),
    ``threads`` (the pre-event-loop path kept selectable for A/B
    attribution), or ``shm`` (same-host mmap ring pairs, comm/shm.py;
    multi-host address books fall back to evloop with a warning)."""
    transport = str(params.get("comm_transport", "evloop")
                    or "evloop").lower()
    if transport in ("threads", "thread", "socketce"):
        return SocketCE(rank, nranks, port_base)
    if transport in ("shm", "sharedmem", "ring"):
        hosts = str(params.get("comm_hosts", "") or
                    os.environ.get("PARSEC_COMM_HOSTS", "")).strip()
        if hosts:
            warning("comm_transport=shm is same-host only but "
                    "comm_hosts is set: using evloop")
        else:
            from parsec_tpu_torch.comm.shm import ShmCE
            return ShmCE(rank, nranks, port_base)
    elif transport not in ("evloop", "eventloop", "select"):
        warning("unknown comm_transport %r: using evloop", transport)
    return EventLoopCE(rank, nranks, port_base)
