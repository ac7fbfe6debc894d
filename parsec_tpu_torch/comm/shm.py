"""Shared-memory ring transport: same-host ranks over mmap SPSC rings.

The third ``make_ce`` transport (``PARSEC_MCA_COMM_TRANSPORT=shm``):
every directed peer pair owns one mmap-backed single-producer/
single-consumer byte ring under /dev/shm, carrying EXACTLY the frame
stream the TCP transports put on the wire (comm/frames.py parses it),
so the whole AM/one-sided/barrier/clock/heartbeat protocol stack rides
unchanged — a loopback-TCP hop pays two kernel socket copies plus
syscalls per chunk; the ring pays one userspace memcpy in and one out,
with ZERO syscalls on the data path.  Doorbells are abstract-namespace
unix datagrams, suppressed by a consumer-side ``waiting`` flag so a
busy consumer costs the producer nothing.

Topology/ownership: the RECEIVER creates (and at fini unlinks) its
inbound rings; senders attach lazily with a bounded retry, and a peer
whose ring never appears within 30s fails structurally
(``detector="connect"``).  The engine is FUNNELLED like EventLoopCE —
one loop thread owns every ring drain, AM dispatch, and send; worker
sends ride a command ring + self-doorbell.  The full failure-detection
contract holds: ``closed`` flag = EOF (hard kill / orderly shutdown),
heartbeat silence = hung peer, parser bound violation = corruption —
all routed through the shared ``declare_peer_dead`` sequence.

Index discipline: ``tail`` (producer) and ``head`` (consumer) are
monotonically increasing u64 byte counts at fixed 8-aligned offsets;
each is written by exactly ONE process and read by the other (aligned
8-byte copies — single stores on every supported platform).  The
``waiting``/``closed`` u32 flags are single-writer the same way.

The port's copy of the JAX package's comm/shm.py.  Its deliberate
differences:

* the indices are read and written through a native ``Q`` view of the
  header, one 8-byte copy each: the JAX package's ``struct.pack_into``/
  ``unpack_from`` move them a byte at a time, so the other process can
  read a torn index (a card run's producer computed negative free space,
  which a torn head explains, and tore a 75 MB frame); a free space
  outside [0, capacity] now fails the write with its cause;
* parsed frames are dispatched from a per-peer queue (``_drain_one``);
* a ring's file is allocated in full when it is created
  (``posix_fallocate``), so a ``/dev/shm`` too small for it raises with
  the path and the size instead of a SIGBUS at the first write past the
  free space.  A re-created inbound ring (elastic rejoin, below) is
  allocated the same way, and its peer's dispatch queue is emptied with
  the torn stream;
* a write stalled on a full ring returns when its own drain of the
  inbound rings declared the peer dead (the JAX package's loop goes on
  reading the indices of the ring that death closed).
"""

from __future__ import annotations

import mmap
import os
import select
import socket
import struct
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from parsec_tpu_torch.comm.engine import TAG_HB, CommEngine, _frame_parts
from parsec_tpu_torch.comm.frames import make_parser
from parsec_tpu_torch.core.errors import PeerFailedError
from parsec_tpu_torch.utils.debug_history import mark
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose, warning

params.register("comm_shm_ring_mb", 8,
                "per-directed-peer-pair shared-memory ring capacity in "
                "MiB (shm transport); frames larger than the ring "
                "stream through it in chunks as the consumer drains")
params.register("comm_shm_dir", "",
                "directory for the shm transport's ring files (empty = "
                "/dev/shm when present, else the system tempdir)")

_MAGIC = 0x50534852            # "PSHR"
_VERSION = 1
_HDR = 64                      # data starts here
_OFF_MAGIC, _OFF_VER, _OFF_CAP = 0, 4, 8
_OFF_TAIL, _OFF_HEAD = 16, 24
_OFF_CLOSED, _OFF_WAITING = 32, 36
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _ring_dir() -> str:
    d = str(params.get("comm_shm_dir", "") or "")
    if d:
        return d
    return "/dev/shm" if os.path.isdir("/dev/shm") else \
        tempfile.gettempdir()


def _ring_path(base: int, src: int, dst: int) -> str:
    return os.path.join(_ring_dir(),
                        f"parsec-shm-{base}-{src}to{dst}.ring")


class _Ring:
    """One mapped directed ring.  ``owner=True`` (the receiver side)
    creates/initializes the file and unlinks it at close."""

    __slots__ = ("path", "owner", "fd", "mm", "cap", "mask", "data",
                 "idx")

    def __init__(self, path: str, owner: bool, cap: int):
        self.path = path
        self.owner = owner
        if owner:
            try:
                os.unlink(path)    # stale file from a crashed run
            except OSError:
                pass
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                # allocate every page now: a sparse file on a full tmpfs
                # would SIGBUS the first write past the free space
                os.posix_fallocate(fd, 0, _HDR + cap)
            except OSError as exc:
                os.close(fd)
                os.unlink(path)
                raise OSError(
                    exc.errno, f"shm ring {path}: cannot allocate "
                    f"{_HDR + cap} bytes ({exc.strerror}); lower "
                    "comm_shm_ring_mb or point comm_shm_dir at a larger "
                    "filesystem") from exc
            self.fd = fd
            self.mm = mmap.mmap(fd, _HDR + cap)
            self.idx = memoryview(self.mm)[:_HDR].cast("Q")
            self.cap = cap
            # header: indices/flags first, MAGIC last — an attaching
            # sender accepts the ring only once it is fully initialized
            _U64.pack_into(self.mm, _OFF_CAP, cap)
            self.idx[_OFF_TAIL // 8] = 0
            self.idx[_OFF_HEAD // 8] = 0
            _U32.pack_into(self.mm, _OFF_CLOSED, 0)
            _U32.pack_into(self.mm, _OFF_WAITING, 0)
            _U32.pack_into(self.mm, _OFF_VER, _VERSION)
            _U32.pack_into(self.mm, _OFF_MAGIC, _MAGIC)
        else:
            fd = os.open(path, os.O_RDWR)
            size = os.fstat(fd).st_size
            if size <= _HDR:
                # the owner has created the file but not sized it yet
                # (posix_fallocate takes a while): not ready, retried
                os.close(fd)
                raise OSError(f"{path}: ring not initialized yet")
            self.fd = fd
            self.mm = mmap.mmap(fd, size)
            self.idx = memoryview(self.mm)[:_HDR].cast("Q")
            magic = _U32.unpack_from(self.mm, _OFF_MAGIC)[0]
            ver = _U32.unpack_from(self.mm, _OFF_VER)[0]
            if magic != _MAGIC or ver != _VERSION:
                self.close()
                raise OSError(f"{path}: bad ring magic/version "
                              f"({magic:#x}/{ver})")
            self.cap = _U64.unpack_from(self.mm, _OFF_CAP)[0]
            if _HDR + self.cap != size:
                self.close()
                raise OSError(f"{path}: ring size mismatch")
        self.mask = self.cap - 1
        self.data = memoryview(self.mm)[_HDR:]

    # single-writer fields (see the module docstring's discipline): one
    # aligned 8-byte copy each way through the native view, never a
    # byte-wise struct copy the other process could read half-written
    def tail(self) -> int:
        return self.idx[_OFF_TAIL // 8]

    def set_tail(self, v: int) -> None:
        self.idx[_OFF_TAIL // 8] = v

    def head(self) -> int:
        return self.idx[_OFF_HEAD // 8]

    def set_head(self, v: int) -> None:
        self.idx[_OFF_HEAD // 8] = v

    def closed(self) -> bool:
        return bool(_U32.unpack_from(self.mm, _OFF_CLOSED)[0])

    def set_closed(self) -> None:
        _U32.pack_into(self.mm, _OFF_CLOSED, 1)

    def waiting(self) -> bool:
        return bool(_U32.unpack_from(self.mm, _OFF_WAITING)[0])

    def set_waiting(self, v: int) -> None:
        _U32.pack_into(self.mm, _OFF_WAITING, v)

    def close(self) -> None:
        try:
            for view in ("data", "idx"):
                if getattr(self, view, None) is not None:
                    getattr(self, view).release()
                    setattr(self, view, None)
            self.mm.close()
        except (BufferError, ValueError, OSError):
            pass
        try:
            os.close(self.fd)
        except OSError:
            pass
        if self.owner:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class _ShmPeer:
    """Per-peer transport state, loop-thread-owned."""

    __slots__ = ("rank", "inbound", "outbound", "parser", "fp_native",
                 "pending", "pending_bytes", "born", "addr", "inq",
                 "dispatching")

    def __init__(self, rank: int):
        self.rank = rank
        self.inbound: Optional[_Ring] = None    # peer -> us (we own)
        self.outbound: Optional[_Ring] = None   # us -> peer (attached)
        self.parser = None
        self.fp_native = False
        #: frames queued before the outbound ring attached
        self.pending: deque = deque()
        self.pending_bytes = 0
        self.born = time.monotonic()
        self.addr: Optional[bytes] = None       # doorbell sockaddr
        #: parsed frames awaiting dispatch, in stream order, and whether
        #: a dispatch loop of this peer is on the stack (_drain_one)
        self.inq: deque = deque()
        self.dispatching = False


class ShmCE(CommEngine):
    """Shared-memory ring active-message engine (same-host ranks)."""

    FUNNELLED = True   # callbacks + sends funnelled onto ONE thread
    CAP_MT = True      # send_am remains thread-safe (via the ring)
    TRANSPORT = "shm"

    def __init__(self, rank: int, nranks: int,
                 port_base: Optional[int] = None):
        super().__init__(rank, nranks)
        if port_base is None:
            port_base = int(params.get("comm_port_base", 0)) or \
                int(os.environ.get("PARSEC_COMM_PORT_BASE", 23500))
        self.port_base = port_base
        self._max_frame = int(params.get("comm_max_frame_mb", 4096)) << 20
        cap = max(64 << 10,
                  int(params.get("comm_shm_ring_mb", 8)) << 20)
        # power-of-two capacity (mask arithmetic)
        self._cap = 1 << (cap - 1).bit_length()
        self._stop = False
        self._ring: deque = deque()      # command ring (cross-thread)
        self._sleeping = False
        self._timers: List[list] = []
        #: re-entrancy latch: the ring-full stall path drains OUR
        #: inbound rings (deadlock breaker), and a handler dispatched
        #: there may SEND — a nested write would interleave bytes into
        #: the frame being written and rewind the published tail, so
        #: sends made while a write is in progress queue on the
        #: command ring instead (drained right after the write)
        self._writing = False
        #: stall deadline basis, cached off the per-frame path (the
        #: MCA registry get is a lock round-trip)
        pt = float(params.get("comm_peer_timeout_s", 15.0))
        self._stall_timeout = 2.0 * pt if pt > 0 else 3600.0
        # shm-specific counters (extra_stats; loop-thread-written,
        # scrape reads are tear-tolerant ints)
        self.ring_full_stalls = 0
        self.doorbells_sent = 0
        self.doorbells_recv = 0
        # doorbell: abstract-namespace unix datagram socket per rank —
        # the cross-process self-pipe (no filesystem residue)
        self._door = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._door.bind(self._door_addr(rank))
        self._door.setblocking(False)
        # a dedicated nonblocking sender socket (sendto from any
        # thread via _post's wake; loop-thread doorbells to peers)
        self._door_tx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._door_tx.setblocking(False)
        # poll, not select.select: a resident service holds thousands
        # of fds and select dies (ValueError) at fd >= 1024
        self._poll = select.poll()
        self._poll.register(self._door.fileno(), select.POLLIN)
        #: rank -> _ShmPeer; created at init and mutated only on
        #: the loop thread thereafter (funnelled discipline — the
        #: ring indices inside each _Ring are single-writer per
        #: side, see the module docstring)
        self._peers: Dict[int, _ShmPeer] = {}
        try:
            for r in range(nranks):
                if r == rank:
                    continue
                peer = _ShmPeer(r)
                peer.addr = self._door_addr(r)
                # our inbound ring (peer -> us): we own and initialize it
                peer.inbound = _Ring(_ring_path(port_base, r, rank),
                                     owner=True, cap=self._cap)
                self._peers[r] = peer
                peer.parser, peer.fp_native = make_parser(self._max_frame,
                                                          require=True)
        except Exception:
            # a ring that cannot be made must not abandon a half-built
            # engine: the rings made so far and the doorbell sockets
            # would leak (and block a rebind of this base)
            for peer in self._peers.values():
                peer.inbound.close()
            self._door.close()
            self._door_tx.close()
            raise
        self._register_onesided()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"ce-shm-{rank}",
                                        daemon=True)
        self._thread.start()
        self._post(("timer", self._check_unattached, 5.0))
        # frames parked before a peer's ring appeared flush from a fast
        # retry tick, not from the NEXT send (a barrier 'arrive' may be
        # the only frame this rank ever sends the peer)
        self._post(("timer", self._retry_pending, 0.02))
        # rejoin support: a restarted incarnation re-creates its ring
        # files — stale outbound mappings must drop so sends re-attach
        self._post(("timer", self._verify_outbound, 1.0))
        self._arm_kill()

    def _door_addr(self, r: int) -> bytes:
        # leading NUL = Linux abstract namespace
        return b"\0parsec-shm-%d-%d" % (self.port_base, r)

    # -- public loop hooks (the remote-dep layer's progress seam) -------
    def post(self, fn: Callable, *args) -> None:
        self._post(("call", fn, args))

    def add_periodic(self, fn: Callable[[], None], period: float) -> None:
        self._post(("timer", fn, float(period)))

    def extra_stats(self) -> Dict[str, int]:
        return {"shm_ring_full_stalls": self.ring_full_stalls,
                "shm_doorbells_sent": self.doorbells_sent,
                "shm_doorbells_recv": self.doorbells_recv}

    def peer_debug(self) -> Dict[int, Dict[str, Any]]:
        out = super().peer_debug()
        for r, peer in list(self._peers.items()):
            ent = out.setdefault(r, {})
            ent["attached"] = peer.outbound is not None
            ent["pending_bytes"] = peer.pending_bytes
            ob = peer.outbound
            if ob is not None:
                ent["out_bytes"] = ob.tail() - ob.head()
        return out

    # -- command ring ----------------------------------------------------
    def _post(self, cmd: tuple) -> None:
        self._ring.append(cmd)
        if self._sleeping:
            try:
                self._door_tx.sendto(b"\0", self._door_addr(self.rank))
                self.stats.wakeups += 1
            except (BlockingIOError, OSError):
                pass   # socket gone at teardown / buffer full = pending

    # lint: on-loop (command drain on the shm loop thread)
    def _drain_cmds(self) -> None:
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
                elif op == "timer":
                    self._timers.append(
                        [time.monotonic() + cmd[2], cmd[2], cmd[1]])
                elif op == "stop":
                    self._stop = True
            except Exception as exc:
                self._handler_error(exc)

    def _handler_error(self, exc: Exception) -> None:
        warning("rank %d: shm-loop command failed: %s", self.rank, exc)
        if self.on_error is not None:
            self.on_error(exc)

    # -- the loop --------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop:
            self._drain_cmds()
            if self._stop:
                break
            self._run_timers()
            progressed = self._drain_rings() if not self._muted else False
            if progressed or self._ring:
                continue
            # pre-sleep protocol: raise the waiting flags, then re-check
            # — a producer that wrote after our drain but before the
            # flag went up sees waiting=0 and skips the doorbell, so the
            # re-check below must (and does) observe its bytes
            for peer in self._peers.values():
                rg = peer.inbound
                if rg is not None:
                    rg.set_waiting(1)
            # count only rings a drain would actually consume: a muted
            # engine or a dead peer's residual bytes stay in the ring
            # forever and must not turn the loop into a busy-spin
            dirty = not self._muted and any(
                p.inbound is not None and
                (p.rank not in self.dead_peers or self.rejoin_allowed)
                and p.inbound.tail() != p.inbound.head()
                for p in self._peers.values())
            if dirty or self._ring:
                for peer in self._peers.values():
                    if peer.inbound is not None:
                        peer.inbound.set_waiting(0)
                continue
            self._sleeping = True
            if self._ring:
                self._sleeping = False
                continue
            try:
                r = self._poll.poll(self._next_timeout() * 1e3)
            except OSError:
                r = []
            self._sleeping = False
            for peer in self._peers.values():
                if peer.inbound is not None:
                    peer.inbound.set_waiting(0)
            if r:
                try:
                    while True:
                        self._door.recvfrom(64)
                        self.doorbells_recv += 1
                except (BlockingIOError, OSError):
                    pass
        self._shutdown_drain()

    def _next_timeout(self) -> float:
        if not self._timers:
            return 0.2
        due = min(t[0] for t in self._timers) - time.monotonic()
        return min(0.2, max(0.0, due))

    # lint: on-loop (periodic driver)
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

    # lint: on-loop (periodic hook)
    def _retry_pending(self) -> None:
        for r, peer in list(self._peers.items()):
            if peer.pending and peer.outbound is None and \
                    r not in self.dead_peers:
                self._attach(peer)

    def _drop_stale_outbound(self, peer: _ShmPeer) -> None:
        """Rejoin freshness: a restarted incarnation re-created its
        inbound ring files, so an outbound mapping whose inode no
        longer matches the on-disk path is a write-only hole into the
        dead incarnation's anonymous inode — drop it and let the next
        send re-attach to the fresh ring."""
        rg = peer.outbound
        if rg is None:
            return
        try:
            fresh = os.stat(rg.path).st_ino == os.fstat(rg.fd).st_ino
        except OSError:
            fresh = False
        if not fresh:
            rg.close()              # owner=False: never unlinks
            peer.outbound = None

    # lint: on-loop (periodic hook)
    def _verify_outbound(self) -> None:
        """One inode stat per attached peer per tick, armed only when
        rejoin is enabled."""
        if not self.rejoin_allowed:
            return
        for peer in list(self._peers.values()):
            self._drop_stale_outbound(peer)

    # lint: on-loop (periodic hook)
    def _check_unattached(self) -> None:
        """A peer with queued frames whose inbound ring never appeared
        is a failure, not a silent stall (the TCP transports' 30s
        connect deadline)."""
        now = time.monotonic()
        for r, peer in list(self._peers.items()):
            if peer.outbound is None and peer.pending and \
                    now - peer.born > 30 and r not in self.dead_peers:
                peer.pending.clear()
                peer.pending_bytes = 0
                self.declare_peer_dead(r, PeerFailedError(
                    r, f"rank {self.rank}: rank {r}'s inbound ring "
                       "never appeared within 30s (frames queued)",
                    detector="connect"))

    # -- receive path ----------------------------------------------------
    # lint: on-loop (doorbell/ring drain handler)
    def _drain_rings(self) -> bool:
        progressed = False
        rejoinable = self.rejoin_allowed
        for peer in list(self._peers.values()):
            if peer.rank in self.dead_peers and not rejoinable:
                # with rejoin armed, a dead peer's ring was re-created
                # EMPTY at _drop_peer: draining it costs nothing until
                # a restarted incarnation writes its TAG_REJOIN frame
                continue
            rg = peer.inbound
            if rg is None:
                continue
            if self._drain_one(peer, rg):
                progressed = True
        return progressed

    def _drain_one(self, peer: _ShmPeer, rg: _Ring) -> bool:
        """Parse what the ring holds and dispatch it in stream order.

        Deliberate difference from the JAX package: a handler's send that
        stalls on a full ring drains the inbound rings (the deadlock
        breaker) — this one included, from inside its own dispatch.  The
        JAX package's outer loop then resumes from its stale ``head``
        and feeds the parser bytes it already parsed (duplicate frames,
        then a corrupt stream).  Here a nested drain only parses (freeing
        ring space) and queues its frames on ``peer.inq``; the dispatch
        loop already on the stack delivers them in order, and the outer
        loop re-reads the indices after every dispatch."""
        head = rg.head()
        tail = rg.tail()
        if tail == head:
            if rg.closed() and not peer.inq:
                # EOF only once every frame before it was delivered (a
                # nested drain may leave some queued for the outer loop)
                self._ring_eof(peer)
            return False
        progressed = False
        mask, data = rg.mask, rg.data
        while tail != head:
            off = head & mask
            chunk = min(tail - head, rg.cap - off)
            try:
                frames = peer.parser.feed(data[off:off + chunk])
            except ValueError as exc:
                self.declare_peer_dead(peer.rank, PeerFailedError(
                    peer.rank, f"rank {self.rank}: protocol corruption "
                    f"from rank {peer.rank}: {exc}", detector="corrupt"))
                return True
            head += chunk
            rg.set_head(head)       # free space per chunk: the
            self.stats.bytes_recv += chunk   # producer unblocks ASAP
            # liveness per chunk, not per completed frame (a bulk
            # frame outlasting comm_peer_timeout_s must not get its
            # actively-streaming peer declared dead)
            self._note_heard(peer.rank)
            progressed = True
            peer.inq.extend(frames)
            if not peer.dispatching and not self._dispatch_queued(peer):
                return True
            head = rg.head()    # a nested drain may have moved on
            tail = rg.tail()
        return progressed

    def _dispatch_queued(self, peer: _ShmPeer) -> bool:
        """Deliver ``peer``'s queued frames one by one, in order; frames a
        handler's nested drain queues meanwhile are delivered by this
        same loop.  False = stop reading this peer."""
        peer.dispatching = True
        try:
            while peer.inq:
                if not self._dispatch_frames(peer, [peer.inq.popleft()]):
                    peer.inq.clear()
                    return False
        finally:
            peer.dispatching = False
        return True

    def _dispatch_frames(self, peer: _ShmPeer, frames) -> bool:
        src = peer.rank
        return self._deliver_frames(
            frames, src, peer.fp_native,
            lambda why: self.declare_peer_dead(src, PeerFailedError(
                src, f"rank {self.rank}: protocol corruption from "
                f"rank {src}: {why}", detector="corrupt")),
            lambda: src not in self.dead_peers)

    def peer_rejoined(self, r: int, epoch: int) -> None:
        """TAG_REJOIN validated: beyond the base bookkeeping, make sure
        our outbound path re-attaches to the RESTARTED incarnation's
        ring (the _drop_peer at death usually closed it already; this
        covers an attach that raced the restart)."""
        super().peer_rejoined(r, epoch)

        def fresh():
            peer = self._peers.get(r)
            if peer is not None:
                self._drop_stale_outbound(peer)
        self.post(fresh)

    def _deliver_held(self, tag: int, src: int, payload: Any) -> None:
        # funnelled contract: handlers run ONLY on the loop thread
        self._post(("call", self._safe_dispatch, (tag, src, payload)))

    def _ring_eof(self, peer: _ShmPeer) -> None:
        """The producer set ``closed`` and every byte drained: EOF.
        Orderly shutdown is filtered by declare_peer_dead's _stop
        check, exactly like a TCP close."""
        if peer.rank in self.dead_peers:
            return
        if peer.parser is not None and not peer.parser.idle():
            why = f"rank {peer.rank} closed its ring mid-frame"
        else:
            why = None
        self.declare_peer_dead(peer.rank, PeerFailedError(
            peer.rank, f"rank {self.rank}: peer rank {peer.rank} "
            "closed its ring mid-run" + (f": {why}" if why else "")))

    # -- send path -------------------------------------------------------
    def send_am(self, tag: int, dst: int, payload: Any = None,
                _nofault: bool = False) -> None:
        mark("send_am tag=%d dst=%d", tag, dst)
        if self._muted and dst != self.rank:
            return   # injected silent hang swallows every outbound frame
        if self._fault is not None and not _nofault and dst != self.rank \
                and self._fault_frame(tag, dst, payload):
            return
        if dst == self.rank:
            self.sent_msgs += 1
            if threading.current_thread() is self._thread and \
                    not self._ring:
                self.recv_msgs += 1
                self._dispatch(tag, self.rank, payload)
            else:
                self._post(("local", tag, payload))
            return
        if threading.current_thread() is self._thread:
            # per-destination FIFO across threads (the evloop rule):
            # a loop-thread send must not overtake posted worker sends
            if self._ring:
                self._ring.append(("send", tag, dst, payload))
            else:
                self._send_now(tag, dst, payload)
        else:
            self._post(("send", tag, dst, payload))

    def _send_now(self, tag: int, dst: int, payload: Any) -> None:
        if self._writing:
            # nested send from a handler dispatched inside a stall's
            # drain: queue behind the in-progress write (FIFO holds —
            # the outer frame is earlier in program order)
            self._ring.append(("send", tag, dst, payload))
            return
        if dst in self.dead_peers:
            return        # undeliverable; the loss already surfaced
        peer = self._peers.get(dst)
        if peer is None:
            raise OSError(f"rank {self.rank}: no shm peer {dst}")
        parts = _frame_parts(tag, payload)
        views = [memoryview(p) for p in parts if len(p)]
        if peer.outbound is None and not self._attach(peer):
            # ring not up yet: park the frame; flushed at attach,
            # failed by _check_unattached past the deadline
            nbytes = sum(v.nbytes for v in views)
            peer.pending.append(views)
            peer.pending_bytes += nbytes
            return
        self._write_views(peer, views)

    def _send_raw_parts(self, dst: int, parts: List[Any]) -> None:
        views = [memoryview(p) for p in parts if len(p)]

        def doit():
            peer = self._peers.get(dst)
            if peer is not None and dst not in self.dead_peers:
                self._write_views(peer, views, count_frame=False)
        self.post(doit)

    def _attach(self, peer: _ShmPeer) -> bool:
        path = _ring_path(self.port_base, self.rank, peer.rank)
        try:
            peer.outbound = _Ring(path, owner=False, cap=0)
        except OSError:
            return False
        # flush frames parked while the peer was coming up
        while peer.pending:
            self._write_views(peer, peer.pending.popleft())
        peer.pending_bytes = 0
        return True

    def _write_views(self, peer: _ShmPeer, views: List,
                     count_frame: bool = True) -> None:
        """Producer side: copy the frame's parts into the outbound
        ring, streaming through it when the frame exceeds free space.
        A full ring means the consumer is behind: doorbell it, keep
        draining OUR inbound (two mutually-full rings must not
        deadlock), and give up through the shared death path after 2x
        the peer-timeout."""
        rg = peer.outbound
        if rg is None:
            return
        if count_frame:
            self.sent_msgs += 1
            self.stats.frames_sent += 1
        # re-entrancy latch: any send a stall-drained handler makes
        # queues on the command ring (_send_now) instead of writing —
        # a nested write would interleave bytes into THIS frame's
        # stream and rewind the published tail (frame loss)
        self._writing = True
        try:
            self._write_views_inner(peer, rg, views)
        finally:
            self._writing = False

    def _write_views_inner(self, peer: _ShmPeer, rg: _Ring,
                           views: List) -> None:
        deadline = None    # computed only if a stall actually happens
        mask, cap, data = rg.mask, rg.cap, rg.data
        tail = rg.tail()
        total = 0
        stall_ns = 5e-5
        for v in views:
            voff = 0
            n = v.nbytes
            while voff < n:
                free = cap - (tail - rg.head())
                if not 0 <= free <= cap:
                    raise RuntimeError(
                        f"rank {self.rank}: ring to rank {peer.rank} reads "
                        f"head {rg.head()} against tail {tail} (capacity "
                        f"{cap}): the ring indices are inconsistent")
                if free == 0:
                    self.ring_full_stalls += 1
                    self._doorbell(peer)
                    if rg.closed() or peer.rank in self.dead_peers:
                        return
                    # service our own inbound while waiting (deadlock
                    # breaker when both directions are full; nested
                    # sends from handlers park on the command ring)
                    if threading.current_thread() is self._thread:
                        self._drain_rings()
                        if peer.outbound is not rg:
                            # the drain met the peer's end of stream and
                            # declared it dead, which closed this ring:
                            # the frame is undeliverable, as to any dead
                            # peer
                            return
                    now = time.monotonic()
                    if deadline is None:
                        deadline = now + self._stall_timeout
                    if now > deadline:
                        self.declare_peer_dead(peer.rank, PeerFailedError(
                            peer.rank, f"rank {self.rank}: rank "
                            f"{peer.rank} stopped draining its ring "
                            f"for {self._stall_timeout:.0f}s"))
                        return
                    time.sleep(min(stall_ns, 1e-3))  # lint: allow-blocking (backpressure wait)
                    stall_ns *= 2
                    continue
                stall_ns = 5e-5
                off = tail & mask
                chunk = min(n - voff, free, cap - off)
                data[off:off + chunk] = v[voff:voff + chunk]
                tail += chunk
                voff += chunk
                total += chunk
                rg.set_tail(tail)   # publish per chunk: the consumer
                # may start parsing while we stream the rest
        self.stats.bytes_sent += total
        if rg.waiting():
            self._doorbell(peer)

    def _doorbell(self, peer: _ShmPeer) -> None:
        try:
            self._door_tx.sendto(b"\0", peer.addr)
            self.doorbells_sent += 1
            self.stats.syscalls_send += 1
        except (BlockingIOError, OSError):
            pass   # peer not bound/draining: a lost doorbell only
            # defers the wake to the loop's bounded poll timeout

    # lint: on-loop (heartbeat periodic, via the base tick)
    def _hb_send(self, r: int) -> None:
        # NEVER block the loop on a heartbeat: skip when the ring is
        # unattached or lacks space — a hung peer's full ring would
        # wedge the thread that runs check_peer_timeouts (the SocketCE
        # discipline, ported to rings)
        peer = self._peers.get(r)
        if peer is None or peer.outbound is None or self._muted:
            return
        rg = peer.outbound
        parts = _frame_parts(TAG_HB, None)   # header-only frame
        need = sum(len(p) for p in parts)
        if rg.cap - (rg.tail() - rg.head()) < need:
            return   # full: beating it would block
        self.sent_msgs += 1
        self.stats.frames_sent += 1
        self._write_views(peer, [memoryview(p) for p in parts
                                 if len(p)], count_frame=False)

    # -- failure / teardown ---------------------------------------------
    def _drop_peer(self, r: int) -> None:
        if threading.current_thread() is not self._thread and \
                self._thread.is_alive():
            self._post(("call", self._drop_peer, (r,)))
            return
        peer = self._peers.get(r)
        if peer is not None:
            peer.pending.clear()
            peer.pending_bytes = 0
            # REJOIN SUPPORT: re-create the transport state the dead
            # incarnation poisoned.  The stale outbound mapping points
            # at the dead process's (possibly unlinked) inode — close
            # it so the next send attaches to the restarted
            # incarnation's fresh ring; with rejoin armed our inbound
            # ring re-creates EMPTY with a fresh parser and an empty
            # dispatch queue, so the rejoiner's TAG_REJOIN frame lands
            # on a clean stream instead of appending to a torn one.
            # Without rejoin its residual bytes stay undrained
            # (_drain_rings skips dead peers)
            if peer.outbound is not None:
                peer.outbound.close()
                peer.outbound = None
            if peer.inbound is not None and not self._stop \
                    and self.rejoin_allowed:
                try:
                    peer.inbound.close()   # owner: unlinks the old path
                    peer.inq.clear()
                    peer.inbound = _Ring(
                        _ring_path(self.port_base, r, self.rank),
                        owner=True, cap=self._cap)
                    peer.parser, peer.fp_native = make_parser(
                        self._max_frame, require=True)
                except OSError as exc:
                    warning("rank %d: could not re-create inbound ring "
                            "for dead rank %d: %s", self.rank, r, exc)
                    peer.inbound = None

    def _kill_close(self) -> None:
        """Injected hard death: close every outbound ring (peers see
        EOF) and surface each drop locally, mirroring the TCP kill."""
        def doit():
            for peer in list(self._peers.values()):
                if peer.outbound is not None:
                    peer.outbound.set_closed()
                self._doorbell(peer)
            for peer in list(self._peers.values()):
                if peer.rank not in self.dead_peers:
                    self.declare_peer_dead(peer.rank, PeerFailedError(
                        peer.rank, f"rank {self.rank}: fault_kill "
                        "(injected)"))
        self.post(doit)

    def _shutdown_drain(self, deadline: float = 5.0) -> None:
        """Orderly shutdown ships what is already queued (a barrier
        release POSTED just before the stop flag flipped must still be
        written — the evloop transport's contract), then waits
        (bounded) for consumers to drain it before marking our
        outbound rings closed: peers see a clean EOF, not silence."""
        if not self._muted:
            end = time.monotonic() + deadline
            while time.monotonic() < end:
                self._drain_cmds()
                busy = bool(self._ring)
                for peer in self._peers.values():
                    rg = peer.outbound
                    if rg is not None and not rg.closed() and \
                            peer.rank not in self.dead_peers and \
                            rg.tail() != rg.head():
                        busy = True
                if not busy:
                    break
                time.sleep(0.002)   # lint: allow-blocking (teardown drain)
        for peer in self._peers.values():
            if peer.outbound is not None:
                peer.outbound.set_closed()
                self._doorbell(peer)

    def fini(self) -> None:
        self._stop = True
        self._post(("stop",))
        if threading.current_thread() is not self._thread:
            # longer than _shutdown_drain's 5 s (the JAX package joins
            # for 5 s too, and can unmap the rings under a loop still
            # draining into a dead peer's ring)
            self._thread.join(timeout=10)
        for peer in self._peers.values():
            if peer.outbound is not None:
                peer.outbound.close()
                peer.outbound = None
            if peer.inbound is not None:
                peer.inbound.close()
                peer.inbound = None
        for s in (self._door, self._door_tx):
            try:
                s.close()
            except OSError:
                pass
        debug_verbose(5, "rank %d shm CE down: sent=%d recv=%d %s",
                      self.rank, self.sent_msgs, self.recv_msgs,
                      self.extra_stats())
