"""The port's shared-memory transport and frame parsers against the JAX
package's, on the CPU.

Twins of tests/test_comm_shm.py: the native (commext.c) and Python
frame parsers under adversarial chunking, the zero-copy bulk target, the
bound check and the ``comm_frame_native`` knob; ShmCE's AM round trip
and counters, a payload larger than the ring, one-sided put/get,
barrier and clock probe, ring-file cleanup, the transport knob with its
multi-host fallback, a 2-rank ping-pong over spawned ranks, the nested
send during a ring-full stall, and a loop that must not busy-spin on
bytes it will never drain.  The port's frames are fed to the JAX
package's parser (and back) to show the wire format is the same.  Past
the twins: a ring that cannot be allocated raises with its path and
size."""

import errno
import os
import random
import struct
import threading
import time

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import numpy as np
import pytest
import torch

from parsec_tpu.comm.frames import PyFrameParser as JaxPyFrameParser
from parsec_tpu_torch.comm import shm as shm_mod
from parsec_tpu_torch.comm.engine import EventLoopCE, make_ce
from parsec_tpu_torch.comm.frames import PyFrameParser, make_parser
from parsec_tpu_torch.comm.launch import _probe_port_base, run_distributed
from parsec_tpu_torch.comm.shm import ShmCE, _ring_path
from parsec_tpu_torch.utils.mca import params

_LEN = struct.Struct("!IQI")
_BUFLEN = struct.Struct("!Q")


def _stream(frames):
    """Serialize (tag, body, [oob...]) frames into one wire stream."""
    out = bytearray()
    for tag, body, oob in frames:
        out += _LEN.pack(tag, len(body), len(oob))
        out += body
        for b in oob:
            out += _BUFLEN.pack(len(b)) + b
    return bytes(out)


def _parsers():
    """The port's native and Python parsers and the JAX package's Python
    parser, on the same streams."""
    nat, is_nat = make_parser(1 << 24)
    assert is_nat
    return [nat, PyFrameParser(1 << 24), JaxPyFrameParser(1 << 24)]


def test_parser_parity_random_chunking():
    rng = random.Random(11)
    frames = [
        (1, b"x" * 5, []),
        (2, b"", []),                           # header-only
        (3, b"y" * 100, [b"z" * 70000, b""]),   # oob incl. empty
        (7, b"q" * 3, [b"w" * 9]),
    ]
    stream = _stream(frames)
    cuts = []
    off = 0
    while off < len(stream):
        n = rng.randrange(1, 37)
        cuts.append((off, n))
        off += n
    for fp in _parsers():
        got = []
        for off, n in cuts:
            got.extend(fp.feed(stream[off:off + n]))
        assert fp.idle() and fp.stats() == len(frames)
        assert [(t, bytes(b or b""), [bytes(x) for x in o])
                for t, b, o in got] == frames


def test_parser_bulk_target_zero_copy_path():
    big = os.urandom(200_000)
    stream = _stream([(5, b"hdr", [big])])
    for fp in _parsers():
        fp.feed(stream[:64])
        tgt = fp.bulk_target()
        assert tgt is not None
        n = min(len(tgt), len(stream) - 64)
        tgt[:n] = stream[64:64 + n]
        frames = fp.bulk_commit(n)
        if not frames:
            frames = fp.feed(stream[64 + n:])
        (tag, body, oob), = frames
        assert tag == 5 and bytes(oob[0]) == big


def test_parser_bound_violation_raises():
    bad = _LEN.pack(1, 1 << 40, 0)
    for fp in [PyFrameParser(1 << 20),
               make_parser(1 << 20, require=True)[0]]:
        with pytest.raises(ValueError):
            fp.feed(bad)


def test_parser_knob_selects_python_parser():
    params.set("comm_frame_native", 0)
    try:
        fp, native = make_parser(1 << 20, require=True)
        assert isinstance(fp, PyFrameParser) and not native
        fp2, native2 = make_parser(1 << 20)
        assert fp2 is None and not native2
    finally:
        params.unset("comm_frame_native")


def _pair(base=None):
    base = base or _probe_port_base(2)
    return ShmCE(0, 2, base), ShmCE(1, 2, base)


def _drain(ces):
    for ce in ces:
        ce._stop = True
        ce.fini()


def _wait(pred, secs=10):
    t0 = time.time()
    while not pred() and time.time() - t0 < secs:
        time.sleep(0.01)
    return pred()


def test_shm_am_roundtrip_and_counters():
    ce0, ce1 = _pair()
    got = []
    try:
        ce1.tag_register(20, lambda src, p: got.append((src, p)))
        ce0.send_am(20, 1, {"k": 1})
        assert _wait(lambda: got, 5)
        assert got == [(0, {"k": 1})]
        assert ce0.stats.frames_sent == 1
        assert ce1.stats.frames_recv == 1
        assert ce1.stats.syscalls_recv == 0    # the point of shm
        assert ce1._peers[0].fp_native
        assert ce1.stats.frames_parsed_native == 1
    finally:
        _drain((ce0, ce1))


def test_shm_payload_larger_than_ring_streams_through():
    params.set("comm_shm_ring_mb", 1)    # ring << payload
    try:
        ce0, ce1 = _pair()
        out = []
        ce1.tag_register(21, lambda src, p: out.append(ShmCE.unpack(p)))
        arr = torch.arange(1_500_000, dtype=torch.float32)   # ~6MB
        ce0.send_am(21, 1, ShmCE.pack(arr))
        assert _wait(lambda: out, 20)
        assert torch.equal(out[0], arr)
        assert ce0.ring_full_stalls > 0
    finally:
        _drain((ce0, ce1))
        params.unset("comm_shm_ring_mb")


def test_shm_onesided_put_get():
    ce0, ce1 = _pair()
    try:
        target = torch.zeros(128)
        rid = ce1.mem_register(target)
        src = torch.arange(128, dtype=torch.float32)
        done = []
        ce0.put(1, src, rid, on_complete=done.append)
        assert _wait(lambda: done, 5)
        assert done == [None]
        assert torch.equal(target, src)
        got = []
        ce0.get(1, rid, got.append)
        assert _wait(lambda: got, 5)
        assert torch.equal(got[0], src)
    finally:
        _drain((ce0, ce1))


def test_shm_barrier_and_clock_probe():
    ce0, ce1 = _pair()
    try:
        errs = []

        def bar(ce):
            try:
                ce.barrier(timeout=15)
            except Exception as exc:   # surfaced below
                errs.append(exc)
        t0 = threading.Thread(target=bar, args=(ce0,))
        t1 = threading.Thread(target=bar, args=(ce1,))
        t0.start(); t1.start(); t0.join(20); t1.join(20)
        assert not t0.is_alive() and not t1.is_alive()
        assert not errs
        ce0.probe_clocks()
        assert _wait(lambda: 1 in ce0.clock, 5)
        assert ce0.clock[1]["rtt"] >= 0
    finally:
        _drain((ce0, ce1))


def test_shm_ring_files_cleaned_up():
    base = _probe_port_base(2)
    ce0, ce1 = _pair(base)
    paths = [_ring_path(base, 0, 1), _ring_path(base, 1, 0)]
    assert all(os.path.exists(p) for p in paths)
    _drain((ce0, ce1))
    assert not any(os.path.exists(p) for p in paths)


def test_make_ce_selects_shm_and_host_fallback():
    params.set("comm_transport", "shm")
    try:
        ce = make_ce(0, 1, _probe_port_base(1))
        try:
            assert isinstance(ce, ShmCE) and ce.TRANSPORT == "shm"
        finally:
            ce._stop = True
            ce.fini()
        # multi-host address book: shm is same-host only -> evloop
        params.set("comm_hosts", "127.0.0.1")
        ce = make_ce(0, 1, _probe_port_base(1))
        try:
            assert isinstance(ce, EventLoopCE)
        finally:
            ce._stop = True
            ce.fini()
    finally:
        params.unset("comm_transport")
        params.unset("comm_hosts")


def _shm_pp(ctx, rank, nranks):
    """Eight ping-pong hops of a 256 KiB tensor (the JAX package's case
    runs its pingpong app, which the port does not carry)."""
    from parsec_tpu_torch.comm.engine import TAG_USER
    ce = ctx.comm.ce
    box = []
    evt = threading.Event()
    ce.tag_register(TAG_USER, lambda s, p: (box.append(p), evt.set()))
    ce.barrier()
    payload = torch.arange(1 << 16, dtype=torch.float32)
    for _ in range(8):
        if rank == 0:
            ce.send_am(TAG_USER, 1, ce.pack(payload))
        assert evt.wait(30)
        evt.clear()
        if rank == 1:
            ce.send_am(TAG_USER, 0, box[-1])
    ce.barrier()
    ok = all(torch.equal(ce.unpack(m), payload) for m in box)
    return ok, ctx.comm.stats()


def test_shm_distributed_pingpong(monkeypatch):
    monkeypatch.setenv("PARSEC_MCA_COMM_TRANSPORT", "shm")
    res = run_distributed(_shm_pp, 2, device="cpu", timeout=120)
    for ok, st in res:
        assert ok
        assert st["transport"] == "shm"
        assert st["frames_sent"] > 0
        assert st["syscalls_recv"] == 0
        assert "shm_doorbells_sent" in st


def test_shm_nested_send_during_stall_loses_nothing():
    """A handler dispatched by the stall path's drain-own-inbound
    deadlock breaker may SEND to the very peer being written: the nested
    frame must queue behind the in-progress write, not interleave into
    its byte stream."""
    params.set("comm_shm_ring_mb", 0)     # clamps to the 64KB floor
    try:
        ce0, ce1 = _pair()
        got1 = []
        ce1.tag_register(30, lambda src, p: got1.append(("big", len(p["b"]))))
        ce1.tag_register(31, lambda src, p: got1.append(("reply", p)))
        ce0.tag_register(32, lambda src, p: ce0.send_am(31, 1, {"r": p}))
        ce1.post(time.sleep, 0.4)   # stall ce1 so the 300KB frame overfills
        time.sleep(0.05)
        ce1.send_am(32, 0, 7)
        time.sleep(0.05)
        ce0.send_am(30, 1, {"b": b"x" * 300_000})
        assert _wait(lambda: len(got1) >= 2, 10)
        assert ("big", 300_000) in got1, got1
        assert ("reply", {"r": 7}) in got1, got1
        assert ce0.ring_full_stalls > 0
        assert not ce0.dead_peers and not ce1.dead_peers
    finally:
        _drain((ce0, ce1))
        params.unset("comm_shm_ring_mb")


def test_shm_loop_does_not_busy_spin_on_a_dead_peers_bytes():
    """Bytes a dead peer left in our inbound ring are never drained: the
    loop must sleep in poll, not spin on its dirty check (the JAX
    package's case mutes the engine through the fault injector, whose
    comm directives the port leaves out)."""
    import resource
    from parsec_tpu_torch.core.errors import PeerFailedError
    ce0, ce1 = _pair()
    try:
        ce0.declare_peer_dead(1, PeerFailedError(1, "test: declared dead"))
        ce1.send_am(13, 0, None)          # now-undrainable bytes
        time.sleep(0.2)
        cpu0 = resource.getrusage(resource.RUSAGE_SELF).ru_utime
        time.sleep(1.0)
        cpu = resource.getrusage(resource.RUSAGE_SELF).ru_utime - cpu0
        assert cpu < 0.5, f"shm loop burned {cpu:.2f}s CPU/s"
        rg = ce0._peers[1].inbound
        assert rg.tail() != rg.head()     # the bytes really are there
    finally:
        _drain((ce0, ce1))


def test_wire_format_is_the_jax_packages():
    """Frames the port builds parse with the JAX package's parser into
    the same message, and the JAX package's frames parse with the
    port's native parser."""
    import pickle
    from parsec_tpu.comm import engine as jax_engine
    from parsec_tpu_torch.comm import engine as port_engine
    msg = {"k": [1, 2, 3], "s": "x" * 300}
    for build, parser in ((port_engine._frame_parts,
                           JaxPyFrameParser(1 << 20)),
                          (jax_engine._frame_parts,
                           make_parser(1 << 20)[0])):
        wire = b"".join(bytes(p) for p in build(42, msg))
        (tag, body, oob), = parser.feed(wire)
        assert tag == 42 and pickle.loads(body, buffers=oob) == msg


def test_a_ring_that_cannot_be_allocated_raises_with_path_and_size(
        monkeypatch):
    """A /dev/shm too small for a ring fails its ShmCE at construction,
    naming the file and the bytes, instead of a SIGBUS at the first write
    past the free space."""
    def no_space(fd, off, ln):
        raise OSError(errno.ENOSPC, "No space left on device")
    monkeypatch.setattr(shm_mod.os, "posix_fallocate", no_space)
    base = _probe_port_base(2)
    with pytest.raises(OSError) as info:
        ShmCE(0, 2, base)
    path = _ring_path(base, 1, 0)
    cap = 1 << (max(64 << 10, int(params.get("comm_shm_ring_mb", 8)) << 20)
                - 1).bit_length()
    assert info.value.errno == errno.ENOSPC
    assert path in str(info.value) and str(64 + cap) in str(info.value)
    assert not os.path.exists(path)


def test_shm_handler_send_that_stalls_drains_the_same_ring_once():
    """A handler whose reply stalls on a full ring drains its inbound
    rings (the deadlock breaker) — including the ring it was dispatched
    from.  That nested drain must not leave the outer drain replaying
    bytes it already parsed: every request is served exactly once, in
    order, and the stream stays intact (the JAX package's shm.py
    re-reads from its stale head there and corrupts the stream)."""
    params.set("comm_shm_ring_mb", 0)     # clamps to the 64KB floor
    try:
        ce0, ce1 = _pair()
        got0 = []
        ce0.tag_register(41, lambda src, p: got0.append(p["i"]))
        ce1.tag_register(40, lambda src, p: ce1.send_am(
            41, 0, {"i": p["i"], "b": b"y" * 300_000}))
        for i in range(6):                # 6 x 40KB requests > the ring
            ce0.send_am(40, 1, {"i": i, "pad": b"x" * 40_000})
        assert _wait(lambda: len(got0) >= 6, 20), got0
        time.sleep(0.2)
        assert got0 == list(range(6)), got0
        assert not ce0.dead_peers and not ce1.dead_peers
        assert ce1.ring_full_stalls > 0
    finally:
        _drain((ce0, ce1))
        params.unset("comm_shm_ring_mb")


def test_shm_ring_indices_are_single_8_byte_words():
    """The ring's head and tail live in one native u64 view of the
    header (one aligned copy each way, where a byte-wise struct copy can
    be read half-written by the other process), and a write that finds
    them inconsistent fails with its cause instead of tearing the
    stream."""
    ce0, ce1 = _pair()
    errors = []
    ce0.on_error = errors.append
    try:
        rg = ce1._peers[0].inbound
        assert rg.idx.format == "Q" and rg.idx.itemsize == 8
        ce1.post(time.sleep, 1.0)         # the consumer drains nothing
        time.sleep(0.1)
        rg.set_head(0x0102030405060708)
        assert struct.unpack_from("<Q", rg.mm, 24)[0] == 0x0102030405060708
        assert rg.head() == 0x0102030405060708
        ce0.send_am(22, 1, {"x": 1})      # head far past tail: refused
        assert _wait(lambda: errors, 5)
        assert "inconsistent" in str(errors[0]), errors
    finally:
        _drain((ce0, ce1))


def test_shm_attach_to_a_ring_not_sized_yet_retries(tmp_path):
    """A sender can open the receiver's ring file after it was created
    and before it was sized: that is "not ready yet" (OSError, retried
    by the sender's attach), never an mmap ValueError that fails the
    loop."""
    from parsec_tpu_torch.comm.shm import _Ring
    path = tmp_path / "ring"
    path.write_bytes(b"")
    with pytest.raises(OSError, match="not initialized"):
        _Ring(str(path), owner=False, cap=0)
    ring = _Ring(str(path), owner=True, cap=1 << 16)
    try:
        peer = _Ring(str(path), owner=False, cap=0)
        assert peer.cap == 1 << 16
        peer.close()
    finally:
        ring.close()


def test_shm_stalled_write_survives_its_drain_declaring_the_peer_dead():
    """A write stalled on a full ring drains our own inbound rings; when
    that drain meets the peer's end of stream it declares the peer dead,
    which closes the very ring being written.  The write must stop there
    (the frame is undeliverable, as to any dead peer), not read the
    closed ring's indices (seen on the card: a 2-rank DTD GEMM's 8 MiB
    payload to the rank the fault plan had just killed)."""
    params.set("comm_shm_ring_mb", 0)     # clamps to the 64KB floor
    try:
        ce0, ce1 = _pair()
        errors = []
        ce0.on_error = errors.append
        ce0.rejoin_allowed = True         # the survivor re-creates rings
        ce0.send_am(13, 1, None)          # attach both outbound rings
        ce1.send_am(13, 0, None)
        assert _wait(lambda: ce0._peers[1].outbound is not None
                     and ce1._peers[0].outbound is not None, 5)
        ce1.post(time.sleep, 0.6)         # ce1 stops draining ...
        time.sleep(0.05)
        ce0.send_am(30, 1, {"b": b"x" * 300_000})   # ... so ce0 stalls
        assert _wait(lambda: ce0.ring_full_stalls > 0, 5)
        ce1._peers[0].outbound.set_closed()   # ce1's stream to ce0 ends
        assert _wait(lambda: 1 in ce0.dead_peers, 5)
        time.sleep(0.2)
        # the death itself reaches on_error (no containment is wired
        # here); nothing else may
        from parsec_tpu_torch.core.errors import PeerFailedError
        assert [e for e in errors if not isinstance(e, PeerFailedError)] \
            == []
        assert ce0._peers[1].outbound is None
    finally:
        _drain((ce0, ce1))
        params.unset("comm_shm_ring_mb")
