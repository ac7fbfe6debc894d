"""The port's event-loop transport against the JAX package's, on the CPU.

Twins of tests/test_comm_evloop.py: partial-write resume under a starved
SO_SNDBUF, interleaved out-of-band payloads from two peers on one loop,
peer death mid-frame failing the connection with a cause, the eager-race
rendezvous purge, the adaptive eager threshold's feedback rules,
activation coalescing, the transport knob and its threads A/B, a mixed
eager/rendezvous stress, the cross-task flush window, the barrier abort
and the undelivered-backlog replay.  In-process cases run several
engines of one package in this process and hold the port's counters
against the JAX package's on the same traffic; spawned cases run both
packages' launchers (tests/torch_comm_workers.py), bounded by their
``timeout``.  Past the twins: the wire form of torch tensors (bf16 as
raw words, the send snapshot) and the native frame path's build
failure."""

import socket
import threading
import time

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import numpy as np
import pytest
import torch

import torch_comm_workers as W
from parsec_tpu.comm import engine as jax_engine
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.comm import engine as port_engine
from parsec_tpu_torch.comm.engine import (EventLoopCE, SocketCE, TAG_USER,
                                          make_ce)
from parsec_tpu_torch.comm.launch import _probe_port_base, run_distributed
from parsec_tpu_torch.utils.mca import params

T_RUN = 180

PKGS = {"port": (port_engine, params), "jax": (jax_engine, jax_params)}


def _mk(pkg, n):
    eng, _ = PKGS[pkg]
    base = _probe_port_base(n)
    return [eng.EventLoopCE(r, n, base) for r in range(n)]


def _fini(ces):
    for ce in ces:
        ce.fini()


def _arr(pkg, a):
    return a if pkg == "jax" else torch.from_numpy(a)


# -- partial-write resume under a full send buffer ---------------------------

def _partial_writes(pkg):
    eng, prm = PKGS[pkg]
    prm.set("comm_sockbuf_bytes", 8192)
    try:
        ce0, ce1 = _mk(pkg, 2)
    finally:
        prm.unset("comm_sockbuf_bytes")
    try:
        got = []
        evt = threading.Event()

        def cb(src, msg):
            got.append(msg)
            if len(got) == 4:
                evt.set()

        ce0.tag_register(eng.TAG_USER, cb)
        arrays = [np.arange(256 * 1024, dtype=np.float32) + i
                  for i in range(4)]
        for i, a in enumerate(arrays):
            ce1.send_am(eng.TAG_USER, 0, {"i": i, **ce1.pack(_arr(pkg, a))})
        assert evt.wait(30), f"only {len(got)}/4 frames arrived"
        assert [m["i"] for m in got] == [0, 1, 2, 3]
        for i, m in enumerate(got):
            np.testing.assert_array_equal(np.asarray(ce0.unpack(m)),
                                          arrays[i])
        assert not ce0.dead_peers and not ce1.dead_peers
        return ce1.stats.partial_writes, ce0.stats.frames_recv
    finally:
        _fini([ce0, ce1])


def test_partial_write_resume_tiny_sndbuf():
    pw, frames = _partial_writes("port")
    pw_ref, frames_ref = _partial_writes("jax")
    assert pw > 0 and pw_ref > 0     # the resume path ran in both
    assert frames == frames_ref


# -- interleaved out-of-band payloads from two peers -------------------------

def test_interleaved_oob_payloads_two_peers():
    ces = _mk("port", 3)
    ce0, ce1, ce2 = ces
    try:
        got = {1: [], 2: []}
        lock = threading.Lock()
        evt = threading.Event()

        def cb(src, msg):
            with lock:
                got[src].append(msg)
                if sum(len(v) for v in got.values()) == 12:
                    evt.set()

        ce0.tag_register(TAG_USER, cb)

        def blast(ce, base):
            for i in range(6):
                a = torch.full((128 * 1024,), float(base * 100 + i))
                ce.send_am(TAG_USER, 0, {"seq": i, **ce.pack(a)})

        t1 = threading.Thread(target=blast, args=(ce1, 1))
        t2 = threading.Thread(target=blast, args=(ce2, 2))
        t1.start(); t2.start(); t1.join(); t2.join()
        assert evt.wait(30), f"got {[len(v) for v in got.values()]}"
        for src in (1, 2):
            assert [m["seq"] for m in got[src]] == list(range(6))
            for m in got[src]:
                t = ce0.unpack(m)
                assert isinstance(t, torch.Tensor) and t.shape == (131072,)
                assert torch.equal(t, torch.full((131072,),
                                                 float(src * 100 + m["seq"])))
        assert ce0.stats.frames_parsed_native >= 12   # the native parser
    finally:
        _fini(ces)


# -- peer death: mid-frame versus between frames -----------------------------

def _death(pkg, midframe):
    eng, _ = PKGS[pkg]
    base = _probe_port_base(1)
    ce = eng.EventLoopCE(0, 2, base)
    errors = []
    ce.on_error = errors.append
    try:
        import pickle
        s = socket.create_connection(("127.0.0.1", base), timeout=10)
        s.sendall(eng._HANDSHAKE.pack(eng._WIRE_MAGIC, eng._WIRE_VERSION, 1))
        if midframe:
            s.sendall(eng._LEN.pack(eng.TAG_USER, 4096, 0) + b"x" * 100)
        else:
            body = pickle.dumps("bye")
            s.sendall(eng._LEN.pack(eng.TAG_USER, len(body), 0) + body)
        time.sleep(0.3)
        s.close()
        deadline = time.monotonic() + 10
        while 1 not in ce.dead_peers and time.monotonic() < deadline:
            time.sleep(0.02)
        return 1 in ce.dead_peers, [(type(e).__name__, str(e))
                                    for e in errors]
    finally:
        ce.fini()


def test_peer_death_mid_frame_cause():
    dead, errs = _death("port", True)
    assert dead and errs and errs[0][0] == "PeerFailedError"
    assert "mid-frame" in errs[0][1], errs
    assert _death("jax", True)[1][0][0] == errs[0][0]


def test_clean_close_between_frames_no_midframe_cause():
    dead, errs = _death("port", False)
    assert dead and errs and "mid-frame" not in errs[0][1]
    assert _death("jax", False)[1][0][0] == errs[0][0]


# -- eager-race rendezvous-handle purge --------------------------------------

def _purged_handle_worker(ctx, rank, nranks):
    from parsec_tpu_torch.comm.engine import TAG_GET_REQ
    rde = ctx.comm
    rde.ce.barrier()
    if rank == 1:
        # a pending pull whose handle rank 0 never serves (the eager
        # race: the sender purged it before our GET)
        rde._pending_gets[(0, 987654)] = {"tp": None, "deliveries": []}
        rde._send_app(TAG_GET_REQ, 0, {"handle": 987654, "from": 1})
        deadline = time.monotonic() + 30
        while not ctx._errors:
            if time.monotonic() > deadline:
                return "no-error"
            time.sleep(0.02)
        msg = str(ctx._errors[0][0])
        assert "expired before our GET" in msg, msg
        assert (0, 987654) not in rde._pending_gets
        rde.ce.barrier()
        return "receiver-missed"
    rde.ce.barrier()        # rank 0 must survive the bogus GET
    return "server-alive"


def test_eager_race_rendezvous_purge():
    res = run_distributed(_purged_handle_worker, 2, device="cpu",
                          timeout=T_RUN)
    assert res == ["server-alive", "receiver-missed"]


# -- adaptive eager threshold: feedback rules --------------------------------

class _FakeFeedbackCE:
    def __init__(self):
        self.fb = {"out_bytes": 0, "delay_ewma": None, "rate_ewma": None}

    def peer_feedback(self, dst):
        return self.fb


def _bare_rde(pkg, eager=65536):
    import importlib
    mod = importlib.import_module(
        ("parsec_tpu" if pkg == "jax" else "parsec_tpu_torch")
        + ".comm.remote_dep")
    prm = PKGS[pkg][1]
    rde = mod.RemoteDepEngine.__new__(mod.RemoteDepEngine)
    rde.eager = eager
    rde._proto_peer = {}
    rde._proto_lock = threading.Lock()
    rde.proto = {"eager_downshift": 0, "eager_upshift": 0}
    rde._bp_budget = float(prm.get("comm_backpressure_ms", 2.0)) * 1e-3
    rde._eager_floor_cfg = int(prm.get("comm_eager_min", 4096))
    rde._eager_cap_mult = max(1, int(prm.get("comm_eager_cap_mult", 4)))
    rde.ce = _FakeFeedbackCE()
    return rde


def _adaptive_trace(pkg):
    """The threshold after each step of one congestion/recovery script."""
    rde = _bare_rde(pkg)
    trace = []

    def step(fb, n=1):
        rde.ce.fb = fb
        for _ in range(n):
            if 1 in rde._proto_peer:
                rde._proto_peer[1]["adj_at"] -= 1.0   # past the window
            rde._peer_eager(1)
        trace.append(rde._proto_peer[1]["eager"])

    step({"out_bytes": 0, "delay_ewma": 1e-4, "rate_ewma": 1e9})
    step({"out_bytes": 100 << 20, "delay_ewma": 0.5, "rate_ewma": 10e6})
    step({"out_bytes": 100 << 20, "delay_ewma": 0.5, "rate_ewma": 10e6}, 20)
    step({"out_bytes": 0, "delay_ewma": 1e-5, "rate_ewma": 5e9}, 30)
    # a burst of queries within one window shifts at most once
    rde.ce.fb = {"out_bytes": 100 << 20, "delay_ewma": 0.5,
                 "rate_ewma": 10e6}
    before = rde.proto["eager_downshift"]
    rde._proto_peer[1]["adj_at"] -= 1.0
    for _ in range(10):
        rde._peer_eager(1)
    trace.append(rde.proto["eager_downshift"] - before)
    return trace, dict(rde.proto)


def test_adaptive_eager_downshift_and_recovery():
    trace, proto = _adaptive_trace("port")
    floor = min(int(params.get("comm_eager_min", 4096)), 65536)
    cap = 65536 * int(params.get("comm_eager_cap_mult", 4))
    assert trace[0] >= 65536 and trace[1] < trace[0]
    assert trace[2] == floor and trace[3] == cap and trace[4] == 1
    assert proto["eager_downshift"] > 0 and proto["eager_upshift"] > 0
    assert (trace, proto) == _adaptive_trace("jax")


def test_adaptive_eager_disabled_keeps_base():
    rde = _bare_rde("port", eager=1234)
    rde.ce.fb = {"out_bytes": 100 << 20, "delay_ewma": 9.9,
                 "rate_ewma": 1.0}
    params.set("comm_adaptive_eager", False)
    try:
        assert rde._peer_eager(1) == 1234
    finally:
        params.unset("comm_adaptive_eager")


# -- activation coalescing: one frame per destination per task ---------------

def _coalesce_worker(ctx, rank, nranks, pkg):
    api = W._mod(pkg, "dsl.ptg.api")
    V = W._one_edge(pkg, nranks, rank, 2.0)
    seen = {}
    p = api.PTG("coal")
    p.task("P").affinity(lambda V=V: V(0)) \
        .flow("X", "READ", api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.TASK("C", "X", lambda: dict()))) \
        .flow("Y", "READ", api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.TASK("C", "Y", lambda: dict()))) \
        .body(lambda: None)
    p.task("C").affinity(lambda V=V: V(1)) \
        .flow("X", "READ", api.IN(api.TASK("P", "X", lambda: dict()))) \
        .flow("Y", "READ", api.IN(api.TASK("P", "Y", lambda: dict()))) \
        .body(lambda X, Y: seen.update(x=float(W.get(X)[0]),
                                       y=float(W.get(Y)[0])))
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=120)
    st = ctx.comm.stats()
    return {"seen": seen, "coal": (st["coalesced_batches"],
                                   st["coalesced_msgs"])}


def test_activation_coalescing_one_frame_per_dst():
    j, p = W.run_both(_coalesce_worker, 2, timeout=T_RUN)
    assert p[1]["seen"] == j[1]["seen"] == {"x": 2.0, "y": 2.0}
    assert p[0]["coal"] == j[0]["coal"]
    assert p[0]["coal"][0] >= 1 and p[0]["coal"][1] >= 2


# -- transport knob and its threads A/B --------------------------------------

def test_make_ce_transport_knob():
    base = _probe_port_base(1)
    params.set("comm_transport", "threads")
    try:
        ce = make_ce(0, 1, base)
        assert isinstance(ce, SocketCE) and ce.TRANSPORT == "threads"
        ce.fini()
        params.set("comm_transport", "evloop")
        ce = make_ce(0, 1, base)
        assert isinstance(ce, EventLoopCE) and ce.TRANSPORT == "evloop"
        ce.fini()
    finally:
        params.unset("comm_transport")


def _ab_chain(ctx, rank, nranks, pkg):
    assert type(ctx.comm.ce).__name__ == "SocketCE"
    assert ctx.comm.stats()["transport"] == "threads"
    return W.chain(ctx, rank, nranks, pkg, NT=6)


def test_threads_transport_ab_reproduces_old_path(monkeypatch):
    monkeypatch.setenv("PARSEC_MCA_COMM_TRANSPORT", "threads")
    j, p = W.run_both(_ab_chain, 2, timeout=T_RUN)
    assert W.merged(p) == W.merged(j) == {k: float(k + 1) for k in range(6)}
    for rj, rp in zip(j, p):
        assert rj["proto"] == rp["proto"] and rj["done"] == rp["done"]


# -- loopback stress: mixed eager + rendezvous ------------------------------

def _stress_worker(ctx, rank, nranks, pkg, seeds):
    """Chains over tiles straddling the eager threshold (64 B and 1 KiB
    ride eager, 32 KiB exceeds even the adaptive cap): payload integrity
    under mixed protocols."""
    ctx.comm.eager = 2048
    out = {}
    for i, seed in enumerate(seeds):
        NT, mb = 8, [16, 256, 8192][i % 3]
        V = W._vec(pkg, nranks, rank, mb, NT * mb, name=f"S{seed}")
        for m, _ in V.local_tiles():
            W.put(V.data_of(m).copy_on(0).payload, np.zeros(mb, np.float32))
        ctx.add_taskpool(W._chain_pool(pkg, V, NT, f"stress{seed}"))
        ctx.wait(timeout=120)
        for m, _ in V.local_tiles():
            out[(seed, m)] = float(W.get(V.data_of(m).pull_to_host()
                                         .payload)[0])
    st = ctx.comm.stats()
    return {"vals": out, "eager": st["act_eager"], "rdv": st["act_rdv"]}


def test_loopback_stress_mixed_eager_rdv():
    seeds = [11, 23, 47]
    j, p = W.run_both(_stress_worker, 2, args=(seeds,), timeout=240)
    assert W.merged(p) == W.merged(j) == \
        {(s, k): float(k + 1) for s in seeds for k in range(8)}
    eager = sum(r["eager"] for r in p)
    rdv = sum(r["rdv"] for r in p)
    assert eager > 0 and rdv > 0
    assert (eager, rdv) == (sum(r["eager"] for r in j),
                            sum(r["rdv"] for r in j))


# -- cross-task flush window --------------------------------------------------

def _window_worker(ctx, rank, nranks, pkg):
    api = W._mod(pkg, "dsl.ptg.api")
    N = 6
    V = W._one_edge(pkg, nranks, rank, 1.0)
    Wv = W._vec(pkg, nranks, rank, 4, 4 * N * nranks, name="W")
    for m, _ in Wv.local_tiles():
        W.put(Wv.data_of(m).copy_on(0).payload, np.zeros(4, np.float32))
    p = api.PTG("win", N=N)
    p.task("P", i=api.Range(0, N - 1)).affinity(lambda i, V=V: V(0)) \
        .flow("X", "READ", api.IN(api.DATA(lambda i, V=V: V(0))),
              api.OUT(api.TASK("C", "X", lambda i: dict(i=i)))) \
        .body(lambda: None)
    p.task("C", i=api.Range(0, N - 1)) \
        .affinity(lambda i, Wv=Wv: Wv(2 * i + 1)) \
        .flow("X", "READ", api.IN(api.TASK("P", "X", lambda i: dict(i=i)))) \
        .flow("O", "RW", api.IN(api.DATA(lambda i, Wv=Wv: Wv(2 * i + 1))),
              api.OUT(api.DATA(lambda i, Wv=Wv: Wv(2 * i + 1)))) \
        .body(lambda X, O: O + X + 1.0)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=120)
    return {"vals": {m: float(W.get(Wv.data_of(m).pull_to_host()
                                    .payload)[0])
                     for m, _ in Wv.local_tiles()}}


def test_cross_task_flush_window(monkeypatch):
    monkeypatch.setenv("PARSEC_MCA_COMM_FLUSH_WINDOW_MS", "2")
    j, p = W.run_both(_window_worker, 2, timeout=T_RUN)
    got = W.merged(p)
    assert got == W.merged(j)
    for i in range(6):
        assert got[2 * i + 1] == 2.0, (i, got)


# -- barrier abort and the undelivered backlog --------------------------------

def test_barrier_abort_fails_survivors_fast():
    ces = _mk("port", 3)
    ce0, ce1, ce2 = ces
    try:
        ce2.fini()                 # rank 2 dies without arriving
        deadline = time.monotonic() + 10
        while (2 not in ce0.dead_peers or 2 not in ce1.dead_peers) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert 2 in ce0.dead_peers and 2 in ce1.dead_peers
        errs = {}

        def run(name, ce):
            t0 = time.monotonic()
            try:
                ce.barrier(timeout=30)
                errs[name] = ("none", time.monotonic() - t0)
            except Exception as exc:
                errs[name] = (exc, time.monotonic() - t0)

        t1 = threading.Thread(target=run, args=("r1", ce1))
        t1.start()
        run("r0", ce0)
        t1.join(timeout=30)
        assert not t1.is_alive()
        assert isinstance(errs["r0"][0], ConnectionError), errs
        assert isinstance(errs["r1"][0], ConnectionError), errs
        assert errs["r1"][1] < 10, errs
    finally:
        _fini([ce0, ce1])


def test_undelivered_backlog_replayed_on_register():
    ce0, ce1 = _mk("port", 2)
    try:
        ce1.send_am(TAG_USER, 0, {"early": True})
        time.sleep(0.3)            # lands before anyone registered
        got = []
        evt = threading.Event()
        ce0.tag_register(TAG_USER, lambda s, p: (got.append((s, p)),
                                                 evt.set()))
        assert evt.wait(10)
        assert got == [(1, {"early": True})]
    finally:
        _fini([ce0, ce1])


# -- multi-core A/B of the two socket transports ------------------------------

def _pingpong_worker(ctx, rank, nranks, nbytes, hops):
    """AM ping-pong of one ``nbytes`` tensor: returns MB/s of payload."""
    ce = ctx.comm.ce
    box = []
    evt = threading.Event()
    ce.tag_register(TAG_USER + 1, lambda s, p: (box.append(p), evt.set()))
    ce.barrier()
    payload = torch.zeros(nbytes // 4)
    t0 = time.perf_counter()
    for _ in range(hops):
        if rank == 0:
            ce.send_am(TAG_USER + 1, 1, ce.pack(payload))
        assert evt.wait(30)
        evt.clear()
        if rank == 1:
            ce.send_am(TAG_USER + 1, 0, box[-1])
    dt = time.perf_counter() - t0
    ce.barrier()
    return 2 * hops * nbytes / dt / 1e6, ctx.comm.stats()["transport"]


@pytest.mark.slow
def test_evloop_threads_parity_multicore():
    """The JAX package's multi-core A/B (its pingpong app is not ported:
    an AM ping-pong of 1 MiB tensors stands in): on >= 2 cores the
    evloop transport holds parity with the threads transport."""
    import os
    cores = len(os.sched_getaffinity(0))
    if cores < 2:
        pytest.skip(f"needs >= 2 available cores (have {cores})")
    bw = {}
    for transport in ("threads", "evloop"):
        os.environ["PARSEC_MCA_COMM_TRANSPORT"] = transport
        try:
            res = run_distributed(_pingpong_worker, 2, args=(1 << 20, 24),
                                  device="cpu", timeout=240)
        finally:
            os.environ.pop("PARSEC_MCA_COMM_TRANSPORT", None)
        assert all(r[1] == transport for r in res), res
        bw[transport] = max(r[0] for r in res)
    assert bw["evloop"] / bw["threads"] >= 0.5, bw


# -- the wire form of torch tensors -----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int64])
def test_tensor_round_trips_through_a_frame(dtype):
    """pack -> frame -> parse -> unpack gives the same tensor back;
    bf16 travels as its raw 16-bit words (numpy has no bf16) and the
    received tensor views the frame's own buffer."""
    import pickle
    from parsec_tpu_torch.comm.frames import make_parser
    src = (torch.arange(3 * 5, dtype=torch.float32) * 1.25 - 7
           ).reshape(3, 5).to(dtype)
    msg = EventLoopCE.pack(src.t())          # non-contiguous source
    assert msg["dtype"] == str(dtype).split(".")[1]
    fp, native = make_parser(1 << 24)
    assert native
    wire = b"".join(bytes(p) for p in port_engine._frame_parts(
        TAG_USER, msg))
    (tag, body, oob), = fp.feed(wire)
    assert tag == TAG_USER and len(oob) == 1   # the payload rode out of band
    back = EventLoopCE.unpack(pickle.loads(body, buffers=oob))
    assert back.dtype == dtype and torch.equal(back, src.t())
    back.add_(1)                               # writable, private


def test_pack_snapshots_the_payload():
    """The snapshot contract: pack takes one owned copy, so an in-place
    write of the source after pack does not reach the frame."""
    t = torch.ones(1024, dtype=torch.bfloat16)
    msg = EventLoopCE.pack(t)
    t.add_(5)
    assert torch.equal(EventLoopCE.unpack(msg),
                       torch.ones(1024, dtype=torch.bfloat16))


def test_native_frame_path_that_does_not_build_raises(tmp_path,
                                                      monkeypatch):
    """No silent tier: with comm_frame_native on, an engine whose commext
    does not build raises NativeBuildError (the JAX package falls back to
    its Python parser); comm_frame_native=0 runs the Python parser."""
    from parsec_tpu_torch import native
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cexts", {})
    monkeypatch.setattr(port_engine, "_nat_parts", None)
    monkeypatch.setattr(port_engine, "_nat_parts_tried", False)
    (tmp_path / "commext.c").write_text("this is not C;\n")
    with pytest.raises(native.NativeBuildError, match="commext"):
        EventLoopCE(0, 1, _probe_port_base(1))
    from parsec_tpu_torch.comm.frames import make_parser
    with pytest.raises(native.NativeBuildError, match="commext"):
        make_parser(1 << 20, require=True)
    params.set("comm_frame_native", 0)
    try:
        ce = EventLoopCE(0, 1, _probe_port_base(1))
        ce.fini()
        assert port_engine._native_parts() is None
    finally:
        params.unset("comm_frame_native")
