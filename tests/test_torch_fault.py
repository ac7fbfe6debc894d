"""The port's comm fault directives and failure detectors against the JAX
package's, on the CPU, in one process.

Twins of the in-process cases of tests/test_fault.py: the plan grammar
and its seeded decisions, ``delay_recv`` matching and the receive-path
reorder it forces, the hard-close and silent-hang detectors on the
event-loop, threads and shm transports, the starved checker, the shm send
path's frame directives, the hang autopsy's comm state, and the flight
recorder named by the autopsy.  Each case runs once per package
(``pkg``) with the reference test's assertions, except the three
detection-latency cases, which hold wall-clock bounds: they run the port
only (``PORT``; tests/test_fault.py runs the JAX package's side), so that
two packages' timed engines never share one loaded test host.  The
multi-process cases are in tests/test_torch_fault_dist.py.
"""

import importlib
import time

import pytest

PKGS = ["jax", "port"]


def M(pkg, name):
    return importlib.import_module(
        ("parsec_tpu." if pkg == "jax" else "parsec_tpu_torch.") + name)


def fi(pkg):
    return M(pkg, "utils.faultinject")


def P(pkg):
    return M(pkg, "utils.mca").params


def PeerFailedError(pkg):
    return M(pkg, "core.errors").PeerFailedError


def _port_base(pkg):
    return M(pkg, "comm.launch")._probe_port_base(2)


def _pair_of_engines(pkg, port_base):
    EventLoopCE = M(pkg, "comm.engine").EventLoopCE
    return EventLoopCE(0, 2, port_base), EventLoopCE(1, 2, port_base)


BOTH = pytest.mark.parametrize("pkg", PKGS)
PORT = pytest.mark.parametrize("pkg", ["port"])


# ---------------------------------------------------------------------------
# plan grammar
# ---------------------------------------------------------------------------

@BOTH
def test_fault_plan_parsing(pkg):
    plan = fi(pkg).FaultPlan(
        "seed=9;drop_frame=tag:ACT,p=0.25,n=3;"
        "delay_frame=tag:DTD,pm='ver': 0,ms=250;"
        "kill_rank=1@t+2.5s,mode=hang;fail_task=key~POTRF(k=0),n=2;"
        "delay_dispatch=ms=5,p=0.1")
    assert plan.seed == 9
    kinds = [d.kind for d in plan.directives]
    assert kinds == ["drop_frame", "delay_frame", "kill_rank",
                     "fail_task", "delay_dispatch"]
    drop, delay, kill, ftask, disp = plan.directives
    assert drop.tag == 1 and drop.p == 0.25 and drop.n == 3
    assert delay.pm == "'ver': 0" and delay.ms == 250.0
    assert kill.rank == 1 and kill.at_s == 2.5 and kill.mode == "hang"
    assert ftask.key == "POTRF(k=0)" and ftask.n == 2
    assert disp.ms == 5.0 and disp.p == 0.1


@BOTH
def test_fault_plan_take_counts_and_determinism(pkg):
    f = fi(pkg)
    f.arm("seed=3;drop_frame=tag:ACT,n=2")
    try:
        cf = f.comm_faults(0)
        hits = [cf.frame_action(1, 1, None) for _ in range(5)]
        assert [h is not None for h in hits] == [True, True, False,
                                                False, False]
        f.arm("seed=3;drop_frame=tag:ACT,p=0.5")
        a = [f.comm_faults(1).frame_action(1, 0, None) is not None
             for _ in range(1)]
        b = [f.comm_faults(1).frame_action(1, 0, None) is not None
             for _ in range(1)]
        assert a == b
        # the two packages draw the same seeded stream per rank
        other = fi("jax" if pkg == "port" else "port")
        other.arm("seed=3;drop_frame=tag:ACT,p=0.5")
        try:
            mine, theirs = f.comm_faults(2), other.comm_faults(2)
            assert [mine.frame_action(1, 0, None) is not None
                    for _ in range(32)] == \
                [theirs.frame_action(1, 0, None) is not None
                 for _ in range(32)]
        finally:
            other.disarm()
    finally:
        f.disarm()
    assert not f.ARMED


@BOTH
def test_delay_recv_parsing_and_matching(pkg):
    f = fi(pkg)
    plan = f.FaultPlan("seed=4;delay_recv=tag:DTD,p=0.5,ms=120,rank=1")
    (d,) = plan.directives
    assert d.kind == "delay_recv" and d.tag == 6 and d.ms == 120.0 \
        and d.rank == 1 and d.p == 0.5
    f.arm("seed=4;delay_recv=tag:DTD,n=1,ms=50,rank=1")
    try:
        cf = f.comm_faults(0)
        assert cf is not None and len(cf.recv_dirs) == 1
        assert cf.recv_delay_ms(6, 2, None) is None
        assert cf.recv_delay_ms(6, 1, None) == 50.0
        assert cf.recv_delay_ms(6, 1, None) is None
        assert cf.frame_action(6, 1, None) is None
    finally:
        f.disarm()


@BOTH
def test_delay_recv_reorders_dispatch_on_receive_path(pkg):
    f = fi(pkg)
    f.arm("seed=1;delay_recv=tag:16,n=1,ms=1200")
    try:
        ce0, ce1 = _pair_of_engines(pkg, _port_base(pkg))
        try:
            got = []
            ce1.tag_register(16, lambda src, msg: got.append(msg["i"]))
            time.sleep(0.3)
            ce0.send_am(16, 1, {"i": 1})
            time.sleep(0.1)
            ce0.send_am(16, 1, {"i": 2})
            deadline = time.monotonic() + 6.0
            while len(got) < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert got == [2, 1], got
        finally:
            ce0.fini()
            ce1.fini()
    finally:
        f.disarm()


@BOTH
def test_unarmed_hooks_are_inert(pkg):
    assert fi(pkg).comm_faults(0) is None
    assert fi(pkg).runtime() is None


# ---------------------------------------------------------------------------
# detect: hard close vs silent hang
# ---------------------------------------------------------------------------

def _hang_then_close(pkg, make_pair, attach=None):
    """The reference's two-phase detector check over one transport: a
    muted peer is declared by the heartbeat within 2x the timeout, a
    hard-closed one by EOF within a second."""
    params = P(pkg)
    params.set("comm_peer_timeout_s", 1.0)
    try:
        ce0, ce1 = make_pair()
        errors = []
        ce0.on_error = errors.append
        try:
            for ce in (ce0, ce1):
                ce.add_periodic(ce.heartbeat_tick, 0.25)
                ce.add_periodic(ce.check_peer_timeouts, 0.25)
            if attach is not None:
                attach(ce0, ce1)
            time.sleep(0.8)
            assert not ce0.dead_peers
            t0 = time.monotonic()
            ce1.fault_kill("hang")
            deadline = t0 + 4.0
            while 1 not in ce0.dead_peers and time.monotonic() < deadline:
                time.sleep(0.02)
            dt = time.monotonic() - t0
            assert 1 in ce0.dead_peers, "hung peer never declared dead"
            assert dt <= 2.0 * 1.0 + 0.6, f"detection took {dt:.2f}s"
            assert errors and isinstance(errors[0], PeerFailedError(pkg))
            assert errors[0].rank == 1
            assert errors[0].detector == "heartbeat"
        finally:
            ce0.fini()
            ce1.fini()
        ce0, ce1 = make_pair()
        errors = []
        ce0.on_error = errors.append
        try:
            if attach is not None:
                attach(ce0, ce1)
            time.sleep(0.3)
            t0 = time.monotonic()
            ce1.fault_kill("close")
            deadline = t0 + 3.0
            while 1 not in ce0.dead_peers and time.monotonic() < deadline:
                time.sleep(0.02)
            dt = time.monotonic() - t0
            assert 1 in ce0.dead_peers, "closed peer never declared dead"
            assert dt <= 1.0, f"EOF detection took {dt:.2f}s"
            assert errors and isinstance(errors[0], PeerFailedError(pkg))
        finally:
            ce0.fini()
            ce1.fini()
    finally:
        params.unset("comm_peer_timeout_s")


@PORT
def test_hard_close_vs_silent_hang_detection_latency(pkg):
    _hang_then_close(pkg, lambda: _pair_of_engines(pkg, _port_base(pkg)))


@PORT
def test_silent_hang_detection_threads_transport(pkg):
    SocketCE = M(pkg, "comm.engine").SocketCE
    params = P(pkg)
    params.set("comm_peer_timeout_s", 1.0)
    try:
        base = _port_base(pkg)
        ce0, ce1 = SocketCE(0, 2, base), SocketCE(1, 2, base)
        errors = []
        ce0.on_error = errors.append
        try:
            for _ in range(8):
                ce0.heartbeat_tick()
                ce1.heartbeat_tick()
                time.sleep(0.05)
            ce0.check_peer_timeouts()
            assert not ce0.dead_peers
            t0 = time.monotonic()
            ce1.fault_kill("hang")
            deadline = t0 + 4.0
            while 1 not in ce0.dead_peers and time.monotonic() < deadline:
                ce0.heartbeat_tick()
                ce0.check_peer_timeouts()
                time.sleep(0.05)
            dt = time.monotonic() - t0
            assert 1 in ce0.dead_peers, "hung peer never declared dead"
            assert dt <= 2.0 * 1.0 + 0.6, f"detection took {dt:.2f}s"
            assert errors and isinstance(errors[0], PeerFailedError(pkg))
            assert errors[0].detector == "heartbeat"
        finally:
            ce0.fini()
            ce1.fini()
    finally:
        params.unset("comm_peer_timeout_s")


@BOTH
def test_starved_checker_rebases_instead_of_declaring(pkg):
    CommEngine = M(pkg, "comm.engine").CommEngine
    params = P(pkg)
    params.set("comm_peer_timeout_s", 0.5)
    try:
        ce = CommEngine(0, 2)
        ce._last_heard[1] = time.monotonic() - 10.0
        ce._hb_check_at = time.monotonic() - 10.0
        ce.check_peer_timeouts()
        assert 1 not in ce.dead_peers
        ce._last_heard[1] = time.monotonic() - 10.0
        ce.check_peer_timeouts()
        assert 1 in ce.dead_peers
    finally:
        params.unset("comm_peer_timeout_s")


# ---------------------------------------------------------------------------
# diagnose: the hang autopsy
# ---------------------------------------------------------------------------

@BOTH
def test_autopsy_includes_comm_state(pkg):
    ce0, ce1 = _pair_of_engines(pkg, _port_base(pkg))
    try:
        time.sleep(0.2)
        dbg = ce0.peer_debug()
        assert 1 in dbg and "last_heard_age_s" in dbg[1]
        assert dbg[1]["dead"] is False
    finally:
        ce0.fini()
        ce1.fini()


def _ctx(pkg, **kw):
    Context = M(pkg, "core.context").Context
    return Context(**kw) if pkg == "jax" else Context(device="cpu", **kw)


@BOTH
def test_flightrec_autopsy_names_bundle(pkg, tmp_path):
    """The hang autopsy's text points the reader at the incident bundle
    when the recorder is armed (and dumps it, rate-limited).  Each
    package names its own reader of the bundle."""
    params = P(pkg)
    params.set("flightrec_enabled", 1)
    params.set("flightrec_dir", str(tmp_path))
    try:
        with _ctx(pkg, nb_cores=1) as ctx:
            report = ctx.hang_autopsy()
            assert "flight recorder incident bundle" in report
            assert str(tmp_path) in report
            assert ("trace2chrome.py --merge" if pkg == "jax"
                    else "parsec_tpu_torch.prof.flightrec") in report
            deadline = time.monotonic() + 10
            while ctx._flightrec.incidents < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert ctx._flightrec.incidents == 1
            assert (tmp_path / "rank0.ptt").exists()
            ctx.hang_autopsy()
            time.sleep(0.1)
            assert ctx._flightrec.incidents == 1
    finally:
        params.unset("flightrec_enabled")
        params.unset("flightrec_dir")


@BOTH
def test_hang_autopsy_prints_the_journal_tail(pkg):
    """``journal_autopsy_tail``: the autopsy ends with the last control-
    plane events, clock-aligned (0 drops the section)."""
    params = P(pkg)
    with _ctx(pkg, nb_cores=1) as ctx:
        ctx.journal.emit("retired", pool=77)
        assert "control-plane journal tail" in ctx.hang_autopsy()
        params.set("journal_autopsy_tail", 0)
        try:
            assert "control-plane journal tail" not in ctx.hang_autopsy()
        finally:
            params.unset("journal_autopsy_tail")


# ---------------------------------------------------------------------------
# shm transport: the ring transport's detectors and send-path directives
# ---------------------------------------------------------------------------

def _shm_pair(pkg):
    ShmCE = M(pkg, "comm.shm").ShmCE
    base = _port_base(pkg)
    return ShmCE(0, 2, base), ShmCE(1, 2, base)


def _shm_attach(ce0, ce1):
    # heartbeats only beat attached rings; a real run attaches at the
    # first activation
    ce0.send_am(13, 1, None)
    ce1.send_am(13, 0, None)


@PORT
def test_shm_hard_close_vs_silent_hang_detection(pkg):
    _hang_then_close(pkg, lambda: _shm_pair(pkg), attach=_shm_attach)


@BOTH
def test_shm_frame_directives_hook_send_path(pkg):
    f = fi(pkg)
    f.arm("seed=5;drop_frame=tag:ACT,n=1;delay_frame=tag:DTD,n=1,ms=300")
    try:
        ce0, ce1 = _shm_pair(pkg)
        got = []
        dropped = []
        ce0.on_frame_fault = lambda kind, tag, p, dst=-1: dropped.append(
            (kind, tag))
        ce1.tag_register(1, lambda src, p: got.append(("act", p)))
        ce1.tag_register(6, lambda src, p: got.append(("dtd", p)))
        try:
            t0 = time.monotonic()
            ce0.send_am(1, 1, {"n": 1})
            ce0.send_am(6, 1, {"n": 2})
            while len(got) < 1 and time.monotonic() - t0 < 5:
                time.sleep(0.02)
            dt = time.monotonic() - t0
            assert got and got[0][0] == "dtd"
            assert dt >= 0.25, f"delayed frame arrived after {dt:.3f}s"
            assert ("drop", 1) in dropped
            time.sleep(0.2)
            assert all(k != "act" for k, _ in got), "dropped frame arrived"
        finally:
            ce0.fini()
            ce1.fini()
    finally:
        f.disarm()
