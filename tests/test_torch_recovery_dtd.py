"""The recovery plane's DTD half, elastic rejoin and the job service's
recovery notices, on the CPU, in one process, on both packages.

Twins of the in-process cases of tests/test_recovery.py that the port's
recovery plane gained with the DTD skip agreement, the rejoin lane and
the service notices: the skip-prefix planner on hand-built write ladders,
the pool-level skip replay (ghost prefix, holder seed, tid-gated filter),
the pool-side full votes, the coordinator's and participant's skip
rounds, the service's degraded -> recovering -> healthy transitions, the
single ``job_done`` of a re-fired completion, and the rejoined
incarnation passing the frame fence.  Each case runs the same seeded
inputs through both packages and compares what they return (the agreed
prefix, holders and version cuts, the replayed values, the service
states), besides the reference test's own assertions.  The port's
Contexts run on ``device="cpu"``.  The multi-process kill and rejoin
runs are in tests/test_torch_recovery_dtd_kill.py.
"""

import importlib
import threading
import time
import types

import numpy as np
import pytest
import torch

PKGS = ("jax", "port")


def M(pkg, name):
    return importlib.import_module(
        ("parsec_tpu." if pkg == "jax" else "parsec_tpu_torch.") + name)


def P(pkg):
    return M(pkg, "utils.mca").params


def ctx_of(pkg, **kw):
    Context = M(pkg, "core.context").Context
    return Context(**kw) if pkg == "jax" else Context(device="cpu", **kw)


def val(payload):
    if isinstance(payload, torch.Tensor):
        return payload.detach().to("cpu", torch.float32).numpy()
    return np.asarray(payload, np.float32)


def both(fn):
    """``fn(pkg)`` on each package: {pkg: result}."""
    return {pkg: fn(pkg) for pkg in PKGS}


def same(res):
    """The two packages' results, which must be equal."""
    assert res["jax"] == res["port"], res
    return res["port"]


class _Recovery:
    def __init__(self, pkg):
        self.params = P(pkg)

    def __enter__(self):
        self.params.set("recovery_enable", 1)
        return self

    def __exit__(self, *exc):
        self.params.unset("recovery_enable")
        return False


# ---------------------------------------------------------------------------
# the pure prefix planner on hand-built write ladders
# ---------------------------------------------------------------------------

#: a 10-insert single-tile chain: insert i writes version i+1
_LADDER = [(i, "t") for i in range(10)]
_AB = [(0, "a"), (1, "b"), (2, "a"), (3, "b")]

#: test_dtd_skip_prefix_* of the reference: (frontiers, landed, writes,
#: expected (K, holders, vcut))
SKIP_PREFIX_CASES = {
    "full_prefix": ({0: 10, 2: 10}, {0: {"t": 10}, 2: {"t": 4}}, _LADDER,
                    (10, {"t": 0}, {"t": 10})),
    "cuts_to_held_version": ({0: 8, 2: 40}, {0: {"t": 6}, 2: {"t": 3}},
                             _LADDER, (6, {"t": 0}, {"t": 6})),
    "cuts_to_lower_holder": ({0: 8, 2: 40}, {0: {"t": 0}, 2: {"t": 3}},
                             _LADDER, (3, {"t": 2}, {"t": 3})),
    "no_holder_falls_back": ({0: 10, 2: 10}, {0: {}, 2: {}}, _LADDER,
                             (0, {}, {})),
    "unwritten_tiles_need_no_holder": (
        {0: 5, 1: 5}, {0: {"a": 2, "b": 7}, 1: {}}, [(0, "a"), (1, "a")],
        (5, {"a": 0}, {"a": 2})),
    "multi_tile_intersection": (
        {0: 4, 1: 4}, {0: {"a": 2, "b": 1}, 1: {"a": 1, "b": 2}}, _AB,
        (4, {"a": 0, "b": 1}, {"a": 2, "b": 2})),
    "multi_tile_cut_drops": (
        {0: 4, 1: 4}, {0: {"a": 2, "b": 1}, 1: {"a": 1, "b": 1}}, _AB,
        (3, {"a": 0, "b": 0}, {"a": 2, "b": 1})),
}


@pytest.mark.parametrize("case", sorted(SKIP_PREFIX_CASES))
def test_dtd_skip_prefix(case):
    frontiers, landed, writes, want = SKIP_PREFIX_CASES[case]
    got = same(both(lambda pkg: M(pkg, "core.recovery").dtd_skip_prefix(
        frontiers, landed, writes)))
    assert got == want


# ---------------------------------------------------------------------------
# pool-level skip replay and the pool-side full votes
# ---------------------------------------------------------------------------

def _dtd_chain_pool(pkg, ctx, steps=10):
    V = M(pkg, "data.matrix").VectorTwoDimCyclic(mb=4, lm=4, nodes=1,
                                                 myrank=0, name="Vsk")
    V.data_of(0).copy_on(0).payload[:] = 0.0
    dtd = M(pkg, "dsl.dtd")
    tp = dtd.DTDTaskpool("skiptest")
    tp.recovery_collections = [V]
    ctx.add_taskpool(tp)
    ctx.start()
    t = tp.tile_of(V, 0)

    def step(T):
        return T + 1.0
    for _ in range(steps):
        tp.insert_task(step, (t, dtd.INOUT))
    tp.wait(timeout=30)
    return V, tp, t, step


def _skip_replay(pkg):
    TaskpoolState = M(pkg, "core.taskpool").TaskpoolState
    TermdetState = M(pkg, "core.termdet").TermdetState
    INOUT = M(pkg, "dsl.dtd").INOUT
    seed = np.full(4, 6.0, np.float32)
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            V, tp, t, step = _dtd_chain_pool(pkg, ctx, steps=10)
            assert tp._lineage is not None
            rep = tp.dtd_skip_report()
            wire = t.wire_key
            before = (rep.get("full"), rep["frontier"], rep["landed"])
            # drive the restart shape _restart_pool uses
            tp.state = TaskpoolState.ATTACHED
            tp.run_epoch += 1
            assert tp.termdet.taskpool_reset(tp, force_terminated=True) \
                == TermdetState.TERMINATED
            with ctx._lock:
                ctx._active_taskpools += 1
            tp._done_event.clear()
            tp.termdet.taskpool_addto_runtime_actions(tp, 1)
            tp.recovery_reset()
            tp.dtd_arm_skip(6, {wire: 0},
                            {wire: seed if pkg == "jax"
                             else torch.from_numpy(seed.copy())},
                            {wire: 6})
            t2 = tp.tile_of(V, 0)
            for _ in range(10):
                tp.insert_task(step, (t2, INOUT))
            tp.dtd_skip_finish()
            tp.ready()
            assert tp.wait_local(30)
            final = val(V.data_of(0).pull_to_host().payload).tolist()
            # one skip per generation: the next death votes full
            return (before, final, sorted(tp._pos_done),
                    tp.dtd_skip_report().get("full"))
        finally:
            ctx.fini()


def test_dtd_skip_replay_ghosts_prefix_and_seeds_holder():
    """Arm a skip at K=6 with this rank the holder of the seeded v6 cut:
    the replay ghost-tracks 6 inserts (versions advance, no body runs),
    the finalize seeds the cut payload, and exactly the 4 post-prefix
    bodies re-run to the exact final value."""
    res = both(_skip_replay)
    (full, frontier, landed), final, done, again = res["port"]
    assert full is None and frontier == 10
    assert list(landed.values()) == [10]
    assert final == [10.0] * 4
    assert done == [6, 7, 8, 9]            # the prefix was ghosted
    assert again == "skip already replayed this generation"
    same(res)


def _unskippable_votes(pkg):
    dtd = M(pkg, "dsl.dtd")
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            V = M(pkg, "data.matrix").VectorTwoDimCyclic(
                mb=4, lm=4, nodes=1, myrank=0, name="Vrl")
            tp = dtd.DTDTaskpool("regions")
            tp.recovery_collections = [V]
            ctx.add_taskpool(tp)
            ctx.start()
            t = tp.tile_of(V, 0)
            tp.insert_task(lambda T: None,
                           (t, dtd.INPUT | dtd.Region("u", (slice(0, 2),))))
            tp.wait(timeout=30)
            regions = tp.dtd_skip_report()["full"]
            tp2 = dtd.DTDTaskpool("news")
            tp2.recovery_collections = [V]
            ctx.add_taskpool(tp2)
            tn = tp2.tile_new((4,))
            tp2.insert_task(lambda T: T + 1.0, (tn, dtd.INOUT))
            tp2.wait(timeout=30)
            return regions, tp2.dtd_skip_report()["full"]
        finally:
            ctx.fini()


def test_dtd_skip_report_votes_full_on_unskippable_pools():
    """Region lanes and tile_new wire keys latch the pool unskippable
    (the report votes full instead of planning from partial evidence);
    the port's lanes write back only their own extent, and still latch."""
    regions, news = same(both(_unskippable_votes))
    assert regions == "region lanes"
    assert "tile_new" in news


# ---------------------------------------------------------------------------
# the skip rounds over TAG_RECOVER (stubbed wire)
# ---------------------------------------------------------------------------

def _stub_rde(rank, peers, sent):
    ce = types.SimpleNamespace(
        rank=rank, nranks=max([rank] + list(peers)) + 1,
        dead_peers=set(),
        send_am=lambda tag, dst, payload: sent.append((dst, payload)))
    return types.SimpleNamespace(
        ce=ce, _live_peers=lambda: list(peers),
        recovery_coordinator=lambda: min([rank] + list(peers)))


def _round(pkg, kind):
    RecoveryUnsupported = M(pkg, "core.recovery").RecoveryUnsupported
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            _V, tp, t, _step = _dtd_chain_pool(pkg, ctx, steps=10)
            rec = ctx.recovery
            sent = []
            wire = t.wire_key
            spec = {"tp": tp, "collections": tp.recovery_collections,
                    "replay": lambda tp: None}
            if kind == "coordinator":
                rec._rde = _stub_rde(0, [2], sent)
                with rec._ctl_cond:
                    rec._skip_reports[(tp.taskpool_id, 2)] = \
                        (0, {"frontier": 6, "landed": {wire: 4}})
                    # rank 3 rejoined mid-round: its unsolicited report
                    # must not join the quorum (not in the peer snapshot)
                    rec._skip_reports[(tp.taskpool_id, 3)] = \
                        (0, {"frontier": 1, "landed": {}})
                skip = rec._plan_dtd_skip(tp, spec, {1})
                return ({"prefix": skip["prefix"],
                         "holders": list(skip["holders"].values()),
                         "vcut": list(skip["vcut"].values()),
                         "seeds": len(skip["seeds"])},
                        [(d, m["k"], m["prefix"]) for d, m in sent])
            if kind == "peer_full_vote":
                rec._rde = _stub_rde(0, [2], sent)
                with rec._ctl_cond:
                    rec._skip_reports[(tp.taskpool_id, 2)] = \
                        (0, {"full": "evicted ring"})
                with pytest.raises(RecoveryUnsupported) as ei:
                    rec._plan_dtd_skip(tp, spec, {1})
                return (str(ei.value),
                        [(d, m["k"], m["prefix"]) for d, m in sent])
            # participant whose coordinator never broadcasts
            rec._rde = _stub_rde(2, [0], sent)
            rec.agree_timeout = 0.2
            t0 = time.monotonic()
            with pytest.raises(RecoveryUnsupported) as ei:
                rec._plan_dtd_skip(tp, spec, {1})
            waited = time.monotonic() - t0
            return (str(ei.value), waited < 2.0,
                    [(d, m["k"], m.get("frontier")) for d, m in sent])
        finally:
            ctx.fini()


def test_dtd_skip_round_coordinator_cuts_and_broadcasts():
    """Coordinator side: a pre-delivered peer report (divergent frontier)
    cuts the prefix at rank 2's held v4 (not its frontier 6); a report
    from a rank outside the round's peer snapshot is ignored; the agreed
    prefix goes to the round's peers only."""
    skip, sent = same(both(lambda pkg: _round(pkg, "coordinator")))
    assert skip == {"prefix": 4, "holders": [2], "vcut": [4], "seeds": 0}
    assert sent == [(2, "skipset", 4)]


def test_dtd_skip_round_peer_full_vote_converges_gang():
    """A survivor that votes full: the coordinator broadcasts prefix 0
    (the gang falls back fast) and takes the full replay itself."""
    why, sent = same(both(lambda pkg: _round(pkg, "peer_full_vote")))
    assert "voted full" in why
    assert sent == [(2, "skipset", 0)]


def test_dtd_skip_round_participant_timeout_falls_back():
    """A participant whose coordinator never broadcasts: the bounded wait
    expires into the full-replay fallback, after its report went out."""
    why, quick, sent = same(both(lambda pkg: _round(pkg, "participant")))
    assert "never arrived" in why and quick
    assert sent == [(0, "skipf", 10)]


# ---------------------------------------------------------------------------
# the job service's recovery notices
# ---------------------------------------------------------------------------

def _service(pkg, **kw):
    JobService = M(pkg, "service.service").JobService
    return JobService(**kw) if pkg == "jax" else \
        JobService(device="cpu", **kw)


def _transitions(pkg):
    svc = _service(pkg, max_active=1, nb_cores=1)
    keys = ("degraded", "degraded_ranks", "recovering", "recovering_ranks")
    seen = []
    try:
        seen.append({k: svc.stats()[k] for k in keys})
        for event, rank in (("start", 1), ("done", 1), ("start", 2),
                            ("failed", 2), ("rejoin", 2)):
            svc.note_recovery(event, rank)
            seen.append({k: svc.stats()[k] for k in keys})
    finally:
        svc.shutdown(timeout=10)
    return seen


def test_service_recovery_state_transitions():
    seen = same(both(_transitions))
    assert seen[0]["recovering"] is False
    assert seen[1] == {"degraded": True, "degraded_ranks": [1],
                       "recovering": True, "recovering_ranks": [1]}
    assert not seen[2]["degraded"] and not seen[2]["recovering"]
    # a failed recovery leaves the degradation standing ...
    assert seen[4]["degraded_ranks"] == [2] and not seen[4]["recovering"]
    # ... until the rank rejoins
    assert seen[5]["degraded"] is False


def _refired(pkg):
    Taskpool = M(pkg, "core.taskpool").Taskpool
    svc = _service(pkg, max_active=1, nb_cores=1)
    try:
        events = []
        svc.context.pins_register(
            "job_done", lambda es, ev, job: events.append(job.job_id))
        job = svc.submit(lambda: Taskpool("j1"), name="j1")
        assert job.wait(10)
        deadline = time.monotonic() + 5
        while not events and time.monotonic() < deadline:
            time.sleep(0.01)
        first = list(events)
        # the recovery restart re-fires the pool's completion path
        svc._finish(job)
        svc._finish(job)
        time.sleep(0.05)
        return first == [job.job_id], events == [job.job_id]
    finally:
        svc.shutdown(timeout=10)


def test_refired_completion_emits_exactly_one_job_done():
    """A recovery restart re-firing a completed pool's termination
    callbacks is absorbed below the service: exactly ONE job_done."""
    assert same(both(_refired)) == (True, True)


def _service_heals_through_plane(pkg):
    """The recovery plane's notices reach an attached service: its
    start -> done / rejoin transitions move the service's state."""
    with _Recovery(pkg):
        svc = _service(pkg, max_active=1, nb_cores=1)
        try:
            rec = svc.context.recovery
            out = []
            for event in ("start", "done", "start", "rejoin"):
                rec._notify_services(event, 1)
                out.append(svc.stats()["degraded"])
            svc.shutdown(timeout=10)
            rec._notify_services("start", 1)      # detached: unseen
            out.append(svc.stats()["degraded"])
            return out
        finally:
            svc.shutdown(timeout=10)


def test_service_attached_to_the_recovery_plane_heals():
    """The port's fault this slice repairs: a JobService on a
    recovery-enabled Context attaches to the plane, so a recovery that
    completes (or a rank that rejoins) clears its degraded state."""
    assert same(both(_service_heals_through_plane)) == \
        [True, False, True, False, False]


# ---------------------------------------------------------------------------
# the rejoined incarnation passes the frame fence
# ---------------------------------------------------------------------------

def _epoch_fence(pkg):
    ce = M(pkg, "comm.engine").SocketCE(
        0, 2, M(pkg, "comm.launch")._probe_port_base(2))
    ctx = ctx_of(pkg, nb_cores=1, rank=0, nranks=2)
    rde = M(pkg, "comm.remote_dep").RemoteDepEngine(ce, ctx)
    try:
        with rde._term_lock:
            rde._sent_to[1] = 3
            rde._recv_from[1] = 2
            rde._app_sent += 3
            rde._app_recv += 2
        rde.recovery_reconcile(1)
        out = [rde._balance(), rde.peer_fence(1)]
        # a pre-death straggler (no _ep) is fenced WITHOUT a credit
        rde._activate_cb(1, {"tp": 999, "_fid": (1, 7)})
        with rde._dlock:
            out += [rde._balance(), len(rde._delayed)]
        # the rejoined incarnation (epoch 1) passes the fence
        rde.note_peer_epoch(1, 1)
        rde._activate_cb(1, {"tp": 999, "_ep": 1, "_fid": (1, 1 << 48)})
        with rde._term_lock:
            out.append(rde._app_recv)
        with rde._dlock:
            out.append(len(rde._delayed))    # parked for the unknown pool
            rde._delayed.clear()             # stop the retry timer chain
        return out
    finally:
        ce._stop = True
        rde.fini()
        ctx.fini()


def test_epoch_fence_passes_rejoined_incarnation():
    """The rejoin half of test_epoch_fence_drops_stale_incarnation_frames:
    after the reconcile the dead incarnation's straggler is fenced with no
    credit and not parked, and a frame stamped with the rejoined
    incarnation's epoch is credited and parked for its unknown pool."""
    assert same(both(_epoch_fence)) == [0, 1, 0, 0, 1, 1]


def test_rejoin_request_validates_epoch_and_heals():
    """The survivor's side of the TAG_REJOIN handshake, on a stubbed
    engine: an epoch below the fence is denied; the fence's epoch is
    acknowledged with the translation table, clears the dead mark,
    counts one rejoin and heals an attached service."""
    def run(pkg):
        with _Recovery(pkg):
            ctx = ctx_of(pkg, nb_cores=1, rank=0, nranks=3)
            try:
                rec = ctx.recovery
                notes = []
                svc = types.SimpleNamespace(
                    note_recovery=lambda e, r: notes.append((e, r)))
                rec.attach_service(svc)
                fences = {2: 1}
                ce = types.SimpleNamespace(
                    rank=0, dead_peers={2}, excused_peers={2},
                    _bar_cond=threading.Condition(),
                    _bar_gen=5, peer_rejoined=lambda r, e:
                    ce.dead_peers.discard(r))
                epochs = {}
                rec._rde = types.SimpleNamespace(
                    ce=ce, peer_fence=lambda r: fences.get(r, 0),
                    note_peer_epoch=lambda r, e: epochs.update({r: e}))
                with rec._lock:
                    rec._dead_map[2] = 1
                denied = rec.on_rejoin_request(2, {"epoch": 0})
                ack = rec.on_rejoin_request(2, {"epoch": 1})
                return (denied, ack, sorted(ce.dead_peers), epochs,
                        rec.rejoins, notes, rec.stats()["rejoins"])
            finally:
                ctx.fini()
    denied, ack, dead, epochs, n, notes, st = same(both(run))
    assert denied is None
    assert ack == {"k": "ack", "epoch": 1, "rank": 0, "translation": {},
                   "bar_gen": 5}
    assert dead == [] and epochs == {2: 1} and n == 1 and st == 1
    assert notes == [("rejoin", 2)]
