"""The port's recovery plane (core/recovery.py) against the JAX package's,
on the CPU, in one process.

Twins of the in-process cases of tests/test_recovery.py: the lineage and
minimal-replay planners on hand-built DAGs, the need-negotiation rounds,
the retirement handshake, the per-collection rank translation, the
termdet rewind and the run_epoch fence, the dead-rank frame fence with
the Safra reconcile, the pool-generation gate, the degraded-checkpoint
markers, the recorded lineage ring and the incremental checkpoint store,
and the metrics families.  Each case runs once per package (``pkg``) with
the reference test's own assertions; the port's Contexts run on
``device="cpu"``.  The DTD skip agreement, the rejoin and the service's
notices are in tests/test_torch_recovery_dtd.py, the multi-process kill
runs in tests/test_torch_recovery_kill.py and
tests/test_torch_recovery_dtd_kill.py.
"""

import importlib
import time
import types

import numpy as np
import pytest
import torch

PKGS = ["jax", "port"]


def M(pkg, name):
    return importlib.import_module(
        ("parsec_tpu." if pkg == "jax" else "parsec_tpu_torch.") + name)


def P(pkg):
    return M(pkg, "utils.mca").params


def ctx_of(pkg, **kw):
    Context = M(pkg, "core.context").Context
    return Context(**kw) if pkg == "jax" else Context(device="cpu", **kw)


def host(pkg, a):
    a = np.asarray(a, np.float32)
    return a if pkg == "jax" else torch.from_numpy(a.copy())


def val(payload):
    if isinstance(payload, torch.Tensor):
        return payload.detach().to("cpu", torch.float32).numpy()
    return np.asarray(payload, np.float32)


class _Recovery:
    """``recovery_enable`` (and any extra knobs) on one package's params
    for the body of a ``with``."""

    def __init__(self, pkg, **extra):
        self.params = P(pkg)
        self.knobs = {"recovery_enable": 1, **extra}

    def __enter__(self):
        for k, v in self.knobs.items():
            self.params.set(k, v)
        return self

    def __exit__(self, *exc):
        for k in self.knobs:
            self.params.unset(k)
        return False


pytestmark = pytest.mark.parametrize("pkg", PKGS)


# ---------------------------------------------------------------------------
# lineage planner: minimal re-execution set on hand-built DAGs
# ---------------------------------------------------------------------------

def test_lineage_plan_minimal_set(pkg):
    R = M(pkg, "core.recovery")
    log = [
        R.LineageRecord("T1", reads=[("a", 0)], writes=[("b", 1)]),
        R.LineageRecord("T2", reads=[("a", 0)], writes=[("c", 1)]),
        R.LineageRecord("T3", reads=[("b", 1), ("c", 1)],
                        writes=[("d", 1)]),
        R.LineageRecord("T4", reads=[("d", 1)], writes=[("d", 2)]),
    ]
    surviving = {"a": 0, "b": 1, "c": 1}
    tasks, base = R.lineage_plan(log, surviving, {"d": 2})
    assert tasks == ["T3", "T4"]
    assert base == {"b": 1, "c": 1}


def test_lineage_plan_walks_back_to_source(pkg):
    R = M(pkg, "core.recovery")
    log = [
        R.LineageRecord("P0", reads=[("x", 0)], writes=[("x", 1)]),
        R.LineageRecord("P1", reads=[("x", 1)], writes=[("x", 2)]),
    ]
    tasks, base = R.lineage_plan(log, {"x": 0}, {"x": 2})
    assert tasks == ["P0", "P1"]
    assert base == {"x": 0}


def test_lineage_plan_broken_lineage_raises(pkg):
    R = M(pkg, "core.recovery")
    with pytest.raises(R.RecoveryUnsupported):
        R.lineage_plan([], {}, {"ghost": 3})


def _chain_records(R, sent_to_dead=("T0",)):
    return [
        R.LineageRecord("T0", rmap={"C": ("a", 0)}, wmap={"C": ("a", 1)},
                        reads=[("a", 0)], writes=[("a", 1)],
                        dests={1} if "T0" in sent_to_dead else ()),
        R.LineageRecord("T1", rmap={"C": ("a", 1)}, wmap={"C": ("a", 2)},
                        reads=[("a", 1)], writes=[("a", 2)]),
        R.LineageRecord("T2", rmap={"C": ("a", 2)}, wmap={"C": ("a", 3)},
                        reads=[("a", 2)], writes=[("a", 3)]),
        R.LineageRecord("U0", rmap={"B": ("b", 0)}, wmap={"B": ("b", 1)},
                        reads=[("b", 0)], writes=[("b", 1)]),
    ]


_CHAIN_EDGES = {
    "T0": [("desc", "a", 0)],
    "T1": [("task", "T0", "C", "C", "local", False)],
    "T2": [("task", "T1", "C", "C", "local", False)],
    "U0": [("desc", "b", 0)],
}


def test_minimal_plan_matches_analytic_set(pkg):
    R = M(pkg, "core.recovery")
    plan = R.minimal_plan(_chain_records(R), dead_set={1},
                          live={"a": 3, "b": 1},
                          materializable={"a": {0}, "b": {0}},
                          edges=lambda k: _CHAIN_EDGES.get(k, ()))
    assert plan.tasks == {"T0", "T1", "T2"}
    assert plan.base == {"a": 0}
    assert not plan.needs and not plan.synth


def test_minimal_plan_synthesizes_materialized_edges(pkg):
    R = M(pkg, "core.recovery")
    edges = dict(_CHAIN_EDGES)
    edges["P0"] = [("task", "U0", "B", "X", "local", False)]
    plan = R.minimal_plan(_chain_records(R), dead_set={1}, pending=["P0"],
                          live={"a": 3, "b": 1},
                          materializable={"a": {0}, "b": {0}},
                          edges=lambda k: edges.get(k, ()))
    assert "U0" not in plan.tasks and "P0" in plan.tasks
    assert ("P0", "X", "b", 1, "U0") in plan.synth


def test_minimal_plan_checkpoint_bounds_replay_depth(pkg):
    R = M(pkg, "core.recovery")
    edges = dict(_CHAIN_EDGES)
    edges["P1"] = [("task", "T1", "C", "X", "local", False)]
    deep = R.minimal_plan(_chain_records(R, sent_to_dead=()),
                          dead_set={1}, pending=["P1"],
                          live={"a": 3, "b": 1},
                          materializable={"a": {0}, "b": {0}},
                          edges=lambda k: edges.get(k, ()))
    assert {"T0", "T1", "T2"} <= deep.tasks
    shallow = R.minimal_plan(_chain_records(R, sent_to_dead=()),
                             dead_set={1}, pending=["P1"],
                             live={"a": 3, "b": 1},
                             materializable={"a": {0, 2}, "b": {0}},
                             edges=lambda k: edges.get(k, ()))
    assert shallow.tasks == {"P1"}
    assert ("P1", "X", "a", 2, "T1") in shallow.synth


def test_minimal_plan_ring_evicted_falls_back(pkg):
    R = M(pkg, "core.recovery")
    recs = _chain_records(R)[1:]
    with pytest.raises(R.RecoveryUnsupported):
        R.minimal_plan(recs, dead_set={1}, pending=["P2"],
                       live={"a": 3, "b": 1},
                       materializable={"a": {0}, "b": {0}},
                       edges=lambda k:
                       {"P2": [("task", "T0", "C", "X", "local",
                                False)]}.get(k, ()))


def test_minimal_plan_unrecorded_later_writer_falls_back(pkg):
    R = M(pkg, "core.recovery")
    with pytest.raises(R.RecoveryUnsupported):
        R.minimal_plan(_chain_records(R), dead_set={1},
                       live={"a": 9, "b": 1},
                       materializable={"a": {0}, "b": {0}},
                       edges=lambda k: _CHAIN_EDGES.get(k, ()))


def test_minimal_plan_remote_edges_become_needs(pkg):
    R = M(pkg, "core.recovery")
    edges = dict(_CHAIN_EDGES)
    edges["P3"] = [("task", "Q", "C", "Y", ("peer", 2), False)]
    plan = R.minimal_plan(_chain_records(R, sent_to_dead=()),
                          dead_set={1}, pending=["P3"],
                          live={"a": 3, "b": 1},
                          materializable={"a": {0}, "b": {0}},
                          edges=lambda k: edges.get(k, ()))
    assert (2, "P3", "Y") in plan.needs


def test_minimal_plan_synth_drops_when_producer_joins(pkg):
    R = M(pkg, "core.recovery")
    recs = _chain_records(R, sent_to_dead=())
    recs.append(R.LineageRecord("D0", rmap={"B": ("b", 1)},
                                wmap={}, reads=[("b", 1)], dests={1}))
    edges = dict(_CHAIN_EDGES)
    edges["D0"] = [("task", "U0", "B", "X", "local", False)]
    edges["P4"] = [("task", "U0", "B", "X", "local", False),
                   ("desc", "b", 0)]
    plan = R.minimal_plan(recs, dead_set={1}, pending=["P4"],
                          live={"a": 3, "b": 1},
                          materializable={"a": {0}, "b": {0}},
                          edges=lambda k: edges.get(k, ()))
    assert "U0" in plan.tasks
    assert not any(s[4] == "U0" for s in plan.synth)


# ---------------------------------------------------------------------------
# multi-round need negotiation
# ---------------------------------------------------------------------------

def _stub_rde(rank, peers, sent):
    ce = types.SimpleNamespace(
        rank=rank, nranks=max([rank] + list(peers)) + 1,
        dead_peers=set(),
        send_am=lambda tag, dst, payload: sent.append((dst, payload)))
    return types.SimpleNamespace(
        ce=ce, _live_peers=lambda: list(peers),
        recovery_coordinator=lambda: min([rank] + list(peers)))


def _need_round_harness(pkg, ctx, cap):
    rec = ctx.recovery
    rec.need_rounds_cap = cap
    rec.agree_window = 0.01
    rec._rde = _stub_rde(0, [2], [])
    ReplayPlan = M(pkg, "core.recovery").ReplayPlan
    calls = {"negotiated": []}

    def compute(tp, spec, dead_set, extra):
        plan = ReplayPlan()
        plan.tasks = {"A"} | set(extra)
        if not extra:
            with rec._ctl_cond:
                rec._extra_seeds[tp.taskpool_id] = {"B"}
        else:
            plan.needs = [(2, "W", "F")]
        return plan

    def negotiate(tp, needs):
        calls["negotiated"].append(list(needs))
        return True

    rec._compute_minimal = compute
    rec._negotiate_needs = negotiate
    return rec, calls


def test_plan_minimal_second_round_recovers_widened_needs(pkg):
    Taskpool = M(pkg, "core.taskpool").Taskpool
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            rec, calls = _need_round_harness(pkg, ctx, cap=2)
            tp = Taskpool("nr")
            before = dict(rec.need_round_counts)
            plan = rec._plan_minimal(tp, {"tp": tp}, {1})
            assert "B" in plan.tasks
            assert calls["negotiated"] == [[(2, "W", "F")]]
            after = rec.need_round_counts
            assert after["widened"] == before["widened"] + 1
            assert after["acked"] == before["acked"] + 1
            assert after["exhausted"] == before["exhausted"]
            with rec._ctl_cond:
                assert rec._frozen_tasks[tp.taskpool_id] == plan.tasks
        finally:
            ctx.fini()


def test_plan_minimal_round_cap_exhausts_to_full(pkg):
    Taskpool = M(pkg, "core.taskpool").Taskpool
    R = M(pkg, "core.recovery")
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            rec, calls = _need_round_harness(pkg, ctx, cap=0)
            tp = Taskpool("nr0")
            with pytest.raises(R.RecoveryUnsupported,
                               match="recovery_need_rounds"):
                rec._plan_minimal(tp, {"tp": tp}, {1})
            assert rec.need_round_counts["exhausted"] == 1
            assert not calls["negotiated"]
        finally:
            ctx.fini()


def _frozen_need_pool(pkg, ctx):
    T = M(pkg, "core.task")
    ParameterizedTaskpool = M(pkg, "core.taskpool").ParameterizedTaskpool
    V = M(pkg, "data.matrix").VectorTwoDimCyclic(
        mb=2, lm=8, nodes=1, myrank=0, name="Vfn")
    V.set_init(lambda m, n=0: host(pkg, np.zeros(2)))
    tc = T.TaskClass(
        "W", params=[("i", lambda g, l: range(4))],
        affinity=lambda loc, V=V: V(loc["i"]),
        flows=[T.READ("P",
                      inputs=[T.Dep(T.FromTask("W", "T",
                                               lambda loc:
                                               {"i": loc["i"] - 1}),
                                    guard=lambda loc: loc["i"] > 0)]),
               T.RW("T",
                    inputs=[T.Dep(T.FromDesc(lambda loc, V=V:
                                             V(loc["i"])))],
                    outputs=[T.Dep(T.ToTask("W", "P",
                                            lambda loc:
                                            {"i": loc["i"] + 1}),
                                   guard=lambda loc: loc["i"] < 3),
                             T.Dep(T.ToDesc(lambda loc, V=V:
                                            V(loc["i"])))])],
        incarnations=[("cpu", lambda es, task: None)])
    tp = ParameterizedTaskpool("fn")
    tp.add_task_class(tc)
    tp.recovery_collections = [V]
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    return tp, tc


def test_handle_need_acks_frozen_plan_when_covered(pkg):
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            rec = ctx.recovery
            sent = []
            rec._rde = _stub_rde(0, [2], sent)
            tp, _tc = _frozen_need_pool(pkg, ctx)
            tpid = tp.taskpool_id
            with rec._lock:
                rec._active.add(tpid)
            with rec._ctl_cond:
                rec._plan_state[tpid] = "frozen"
                rec._frozen_tasks[tpid] = {("W", 0), ("W", 1)}
            rec._handle_need(2, {"tp": tpid, "needs": [[("W", 1), "P"]]})
            assert sent[-1][1] == {"k": "need_ack", "tp": tpid, "ok": True}
            with rec._ctl_cond:
                rec._frozen_tasks[tpid] = {("W", 5)}
            rec._handle_need(2, {"tp": tpid, "needs": [[("W", 1), "P"]]})
            assert sent[-1][1]["ok"] is False
        finally:
            ctx.fini()


# ---------------------------------------------------------------------------
# completed-pool retirement handshake
# ---------------------------------------------------------------------------

def _two_rank_ctx(pkg):
    """A rank-0-of-2 Context with a threads-transport engine whose sends
    are captured (nothing dials rank 1)."""
    ce = M(pkg, "comm.engine").SocketCE(
        0, 2, M(pkg, "comm.launch")._probe_port_base(2))
    ctx = ctx_of(pkg, nb_cores=1, rank=0, nranks=2)
    rde = M(pkg, "comm.remote_dep").RemoteDepEngine(ce, ctx)
    return ce, ctx, rde


def _close_two_rank(ce, ctx, rde):
    ce._stop = True
    rde.fini()
    ctx.fini()


def test_retirement_handshake_coordinator_quorum(pkg):
    TaskpoolState = M(pkg, "core.taskpool").TaskpoolState
    Taskpool = M(pkg, "core.taskpool").Taskpool
    PeerFailedError = M(pkg, "core.errors").PeerFailedError
    with _Recovery(pkg):
        ce, ctx, rde = _two_rank_ctx(pkg)
        sent = []
        ce.send_am = lambda tag, dst, payload: sent.append((dst, payload))
        try:
            A = M(pkg, "data.matrix").TwoDimBlockCyclic(
                mb=4, nb=4, lm=8, ln=8, nodes=2, myrank=0, name="Aret")
            tp = Taskpool("ret")
            tp.recovery_collections = [A]
            ctx.add_taskpool(tp)
            rec = ctx.recovery
            tp.state = TaskpoolState.DONE
            rec._pool_done(tp)
            assert not tp.retired
            with rec._lock:
                assert rec._specs[tp.taskpool_id]["completed_at"] \
                    is not None
            rec._on_recover_msg(1, {"k": "retire", "tp": tp.taskpool_id})
            assert tp.retired and rec.retirements == 1
            assert any(p.get("k") == "retired" for _d, p in sent)
            handled, leave = rec.on_peer_dead(
                1, PeerFailedError(1, "x", detector="close"), [])
            assert handled and leave == []
            with rec._lock:
                assert tp.taskpool_id not in rec._active
            tp.cancel()
        finally:
            _close_two_rank(ce, ctx, rde)


def test_retirement_broadcast_applies_on_peer(pkg):
    TaskpoolState = M(pkg, "core.taskpool").TaskpoolState
    Taskpool = M(pkg, "core.taskpool").Taskpool
    with _Recovery(pkg):
        ce, ctx, rde = _two_rank_ctx(pkg)
        ce.send_am = lambda tag, dst, payload: None
        try:
            A = M(pkg, "data.matrix").TwoDimBlockCyclic(
                mb=4, nb=4, lm=8, ln=8, nodes=2, myrank=0, name="Bret")
            tp = Taskpool("ret1")
            tp.recovery_collections = [A]
            ctx.add_taskpool(tp)
            rec = ctx.recovery
            tp.state = TaskpoolState.DONE
            with rec._lock:
                rec._active.add(tp.taskpool_id)
            rec._on_recover_msg(0, {"k": "retired", "tp": tp.taskpool_id})
            assert not tp.retired
            with rec._lock:
                rec._active.discard(tp.taskpool_id)
            rec._on_recover_msg(0, {"k": "retired", "tp": tp.taskpool_id})
            assert tp.retired
            tp.cancel()
        finally:
            _close_two_rank(ce, ctx, rde)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _potrf_pool(pkg, name, n=32, mb=16, seed=2):
    A = M(pkg, "data.matrix").TwoDimBlockCyclic(
        mb=mb, nb=mb, lm=n, ln=n, name=name).from_array(
            host(pkg, _spd(n, seed)))
    return A, M(pkg, "apps.potrf").potrf_taskpool(A, device="cpu")


def test_single_rank_pool_retires_at_completion(pkg):
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            _A, tp = _potrf_pool(pkg, "Aret1")
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
            assert tp.retired
            assert ctx.recovery.retirements >= 1
        finally:
            ctx.fini()


def test_retirement_succession_on_coordinator_death(pkg):
    TaskpoolState = M(pkg, "core.taskpool").TaskpoolState
    Taskpool = M(pkg, "core.taskpool").Taskpool
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            A = M(pkg, "data.matrix").TwoDimBlockCyclic(
                mb=4, nb=4, lm=8, ln=8, nodes=3, myrank=1, name="Asucc")
            tp = Taskpool("succ")
            tp.recovery_collections = [A]
            ctx.add_taskpool(tp)
            rec = ctx.recovery
            sent = []
            rec._rde = _stub_rde(1, [0, 2], sent)
            tp.state = TaskpoolState.DONE
            rec._pool_done(tp)
            assert sent and sent[-1] == (0, {"k": "retire",
                                             "tp": tp.taskpool_id})
            assert not tp.retired
            rec._rde = _stub_rde(1, [2], sent)
            rec._rde.ce.dead_peers.add(0)
            rec._succeed_retirements(0)
            assert not tp.retired
            evs = [ev for ev in ctx.journal.tail(256)
                   if ev.get("e") == "retire_succession"]
            assert evs and evs[-1]["pool"] == tp.taskpool_id \
                and evs[-1]["coord"] == 1
            rec._on_recover_msg(2, {"k": "retire", "tp": tp.taskpool_id})
            assert tp.retired and rec.retirements == 1
            assert (2, {"k": "retired", "tp": tp.taskpool_id}) in sent
            tp.cancel()
        finally:
            ctx.fini()


# ---------------------------------------------------------------------------
# partition re-mapping: per-collection rank translation
# ---------------------------------------------------------------------------

def test_rank_translation_adopts_partition(pkg):
    A = M(pkg, "data.matrix").TwoDimBlockCyclic(
        mb=4, nb=4, lm=16, ln=16, nodes=2, myrank=0, name="A")
    mine = set(A.local_tiles())
    assert all(A.rank_of(m, n) == 0 for m, n in mine)
    A.set_rank_translation({1: 0})
    try:
        assert any(A.rank_of(m, n) == 1
                   for m in range(A.mt) for n in range(A.nt))
        assert all(A.owner_of(m, n) == 0
                   for m in range(A.mt) for n in range(A.nt))
        adopted = set(A.local_tiles()) - mine
        assert adopted, "dead rank's tiles must appear local"
        m, n = sorted(adopted)[0]
        assert A.data_of(m, n) is not None
    finally:
        A.set_rank_translation(None)
    assert set(A.local_tiles()) == mine


def test_rank_translation_is_per_collection(pkg):
    TDBC = M(pkg, "data.matrix").TwoDimBlockCyclic
    A = TDBC(mb=4, nb=4, lm=8, ln=8, nodes=2, myrank=0, name="A")
    B = TDBC(mb=4, nb=4, lm=8, ln=8, nodes=2, myrank=0, name="B")
    A.set_rank_translation({1: 0})
    try:
        assert len(A.local_tiles()) == 4
        assert len(B.local_tiles()) == 2
    finally:
        A.set_rank_translation(None)


def test_taskclass_rank_of_translates(pkg):
    A = M(pkg, "data.matrix").TwoDimBlockCyclic(
        mb=4, nb=4, lm=16, ln=16, nodes=2, myrank=0, name="A")
    tc = M(pkg, "core.task").TaskClass(
        "T", params=[("m", lambda g, l: range(4))],
        affinity=lambda loc, A=A: A(0, loc["m"]))
    ranks = {m: tc.rank_of({"m": m}) for m in range(4)}
    assert 1 in ranks.values()
    A.set_rank_translation({1: 0})
    try:
        assert all(tc.rank_of({"m": m}) == 0 for m in range(4))
    finally:
        A.set_rank_translation(None)


# ---------------------------------------------------------------------------
# termdet rewind + run_epoch fence
# ---------------------------------------------------------------------------

def test_termdet_reset_rewinds_without_firing(pkg):
    TD = M(pkg, "core.termdet")
    td = TD.LocalTermdet()
    tp = M(pkg, "core.taskpool").Taskpool("t")
    fired = []
    td.monitor(tp, lambda: fired.append(1))
    td.taskpool_addto_runtime_actions(tp, 1)
    td.taskpool_ready(tp)
    td.taskpool_addto_nb_tasks(tp, 5)
    assert td.taskpool_reset(tp) == TD.TermdetState.BUSY
    assert tp.nb_tasks == 0 and tp.nb_pending_actions == 0
    assert not fired
    td.taskpool_addto_runtime_actions(tp, 1)
    td.taskpool_addto_nb_tasks(tp, 2)
    td.taskpool_ready(tp)
    td.taskpool_addto_runtime_actions(tp, -1)
    td.taskpool_addto_nb_tasks(tp, -2)
    assert fired == [1]
    assert td.taskpool_reset(tp) is None
    assert td.taskpool_reset(tp, force_terminated=True) \
        == TD.TermdetState.TERMINATED


def test_run_epoch_fence_discards_stale_tasks(pkg):
    scheduling = M(pkg, "core.scheduling")
    T = M(pkg, "core.task")
    ctx = ctx_of(pkg, nb_cores=1)
    try:
        tp = M(pkg, "core.taskpool").Taskpool("fence")
        ran = []
        tc = T.TaskClass("X", body=lambda: ran.append(1))
        tp.add_task_class(tc)
        ctx.add_taskpool(tp)
        stale = T.Task(tc, tp, {})
        tp.run_epoch += 1
        before = tp.nb_tasks
        scheduling.task_progress(ctx.streams[0], stale)
        assert not ran
        assert tp.nb_tasks == before
        scheduling.complete_execution(ctx.streams[0], stale)
        assert tp.nb_tasks == before
        tp.cancel()
        ctx.wait(timeout=10)
    finally:
        ctx.fini()


def test_recovery_busy_blocks_quiescence_idle(pkg):
    with _Recovery(pkg):
        ce, ctx, rde = _two_rank_ctx(pkg)
        try:
            rec = ctx.recovery
            assert not rec.busy() and rde._local_idle()
            with rec._lock:
                rec._pending_dead.add(1)
            assert rec.busy()
            assert not rde._local_idle()
            with pytest.raises(TimeoutError):
                rde._wait_recovery_idle(time.monotonic() + 0.1)
            with rec._lock:
                rec._pending_dead.clear()
            assert rde._local_idle()
        finally:
            _close_two_rank(ce, ctx, rde)


def test_stale_body_discard_taints_tile_versions(pkg):
    scheduling = M(pkg, "core.scheduling")
    T = M(pkg, "core.task")
    ctx = ctx_of(pkg, nb_cores=1)
    try:
        A = M(pkg, "data.matrix").TwoDimBlockCyclic(
            mb=4, nb=4, lm=4, ln=4, name="At")
        d = A.data_of(0, 0)
        tp = M(pkg, "core.taskpool").Taskpool("taint")
        tc = T.TaskClass("X", flows=[T.RW("T")], body=lambda T: None)
        tp.add_task_class(tc)
        ctx.add_taskpool(tp)
        stale = T.Task(tc, tp, {})
        stale.data["T"] = d.copy_on(0)
        before = d.newest_version()
        tp.run_epoch += 1
        scheduling.complete_execution(ctx.streams[0], stale)
        assert d.newest_version() > before
        tp.cancel()
        ctx.wait(timeout=10)
    finally:
        ctx.fini()


# ---------------------------------------------------------------------------
# dead-rank frame fence + Safra reconcile, pool-generation gate
# ---------------------------------------------------------------------------

def test_dead_rank_fence_drops_stragglers(pkg):
    """The first half of test_epoch_fence_drops_stale_incarnation_frames
    (its second half is test_torch_recovery_dtd.py's
    ``test_epoch_fence_passes_rejoined_incarnation``): the reconcile
    removes the dead rank's whole contribution, and its straggler is
    fenced with no credit and not parked."""
    ce, ctx, rde = _two_rank_ctx(pkg)
    try:
        with rde._term_lock:
            rde._sent_to[1] = 3
            rde._recv_from[1] = 2
            rde._app_sent += 3
            rde._app_recv += 2
        rde.recovery_reconcile(1)
        assert rde._balance() == 0
        rde._activate_cb(1, {"tp": 999, "_fid": (1, 7)})
        assert rde._balance() == 0
        with rde._dlock:
            assert not rde._delayed
    finally:
        _close_two_rank(ce, ctx, rde)


def test_pool_epoch_gate_drops_and_parks_activations(pkg):
    ce, ctx, rde = _two_rank_ctx(pkg)
    try:
        tp = M(pkg, "core.taskpool").Taskpool("gate")
        ctx.add_taskpool(tp, start=True)
        tp.run_epoch = 2
        base = {"tp": tp.taskpool_id, "root": 1, "ranks": [0],
                "deliveries": {}, "data": None}
        rde._try_activation(1, {**base, "pe": 1})
        with rde._dlock:
            assert not rde._delayed
        rde._try_activation(1, {**base, "pe": 3})
        with rde._dlock:
            assert len(rde._delayed) == 1
        tp.run_epoch = 3
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            rde.retry_delayed()
            with rde._dlock:
                if not rde._delayed:
                    break
            time.sleep(0.02)
        with rde._dlock:
            assert not rde._delayed
        tp.cancel()
    finally:
        _close_two_rank(ce, ctx, rde)


# ---------------------------------------------------------------------------
# checkpoint under a degraded context
# ---------------------------------------------------------------------------

def test_checkpoint_degraded_fails_fast(pkg, tmp_path):
    ck = M(pkg, "utils.checkpoint")
    CheckpointDegradedError = M(pkg, "core.errors").CheckpointDegradedError
    ctx = ctx_of(pkg, nb_cores=1)
    try:
        A = M(pkg, "data.matrix").TwoDimBlockCyclic(
            mb=4, nb=4, lm=8, ln=8, name="A")
        A.data_of(0, 0)
        path = str(tmp_path / "ck")
        ck.checkpoint(ctx, [A], path)
        ctx.comm = types.SimpleNamespace(
            ce=types.SimpleNamespace(dead_peers={1}, excused_peers=set()))
        with pytest.raises(CheckpointDegradedError) as ei:
            ck.checkpoint(ctx, [A], str(tmp_path / "ck2"))
        assert ei.value.ranks == [1]
        with pytest.raises(CheckpointDegradedError):
            ck.restore(ctx, [A], path)
        ctx.comm = None
        ck.restore(ctx, [A], path)
    finally:
        ctx.comm = None
        ctx.fini()


def test_checkpoint_records_excused_marker(pkg, tmp_path):
    ck = M(pkg, "utils.checkpoint")
    ctx = ctx_of(pkg, nb_cores=1)
    try:
        A = M(pkg, "data.matrix").TwoDimBlockCyclic(
            mb=4, nb=4, lm=8, ln=8, name="A")
        A.data_of(0, 0)

        class _BarrierCE:
            dead_peers = {1}
            excused_peers = {1}

            def barrier(self, timeout=60.0):
                pass
        ctx.comm = types.SimpleNamespace(ce=_BarrierCE())
        out = ck.checkpoint(ctx, [A], str(tmp_path / "ck"))
        with np.load(out) as zf:
            assert list(zf["__excused__"]) == [1]
    finally:
        ctx.comm = None
        ctx.fini()


# ---------------------------------------------------------------------------
# lineage recording + the incremental checkpoint plane
# ---------------------------------------------------------------------------

def test_lineage_log_records_completed_tasks(pkg):
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            _A, tp = _potrf_pool(pkg, "Alin")
            ctx.add_taskpool(tp)
            assert tp._lineage is not None
            ctx.wait(timeout=30)
            lin = tp._lineage
            assert not lin.overflow
            assert len(lin.records) == len(lin.completed) > 0
            by_key = {r.key: r for r in lin.records}
            names = {k[0] for k in by_key}
            assert {"POTRF", "TRSM", "SYRK", "POTRFL"} <= names
            rec = by_key[("SYRK", 1, 0)]
            rt, rv = rec.rmap["T"]
            wt, wv = rec.wmap["T"]
            assert rt == wt == ("Alin", 1, 1)
            assert wv > rv
        finally:
            ctx.fini()


def test_tile_checkpoint_store_interval_and_keep(pkg):
    TileCheckpointStore = M(pkg, "utils.checkpoint").TileCheckpointStore
    st = TileCheckpointStore(3600.0, keep=2)
    st.note_write(("a", 0, 0), 1, host(pkg, np.ones(4)))
    st.note_write(("a", 0, 0), 2, host(pkg, np.full(4, 2.0)))
    assert st.versions(("a", 0, 0)) == (1,)
    st2 = TileCheckpointStore(0.0, keep=2)
    for v in (1, 2, 3):
        st2.note_write(("a", 0, 0), v, host(pkg, np.full(4, float(v))))
    assert st2.versions(("a", 0, 0)) == (2, 3)
    np.testing.assert_allclose(val(st2.get(("a", 0, 0), 3)), 3.0)
    assert st2.get(("a", 0, 0), 1) is None


def test_lineage_hook_feeds_checkpoint_store(pkg):
    with _Recovery(pkg, recovery_checkpoint_interval_s=0.0001):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            A, tp = _potrf_pool(pkg, "Ack")
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
            st = ctx.recovery.ckpt
            assert st is not None and st.captures > 0
            key = (id(A), ("Ack", 0, 0))
            vs = st.versions(key)
            assert vs
            assert st.get(key, vs[-1]) is not None
            st.drop_owner(id(A))
            assert st.versions(key) == ()
        finally:
            ctx.fini()


def test_checkpoint_shards_carry_version_stamps(pkg, tmp_path):
    ck = M(pkg, "utils.checkpoint")
    ctx = ctx_of(pkg, nb_cores=1)
    try:
        A = M(pkg, "data.matrix").TwoDimBlockCyclic(
            mb=4, nb=4, lm=8, ln=8, name="Avz")
        d = A.data_of(0, 0)
        d.overwrite_host(host(pkg, np.ones((4, 4))))
        A.data_of(1, 1)
        path = str(tmp_path / "ck")
        ck.checkpoint(ctx, [A], path)
        vs = ck.shard_versions(path, 0)
        assert vs["Avz:0:0"] == d.newest_version()
        assert "Avz:1:1" in vs
        d.overwrite_host(host(pkg, np.zeros((4, 4))))
        ck.restore(ctx, [A], path)
        np.testing.assert_allclose(
            val(A.data_of(0, 0).pull_to_host().payload), 1.0)
    finally:
        ctx.fini()


def test_recovery_metrics_families_scrape(pkg):
    with _Recovery(pkg):
        ctx = ctx_of(pkg, nb_cores=1)
        try:
            assert ctx.recovery is not None
            names = {s["n"] for s in ctx.metrics.samples()}
            for fam in ("parsec_recoveries_total",
                        "parsec_tasks_reexecuted_total",
                        "parsec_rank_rejoins_total",
                        "parsec_recovery_duration_seconds",
                        "parsec_recovery_minimal_replays_total",
                        "parsec_recovery_full_replays_total"):
                assert fam in names
            stages = {s["l"].get("stage")
                      for s in ctx.metrics.samples()
                      if s["n"] == "parsec_recoveries_total"}
            assert {"started", "completed", "failed"} <= stages
        finally:
            ctx.fini()
