"""The port's serving fabric (service/fabric.py) and its auditor
(tools/journal_audit.py): twins of tests/test_fabric.py and of the
fabric cases of tests/test_health.py, on both packages.

* The carver cases replay one lease script through both packages'
  ``MeshCarver`` and compare every lease, the profile case one
  observation script through both ``FabricProfiles``.
* The tenant cases run one job script on each package's fabric — the
  JAX package on its 8-device CPU mesh, the port on ``device="cpu:8"`` —
  and compare what they observe; each journal audits clean under both
  auditors.
* The audit cases feed the same journal events to the JAX package's
  ``tools/journal_audit.audit`` and to the port's copy and compare the
  violation lists (the F1-F3 corpus of test_fabric.py and the H1 corpus
  of test_health.py).

Steady by construction: where the JAX package's tests lean on the wall
clock (tenants co-running, a preemption or a device death landing
mid-run), a task body waits — bounded — on the state it needs.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg.api as jax_ptg
import parsec_tpu.service.fabric as jax_fabric
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg.api as port_ptg
import parsec_tpu_torch.service.fabric as port_fabric
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.tools import journal_audit as port_audit
from parsec_tpu_torch.utils.mca import params as port_params

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools import journal_audit as jax_audit  # noqa: E402

#: bound on every gated wait, seconds
GATE_S = 30.0


class Side:
    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.fabric = jax_fabric if jax else port_fabric
        self.ptg = jax_ptg if jax else port_ptg
        self.matrix = jax_matrix if jax else port_matrix
        self.params = jax_params if jax else port_params
        self.kw = {} if jax else {"device": "cpu:8"}
        #: the device incarnation each package binds
        self.dev = "tpu" if jax else "cuda"

    def serve(self, **kw):
        return self.fabric.ServingFabric(**kw, **self.kw)


SIDES = [Side("jax"), Side("port")]


def _until(pred, timeout=GATE_S):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def _fab_chain(side, nt, name="chain", device=None, hold=None):
    """Job factory: own 1-tile collection + nt-deep increment chain;
    result() is the final tile value (== nt when every task ran —
    including after a preempt-then-resume restart, which re-runs the
    factory and rebuilds the collection from zero).  ``hold=(k, pred)``:
    task k waits (bounded) until ``pred()`` holds."""
    P = side.ptg

    def factory():
        A = side.matrix.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
        A.data_of(0, 0).copy_on(0).payload[:] = 0.0

        def body(T, k):
            if hold is not None and k == hold[0]:
                _until(hold[1])
            return T + 1.0

        p = P.PTG(name, NT=nt)
        tb = p.task("S", k=P.Range(0, nt - 1)) \
            .affinity(lambda k, A=A: A(0, 0)) \
            .flow("T", "RW",
                  P.IN(P.DATA(lambda A=A: A(0, 0)), when=lambda k: k == 0),
                  P.IN(P.TASK("S", "T", lambda k: dict(k=k - 1)),
                       when=lambda k: k > 0),
                  P.OUT(P.TASK("S", "T", lambda k, NT=nt: dict(k=k + 1)),
                        when=lambda k, NT=nt: k < NT - 1),
                  P.OUT(P.DATA(lambda A=A: A(0, 0)),
                        when=lambda k, NT=nt: k == NT - 1))
        if device:
            tb.body(lambda T: T + 1.0, device=device)
        else:
            tb.body(body)

        def result():
            return float(np.asarray(
                A.data_of(0, 0).pull_to_host().payload)[0, 0])
        return p.build(), result
    return factory


def _wait_progress(svc, job, min_tasks=1, timeout=GATE_S):
    ok = _until(lambda: job.status().name == "RUNNING" and
                svc.gauges.job_task_counts(job.job_id)["tasks_retired"]
                >= min_tasks, timeout)
    assert ok, f"{job} made no progress"


def _bundle_of(svc):
    return {0: [svc.context.journal.snapshot()]}


def _events(svc, kinds=None):
    evs = svc.context.journal.tail(4096)
    return evs if kinds is None else [e for e in evs if e.get("e") in kinds]


def _audits_clean(svc):
    """The fabric's journal under both auditors: no violation."""
    b = _bundle_of(svc)
    return port_audit.audit(b) == [] and jax_audit.audit(b) == []


def _both(scenario):
    got = {s.name: scenario(s) for s in SIDES}
    assert got["port"] == got["jax"], got
    return got["port"]


# ---------------------------------------------------------------------------
# MeshCarver: one lease script through both carvers
# ---------------------------------------------------------------------------

def _carver_log(side, script):
    """Run ``script(carver, log)`` on a side's carver; the log of every
    call's result, then the final leases, free count and spaces."""
    log = []
    c = script(side.fabric.MeshCarver, log)
    return log + [c.leases(), c.free_count(), c.spaces,
                  round(c.fragmentation(), 6)]


def test_carver_disjoint_leases_and_free_list_reuse():
    def script(MC, log):
        c = MC(range(1, 9))
        a, b, d = c.carve(1, 3), c.carve(2, 3), c.carve(3, 2)
        log += [a, b, d, c.free_count(), c.carve(4, 1), c.carve(1, 1),
                c.release(2), c.carve(5, 3), c.lease(2), c.release(99)]
        return c
    got = _both(lambda s: _carver_log(s, script))
    a, b, d = (set(x) for x in got[:3])
    assert not (a & b) and not (a & d) and not (b & d)
    assert got[3] == 0 and got[4] is None and got[5] is None
    assert set(got[6]) == b and set(got[7]) == b
    assert got[8] == () and got[9] == ()


def test_carver_best_fit_contiguous_and_scattered_fallback():
    def script(MC, log):
        c = MC(range(8))
        c.carve(1, 8)
        c.release(1)
        log.append(c.carve(1, 2))
        c.carve(2, 2)
        c.release(1)
        c.carve(3, 4)
        log.append(c.carve(4, 2))          # best fit: the small hole
        c.release(4)
        c.release(2)
        log.append(c.fragmentation())
        c2 = MC(range(6))
        c2.carve(1, 6)
        c2.release(1)
        for owner, s in ((10, 1), (11, 3), (12, 5)):
            c2._free.discard(s)
            c2._leases[owner] = [s]
        log.append(c2.fragmentation() > 0.5)
        log.append(c2.carve(20, 3))        # scattered fallback
        return c
    got = _both(lambda s: _carver_log(s, script))
    assert got[1] == (0, 1) and got[2] == 0.0 and got[3] is True
    assert got[4] == (0, 2, 4)


def test_carver_grow_shrink_evict():
    def script(MC, log):
        c = MC(range(8))
        c.carve(1, 2)
        log += [c.grow(1, 2), c.lease(1), c.shrink(1, 2), c.lease(1),
                c.evict(1), 1 in c.spaces, c.lease(1), c.evict(5),
                5 in c.spaces, c.shrink(1, 1), c.lease(1)]
        return c
    got = _both(lambda s: _carver_log(s, script))
    assert got[:11] == [(2, 3), (0, 1, 2, 3), (2, 3), (0, 1), 1, False,
                        (0,), None, False, (0,), ()]


# ---------------------------------------------------------------------------
# FabricProfiles: one observation script through both
# ---------------------------------------------------------------------------

def test_profiles_quote_learns_and_scales():
    """Equal quotes to 1e-9 relative (the same dagsim model on the same
    observations)."""
    def run(side):
        p = side.fabric.FabricProfiles()
        out = [p.quote("never-seen", 4)]
        p.observe("a", makespan=8.0, chips=2, totals={"S": 16},
                  means={"S": 1.0})
        out += [p.quote("a", c) for c in (1, 2, 8)]
        p.observe("b", makespan=6.0, chips=2, totals=None, means={})
        out += [p.quote("b", 4), p.quote("b", 1), p.quote("b", 2)]
        p.observe("b", makespan=2.0, chips=2, totals=None, means={})
        out.append(p.quote("b", 2))
        return out
    ref, got = run(SIDES[0]), run(SIDES[1])
    assert got[0] is None and ref[0] is None
    assert got[1:] == pytest.approx(ref[1:], rel=1e-9)
    q1, q2, q8 = got[1:4]
    assert q1 >= q2 >= q8 and 0.8 <= q2 <= 80.0
    assert got[4] == pytest.approx(3.0) and got[5] == pytest.approx(12.0)
    assert got[7] < got[6]


# ---------------------------------------------------------------------------
# the fabric end to end
# ---------------------------------------------------------------------------

def test_fabric_concurrent_tenants_on_disjoint_subsets():
    """Two exclusive tenants on carved disjoint subsets plus a shared
    tenant, co-running: each job's task 1 waits until all three run."""
    def run(side):
        box = []
        all_running = lambda: len(box) == 3 and all(  # noqa: E731
            j.status().name == "RUNNING" for j in box)
        with side.serve(nb_cores=2, max_active=8) as svc:
            assert len(svc._carver.spaces) == 8
            for nm, dv, cl in (("ta", 3, "tenantA"), ("tb", 3, "tenantB"),
                               ("ts", 0, "tenantS")):
                box.append(svc.submit(
                    _fab_chain(side, 40, name=nm, hold=(1, all_running)),
                    devices=dv, client=cl))
            vals = [j.result(timeout=60.0) for j in box]
            places = _events(svc, {"fabric_place"})
            excl = [set(e["devices"]) for e in places
                    if not e.get("shared")]
            return vals, sorted(len(s) for s in excl), \
                not (excl[0] & excl[1]), \
                sum(1 for e in places if e.get("shared")), \
                _audits_clean(svc)
    assert _both(run) == ([40.0] * 3, [3, 3], True, 1, True)


def test_fabric_exclusive_subset_confines_device_execution():
    """The carve stamp reaches best_device: a 1-device tenant's device
    tasks execute only on its leased device."""
    def run(side):
        with side.serve(nb_cores=2, max_active=4) as svc:
            accs = svc.context.device_registry.accelerators
            job = svc.submit(_fab_chain(side, 8, name="pin",
                                        device=side.dev), devices=1)
            val = job.result(timeout=60.0)
            lease = set(_events(svc, {"fabric_place"})[-1]["devices"])
            used = {d.space for d in accs if d.stats.executed_tasks > 0}
            return val, len(accs), len(lease), bool(used) and used <= lease
    assert _both(run) == (8.0, 8, 1, True)


def test_fabric_quote_vs_measured_makespan():
    """A second submission of a profiled app gets a makespan quote in
    the same decade as the measured first run."""
    def run(side):
        with side.serve(nb_cores=2, max_active=4) as svc:
            first = svc.submit(_fab_chain(side, 25, name="calib"),
                               app="calib")
            v1 = first.result(timeout=60.0)
            measured = first.finished_at - first.started_at
            assert _until(lambda: svc._profiles.quote(
                "calib", svc._chips_shared) is not None, 5.0)
            again = svc.submit(_fab_chain(side, 25, name="calib2"),
                               app="calib", slo=3600.0)
            v2 = again.result(timeout=60.0)
            assert 0.1 * measured <= again.quote_eta <= 10.0 * measured, \
                (side.name, again.quote_eta, measured)
            return v1, v2, again.verdict, any(
                e.get("eta") is not None
                for e in _events(svc, {"fabric_quote"})), \
                _audits_clean(svc)
    assert _both(run) == (25.0, 25.0, "admit", True, True)


def test_fabric_over_slo_policies():
    """An over-SLO quote rejects / deprioritizes / queues per policy,
    with the verdicts journaled and F2 holding."""
    def run(side):
        with side.serve(nb_cores=2, max_active=4) as svc:
            svc._profiles.observe("slowapp", makespan=500.0, chips=1,
                                  totals={"S": 10}, means={"S": 50.0})
            with pytest.raises(side.fabric.AdmissionError):
                svc.submit(_fab_chain(side, 3, name="rej"), app="slowapp",
                           slo=0.5, slo_policy="reject")
            depri = svc.submit(_fab_chain(side, 3, name="dep"),
                               app="slowapp", slo=0.5,
                               slo_policy="deprioritize")
            queued = svc.submit(_fab_chain(side, 3, name="que"),
                                app="slowapp", slo=0.5)
            vals = (depri.result(timeout=60.0), queued.result(timeout=60.0))
            verdicts = sorted({e["verdict"]
                               for e in _events(svc, {"fabric_admit"})})
            return depri.verdict, depri.priority, queued.verdict, vals, \
                verdicts, _audits_clean(svc)
    assert _both(run) == ("deprioritize", -8, "queue", (3.0, 3.0),
                          ["deprioritize", "queue", "reject"], True)


def test_fabric_queue_position():
    def run(side):
        gate = threading.Event()
        with side.serve(nb_cores=2, max_active=1, aging_weight=0.0) as svc:
            busy = svc.submit(_fab_chain(side, 80, name="busy",
                                         hold=(1, gate.is_set)))
            _wait_progress(svc, busy)
            lo = svc.submit(_fab_chain(side, 3, name="lo"), priority=1)
            hi = svc.submit(_fab_chain(side, 3, name="hi"), priority=5)
            pos = [svc.queue_position(j.job_id) for j in (hi, lo, busy)]
            gate.set()
            return pos, [j.result(timeout=60.0) for j in (busy, lo, hi)]
    assert _both(run) == ([0, 1, None], [80.0, 3.0, 3.0])


def test_fabric_preempt_then_resume_roundtrip():
    """A latency-critical tenant preempts a lower-priority resumable
    tenant holding the whole mesh; the victim re-queues, resumes and
    still produces the right answer.  Gated: the victim's task 2 waits
    until it has been preempted once."""
    def run(side):
        box = {}
        with side.serve(nb_cores=2, max_active=4, aging_weight=0.0) as svc:
            nmesh = len(svc._carver.spaces)
            victim = svc.submit(_fab_chain(
                side, 250, name="victim",
                hold=(2, lambda: box["v"].preemptions >= 1)),
                priority=0, devices=nmesh, resumable=True)
            box["v"] = victim
            _wait_progress(svc, victim, min_tasks=2)
            urgent = svc.submit(_fab_chain(side, 5, name="urgent"),
                                priority=10, devices=2, slo=600.0)
            vals = (urgent.result(timeout=60.0),
                    victim.result(timeout=180.0))
            kinds = {e["e"] for e in _events(svc)}
            return nmesh, vals, victim.preemptions, svc.preemptions, \
                {"fabric_preempt", "fabric_resume"} <= kinds, \
                _audits_clean(svc)
    assert _both(run) == (8, (5.0, 250.0), 1, 1, True, True)


def test_fabric_device_death_shrinks_owner_only():
    """Kill a device inside one tenant's carved subset: its subset
    shrinks in place and its job completes on what is left; the other
    tenants are unaffected.  Gated: the owner's task 2 waits until the
    device death was handled."""
    def run(side):
        killed = threading.Event()
        with side.serve(nb_cores=2, max_active=8) as svc:
            a = svc.submit(_fab_chain(side, 120, name="ka",
                                      hold=(2, killed.is_set)),
                           devices=3, client="tenantA")
            b = svc.submit(_fab_chain(side, 30, name="kb"), devices=3,
                           client="tenantB")
            s = svc.submit(_fab_chain(side, 30, name="ks"), devices=0,
                           client="tenantS")
            _wait_progress(svc, a, min_tasks=2)
            before = len(a.devices)
            dead = a.devices[0]
            svc.context.device_registry.get(dead).enabled = False
            owner = svc.device_dead(dead)
            after = (dead in a.devices, len(a.devices))
            killed.set()
            vals = [j.result(timeout=120.0) for j in (a, b, s)]
            resize = [e for e in _events(svc, {"fabric_resize"})
                      if e.get("cause") == "device_dead"]
            return before, owner == a.job_id, after, vals, \
                resize[-1]["delta"], _audits_clean(svc)
    assert _both(run) == (3, True, (False, 2), [120.0, 30.0, 30.0], -1,
                          True)


# ---------------------------------------------------------------------------
# the fabric's health consumption (test_health.py's fabric cases)
# ---------------------------------------------------------------------------

class _FakeMonitor:
    """Stands in for ctx.metrics._health: a scripted peer score the
    fabric's dispatcher tick consumes, journaling the transition the way
    the real monitor does so the decision audits clean."""

    def __init__(self, journal):
        self._journal = journal
        self.ewma = {1: 0.2}
        self._transitioned = set()

    def refresh(self, force=False):
        for r, e in self.ewma.items():
            if e < 0.75 and r not in self._transitioned:
                self._transitioned.add(r)
                self._journal.emit("health_transition", peer=r,
                                   frm="ok", to="critical", score=e)
        return self.snapshot()

    def snapshot(self):
        return {r: {"score": e, "ewma": e, "trend": 0.0, "state": "ok",
                    "since_s": 0.0, "n": 9}
                for r, e in self.ewma.items()}

    def evidence(self, rank, k=8):
        e = self.ewma.get(rank, 1.0)
        return [[0.3, e], [0.1, e]]


def test_fabric_drains_then_undrains_on_scripted_scores():
    def run(side):
        side.params.set("fabric_drain_sustain_s", 0.3)
        try:
            with side.serve(nb_cores=2, max_active=4) as svc:
                fake = _FakeMonitor(svc.context.journal)
                svc.context.metrics._health = fake
                assert svc._health_monitor() is fake
                assert _until(lambda: svc.drains >= 1, 10.0)
                drained = (svc.drains, sorted(svc._health_drained),
                           svc.stats()["fabric"]["drained_ranks"])
                drains = _events(svc, {"health_drain"})
                d = [(e["peer"], e["score"] < e["thr"],
                      bool(e["evidence"])) for e in drains]
                health = svc._gang_health()
                fake.ewma[1] = 0.95
                assert _until(lambda: not svc._health_drained, 10.0)
                undrains = [e["peer"]
                            for e in _events(svc, {"health_undrain"})]
                snap = svc.context.journal.snapshot()
        finally:
            side.params.unset("fabric_drain_sustain_s")
        audits = (port_audit.audit({0: [snap]}),
                  jax_audit.audit({0: [snap]}))
        return drained, d, health, undrains, audits
    assert _both(run) == ((1, [1], [1]), [(1, True, True)], 1.0, [1],
                          ([], []))


def test_fabric_one_bad_fold_does_not_drain():
    """The sustain window: a below-threshold observation starts the
    stopwatch but does not shed the rank; recovery resets it."""
    def run(side):
        side.params.set("fabric_drain_sustain_s", 30.0)
        try:
            with side.serve(nb_cores=2, max_active=4) as svc:
                fake = _FakeMonitor(svc.context.journal)
                svc.context.metrics._health = fake
                started = _until(lambda: 1 in svc._below_since, 10.0)
                drains = svc.drains
                fake.ewma[1] = 0.9
                reset = _until(lambda: 1 not in svc._below_since, 10.0)
                return started, drains, reset, svc.drains
        finally:
            side.params.unset("fabric_drain_sustain_s")
    assert _both(run) == (True, 0, True, 0)


def test_fabric_gang_health_floor_and_disarm():
    def run(side):
        with side.serve(nb_cores=2, max_active=4) as svc:
            fake = _FakeMonitor(svc.context.journal)
            fake.ewma = {0: 1.0, 1: 0.4}
            svc.context.metrics._health = fake
            floor = svc._gang_health()
            svc._health_enable = False
            return floor, svc._gang_health()
    assert _both(run) == (0.4, 1.0)


# ---------------------------------------------------------------------------
# the auditor: one corpus through both
# ---------------------------------------------------------------------------

def _fab_bundle(events):
    out = []
    for i, ev in enumerate(events):
        e = {"t": float(i), "seq": i + 1, "inc": 0}
        e.update(ev)
        out.append(e)
    return {0: [{"rank": 0, "inc": 0, "nranks": 1, "wall": 0.0,
                 "perf": 0.0, "clock": {}, "events": out}]}


def _h1_bundle(events):
    evs = [{"seq": i, "inc": 0, **e} for i, e in enumerate(events)]
    return {0: [{"rank": 0, "inc": 0, "nranks": 2, "clock": {},
                 "events": evs}]}


def _adm(job, verdict="admit"):
    return {"e": "fabric_admit", "job": job, "verdict": verdict}


def _place(job, devices, shared=False, **kw):
    return {"e": "fabric_place", "job": job, "devices": devices,
            "shared": shared, **kw}


def _rel(job, devices, cause):
    return {"e": "fabric_release", "job": job, "devices": devices,
            "cause": cause}


def _trans(t, frm, to, score):
    return {"e": "health_transition", "t": t, "peer": 1, "frm": frm,
            "to": to, "score": score}


def _drain(t, score, evidence):
    return {"e": "health_drain", "t": t, "peer": 1, "score": score,
            "thr": 0.5, "sustain_s": 2.0, "evidence": evidence}


#: (case, bundle, what the violation list must show)
AUDIT_CORPUS = [
    ("clean_fabric_roundtrip", _fab_bundle([
        _adm(1), _place(1, [1, 2]), _adm(2),
        {"e": "fabric_preempt", "job": 1, "by": 2},
        _rel(1, [1, 2], "preempt"), _place(2, [1, 2]),
        _rel(2, [1, 2], "done"), {"e": "job_done", "job": 2,
                                  "status": "done"},
        {"e": "fabric_resume", "job": 1}, _place(1, [1, 2]),
        _rel(1, [1, 2], "done"),
        {"e": "job_done", "job": 1, "status": "done"}]), None),
    ("overlapping_exclusive_subsets", _fab_bundle([
        _adm(1), _adm(2), _place(1, [1, 2]), _place(2, [2, 3])]),
     ("F1", "overlapping")),
    ("shared_placement_never_conflicts", _fab_bundle([
        _adm(1), _adm(2), _place(1, [1, 2]), _place(2, [], True)]), None),
    ("double_placement_without_resume", _fab_bundle([
        _adm(1), _place(1, [1]), _rel(1, [1], "done"), _place(1, [1])]),
     ("F2", "epoch")),
    ("rejected_job_that_placed", _fab_bundle([
        _adm(9, "reject"), _place(9, [1])]), ("F2", "REJECTED")),
    ("unresolved_preemption", _fab_bundle([
        _adm(1), _place(1, [1]), {"e": "fabric_preempt", "job": 1, "by": 2},
        _rel(1, [1], "preempt")]), ("F3", "")),
    ("preemption_resolved_by_job_done", _fab_bundle([
        _adm(1), _place(1, [1]), {"e": "fabric_preempt", "job": 1, "by": 2},
        _rel(1, [1], "preempt"),
        {"e": "job_done", "job": 1, "status": "cancelled"}]), None),
    ("h1_clean_drain_sequence", _h1_bundle([
        _trans(1.0, "ok", "degraded", 0.7),
        _trans(2.0, "degraded", "critical", 0.45),
        _drain(3.0, 0.45, [[0.5, 0.45]]),
        dict(_adm(1), t=3.5), dict(_place(1, [], True, ranks=[0]), t=4.0),
        {"e": "health_undrain", "t": 5.0, "peer": 1, "score": 0.9},
        dict(_adm(2), t=5.5),
        dict(_place(2, [], True, ranks=[0, 1]), t=6.0)]), None),
    ("h1_drain_without_evidence", _h1_bundle([
        _drain(1.0, 0.4, [])]),
     ("H1", "no preceding below-threshold evidence")),
    ("h1_recovered_evidence_does_not_back_a_drain", _h1_bundle([
        _trans(1.0, "ok", "degraded", 0.7),
        _trans(2.0, "degraded", "ok", 0.9), _drain(3.0, 0.4, [])]),
     ("H1", "")),
    ("h1_drain_score_not_below_threshold", _h1_bundle([
        _trans(1.0, "ok", "critical", 0.45),
        _drain(2.0, 0.55, [[0.5, 0.55]])]),
     ("H1", "not below its threshold")),
    ("h1_placement_onto_drained_rank", _h1_bundle([
        _trans(1.0, "ok", "critical", 0.4), _drain(2.0, 0.4, [[0.5, 0.4]]),
        dict(_adm(7), t=2.5),
        dict(_place(7, [], True, ranks=[0, 1]), t=3.0)]),
     ("H1", "placement targets drained rank")),
    ("h1_skips_pre_health_placements", _h1_bundle([
        _trans(1.0, "ok", "critical", 0.4), _drain(2.0, 0.4, [[0.5, 0.4]]),
        dict(_adm(7), t=2.5), dict(_place(7, [], True), t=3.0)]), None),
]


@pytest.mark.parametrize("case,bundle,want", AUDIT_CORPUS,
                         ids=[c[0] for c in AUDIT_CORPUS])
def test_audit_corpus_matches_the_jax_package(case, bundle, want):
    got = port_audit.audit(bundle)
    assert got == jax_audit.audit(bundle)
    if want is None:
        assert got == []
    else:
        inv, text = want
        assert any(v.startswith(inv) and text in v for v in got), got


def test_audit_timeline_and_cli_match_the_jax_package(tmp_path, capsys):
    """The rest of the tool on one bundle: the merged timeline text, and
    the CLI's audit over journal files (exit code 1 on a violation)."""
    _case, bundle, _want = AUDIT_CORPUS[1]
    assert port_audit.render_timeline(bundle) == \
        jax_audit.render_timeline(bundle)
    path = tmp_path / "journal-rank0.jsonl"
    snap = bundle[0][0]
    with open(path, "w") as fh:
        import json
        head = {k: v for k, v in snap.items() if k != "events"}
        fh.write(json.dumps({"h": head}) + "\n")
        for ev in snap["events"]:
            fh.write(json.dumps(ev) + "\n")
    assert port_audit.main([str(tmp_path), "--audit"]) == 1
    port_out = capsys.readouterr().out
    assert jax_audit.main([str(tmp_path), "--audit"]) == 1
    assert port_out == capsys.readouterr().out


def test_shared_jobs_wait_while_the_mesh_is_leased():
    """The port's deliberate difference: a shared job dispatches only
    while some device is unreserved, so on a fully leased mesh (a card
    host with its one card leased) it waits for the lease to be
    released.  The JAX package dispatches it at once."""
    def run(side):
        gate = threading.Event()
        with side.serve(nb_cores=2, max_active=8) as svc:
            nmesh = len(svc._carver.spaces)
            excl = svc.submit(_fab_chain(side, 20, name="excl",
                                         hold=(1, gate.is_set)),
                              devices=nmesh)
            _wait_progress(svc, excl)
            shared = [svc.submit(_fab_chain(side, 4, name=f"s{i}"))
                      for i in range(2)]
            # a few dispatcher ticks with the whole mesh leased
            ticks = _until(lambda: any(j.status().name != "PENDING"
                                       for j in shared), 0.3)
            waiting = [j.status().name for j in shared]
            gate.set()
            vals = [j.result(timeout=60.0) for j in [excl] + shared]
            after = all(j.started_at >= excl.finished_at for j in shared)
            return ticks, waiting, vals, after, _audits_clean(svc)
    ref = run(SIDES[0])
    got = run(SIDES[1])
    assert got == (False, ["PENDING", "PENDING"], [20.0, 4.0, 4.0], True,
                   True)
    # the JAX package ran them beside the lease
    assert ref[0] is True and ref[2] == [20.0, 4.0, 4.0] and ref[4]
