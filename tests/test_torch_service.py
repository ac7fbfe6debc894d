"""The port's resident job service (service/{job,service,server}.py):
twins of tests/test_service.py, each running the same job script through
both packages — the JAX package on its 8-device CPU mesh, the port on
``device="cpu"`` — and comparing what they observe, plus a parity case
over the server's app catalog.

Steady by construction: where the JAX package's tests lean on the wall
clock (a late high-priority job overtaking a long one, a deadline
expiring mid-run, a mid-flight cancel), a task body here waits — bounded
— on the state it needs (the other job's pool scheduled, the job
cancelled or timed out) instead of sleeping, so no assertion rests on
timing under load.  Every wait has its own timeout.
"""

import socket
import threading
import time

import numpy as np
import pytest

import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg.api as jax_ptg
import parsec_tpu.prof.aggregator as jax_agg
import parsec_tpu.prof.gauges as jax_gauges
import parsec_tpu.service as jax_service
import parsec_tpu.service.server as jax_server
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg.api as port_ptg
import parsec_tpu_torch.prof.aggregator as port_agg
import parsec_tpu_torch.prof.gauges as port_gauges
import parsec_tpu_torch.service as port_service
import parsec_tpu_torch.service.server as port_server

#: bound on every gated wait inside a task body, seconds
GATE_S = 30.0


class Side:
    """One package's service surface, and the Context kwargs that put it
    on the CPU (the JAX package's tests run on its 8-device CPU mesh)."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.svc = jax_service if jax else port_service
        self.server = jax_server if jax else port_server
        self.ptg = jax_ptg if jax else port_ptg
        self.matrix = jax_matrix if jax else port_matrix
        self.agg = jax_agg if jax else port_agg
        self.gauges = jax_gauges if jax else port_gauges
        self.kw = {} if jax else {"device": "cpu"}

    def service(self, **kw):
        return self.svc.JobService(**kw, **self.kw)


SIDES = [Side("jax"), Side("port")]


def _until(pred, timeout=GATE_S):
    """Bounded wait for ``pred()``; False when it never held."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def _chain_factory(side, nt, name="chain", fail_at=None, hold=None,
                   order=None):
    """A job factory: its own 1-tile collection and an nt-deep increment
    chain over it; result() reads the final tile value (== nt when every
    task ran).  ``hold=(k, pred)``: the body of task k waits (bounded)
    until ``pred()`` holds; ``order``: a list each body appends its
    (name, k) to."""
    P = side.ptg

    def factory():
        A = side.matrix.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
        A.data_of(0, 0).copy_on(0).payload[:] = 0.0

        def body(T, k):
            if hold is not None and k == hold[0]:
                _until(hold[1])
            if order is not None:
                order.append((name, k))
            if fail_at is not None and k == fail_at:
                raise ValueError(f"{name}: injected failure at k={k}")
            return T + 1.0

        p = P.PTG(name, NT=nt)
        p.task("S", k=P.Range(0, nt - 1)) \
            .affinity(lambda k, A=A: A(0, 0)) \
            .flow("T", "RW",
                  P.IN(P.DATA(lambda A=A: A(0, 0)), when=lambda k: k == 0),
                  P.IN(P.TASK("S", "T", lambda k: dict(k=k - 1)),
                       when=lambda k: k > 0),
                  P.OUT(P.TASK("S", "T", lambda k, NT=nt: dict(k=k + 1)),
                        when=lambda k, NT=nt: k < NT - 1),
                  P.OUT(P.DATA(lambda A=A: A(0, 0)),
                        when=lambda k, NT=nt: k == NT - 1)) \
            .body(body)

        def result():
            return float(np.asarray(
                A.data_of(0, 0).copy_on(0).payload)[0, 0])
        return p.build(), result
    return factory


def _wait_progress(svc, job, min_tasks=1, timeout=GATE_S):
    """Bounded wait until the job runs and has retired ``min_tasks``."""
    ok = _until(lambda: job.status().name == "RUNNING" and
                svc.gauges.job_task_counts(job.job_id)["tasks_retired"]
                >= min_tasks, timeout)
    assert ok, f"{job} made no progress"


def _both(scenario):
    """Run ``scenario(side)`` on both packages; the observations must
    agree exactly."""
    got = {s.name: scenario(s) for s in SIDES}
    assert got["port"] == got["jax"], got
    return got["port"]


def test_concurrent_heterogeneous_jobs_complete():
    """N heterogeneous jobs share one warm context; per-job results are
    independent and exact (the chain's value is an exact count)."""
    def run(side):
        lengths = [5, 11, 3, 8, 14]
        with side.service(nb_cores=2, max_active=8) as svc:
            jobs = [svc.submit(_chain_factory(side, nt, name=f"j{i}"),
                               client=f"tenant{i}")
                    for i, nt in enumerate(lengths)]
            vals = [j.result(timeout=60.0) for j in jobs]
            assert all(j.taskpool.context is svc.context for j in jobs)
            return vals, [j.status().name for j in jobs], \
                svc.stats()["total"]
    vals, status, total = _both(run)
    assert vals == [5.0, 11.0, 3.0, 8.0, 14.0]
    assert status == ["DONE"] * 5 and total == 5


def test_priority_inversion_high_job_overtakes():
    """A high-priority job submitted late finishes before a long
    low-priority job drains: job priority rides Taskpool.priority into
    the pbq scheduler's task priorities.  Gated: the low chain's task 2
    waits until the high job's pool is scheduled, so the high chain's
    first task and the low chain's task 3 are ready together; on the one
    worker every high task then runs before low's task 3."""
    def run(side):
        high = {}
        order = []

        def high_scheduled():
            j = high.get("job")
            tp = j.taskpool if j is not None else None
            return tp is not None and tp.state.name in ("RUNNING", "DONE")

        with side.service(nb_cores=1, scheduler="pbq", max_active=4,
                          aging_weight=0.0) as svc:
            low = svc.submit(_chain_factory(side, 60, name="low",
                                            hold=(2, high_scheduled),
                                            order=order),
                             priority=0)
            _wait_progress(svc, low, min_tasks=2)
            high["job"] = svc.submit(_chain_factory(side, 5, name="high",
                                                    order=order),
                                     priority=10)
            hv = high["job"].result(timeout=60.0)
            lv = low.result(timeout=60.0)
            return hv, lv, order[:9], \
                high["job"].finished_at < low.finished_at
    assert _both(run) == (5.0, 60.0, [("low", 0), ("low", 1), ("low", 2)]
                          + [("high", k) for k in range(5)] + [("low", 3)],
                          True)


def test_admission_cap_rejection_and_backpressure():
    def run(side):
        gate = threading.Event()
        AdmissionError = side.svc.AdmissionError
        with side.service(nb_cores=2, max_active=1, max_pending=1) as svc:
            first = svc.submit(_chain_factory(side, 25, name="busy",
                                              hold=(1, gate.is_set)))
            _wait_progress(svc, first)
            queued = svc.submit(_chain_factory(side, 3, name="queued"))
            rejected = []
            # the pending queue is full: immediate rejection...
            with pytest.raises(AdmissionError):
                svc.submit(_chain_factory(side, 3, name="reject"),
                           block=False)
            rejected.append("immediate")
            # ...zero-budget backpressure also rejects...
            with pytest.raises(AdmissionError):
                svc.submit(_chain_factory(side, 3, name="reject2"),
                           block=True, timeout=0.05)
            rejected.append("backpressure")
            # ...but a patient backpressure wait admits once room frees
            gate.set()
            third = svc.submit(_chain_factory(side, 4, name="waited"),
                               block=True, timeout=30.0)
            return rejected, [j.result(timeout=60.0)
                              for j in (first, queued, third)]
    assert _both(run) == (["immediate", "backpressure"], [25.0, 3.0, 4.0])


def test_cancellation_midflight_keeps_context_serving():
    """Gated: the victim's task 3 waits until the victim is cancelled,
    so the cancel always lands mid-flight."""
    def run(side):
        with side.service(nb_cores=2, max_active=4) as svc:
            box = {}
            victim = svc.submit(_chain_factory(
                side, 500, name="victim",
                hold=(3, lambda: box["v"].status().name == "CANCELLED")),
                name="victim")
            box["v"] = victim
            _wait_progress(svc, victim, min_tasks=3)
            took = victim.cancel()
            with pytest.raises(side.svc.JobCancelled):
                victim.result(timeout=10.0)
            quiesced = victim.taskpool.wait_local(timeout=10.0)
            again = victim.cancel()
            after = svc.submit(_chain_factory(side, 6, name="after"))
            return took, victim.status().name, quiesced, again, \
                after.result(timeout=60.0)
    assert _both(run) == (True, "CANCELLED", True, False, 6.0)


def test_pending_job_cancel():
    def run(side):
        gate = threading.Event()
        with side.service(nb_cores=2, max_active=1, max_pending=4) as svc:
            busy = svc.submit(_chain_factory(side, 30, name="busy",
                                             hold=(1, gate.is_set)))
            _wait_progress(svc, busy)
            queued = svc.submit(_chain_factory(side, 3, name="queued"))
            st = queued.status().name
            took = queued.cancel()
            with pytest.raises(side.svc.JobCancelled):
                queued.result(timeout=5.0)
            gate.set()
            return st, took, busy.result(timeout=60.0)
    assert _both(run) == ("PENDING", True, 30.0)


def test_deadline_expiry_cancels_job_not_context():
    """Gated: the slow job's task 1 waits until the job timed out, so
    the deadline always expires mid-run, whatever the load."""
    def run(side):
        with side.service(nb_cores=2, max_active=4) as svc:
            box = {}
            slow = svc.submit(_chain_factory(
                side, 1000, name="slow",
                hold=(1, lambda: box["s"].status().name == "TIMEOUT")),
                deadline=0.3)
            box["s"] = slow
            with pytest.raises(side.svc.JobTimeout):
                slow.result(timeout=30.0)
            quiesced = slow.taskpool.wait_local(timeout=10.0)
            ok = svc.submit(_chain_factory(side, 5, name="ok"))
            return slow.status().name, quiesced, ok.result(timeout=60.0)
    assert _both(run) == ("TIMEOUT", True, 5.0)


def test_failure_isolation_four_concurrent_jobs():
    """>=4 concurrent jobs on one warm Context; one raises, the other
    three complete; the context serves subsequent jobs."""
    def run(side):
        with side.service(nb_cores=2, max_active=8) as svc:
            bad = svc.submit(_chain_factory(side, 10, fail_at=4,
                                            name="bad"))
            good = [svc.submit(_chain_factory(side, nt, name=f"good{nt}"))
                    for nt in (7, 12, 9)]
            vals = [j.result(timeout=60.0) for j in good]
            with pytest.raises(side.svc.JobError) as ei:
                bad.result(timeout=60.0)
            cause = type(ei.value.__cause__).__name__
            poisoned = bool(svc.context._errors)
            late = svc.submit(_chain_factory(side, 4, name="late"))
            return vals, cause, bad.status().name, poisoned, \
                late.result(timeout=60.0)
    assert _both(run) == ([7.0, 12.0, 9.0], "ValueError", "FAILED", False,
                          4.0)


def test_per_job_gauges_via_aggregator():
    """Per-job gauges ride the aggregator path: a GaugePublisher streams
    JobGauges.snapshot() to an Aggregator and the published table carries
    per-job task counts."""
    def run(side):
        with side.service(nb_cores=2, max_active=4) as svc:
            j1 = svc.submit(_chain_factory(side, 9, name="g1"))
            j2 = svc.submit(_chain_factory(side, 4, name="g2"))
            vals = (j1.result(timeout=60.0), j2.result(timeout=60.0))
            agg = side.agg.Aggregator(port=0)
            pub = side.agg.GaugePublisher(svc.gauges, rank=0,
                                          host="127.0.0.1", port=agg.port,
                                          interval=0.05)
            key = f"job{j1.job_id}_tasks_retired"
            try:
                assert _until(lambda: key in agg.table().get(0, {}), 10.0)
                row = agg.table()[0]
            finally:
                pub.close()
                agg.close()
            assert row[f"job{j1.job_id}_wall_ms"] > 0
            return vals, row["jobs_done"] >= 2, row[key], \
                row[f"job{j2.job_id}_tasks_retired"]
    assert _both(run) == ((9.0, 4.0), True, 9, 4)


def test_job_pins_events_tagged_with_job_ids():
    """Job lifecycle emits PINS events carrying the job, and every task
    is attributable to its job via Taskpool.job_id."""
    def run(side):
        events = []
        seen = set()
        with side.service(nb_cores=2, max_active=4) as svc:
            for ev in ("job_submit", "job_start", "job_done"):
                svc.context.pins_register(
                    ev, lambda es, e, job: events.append((e, job.job_id)))
            svc.context.pins_register(
                "complete_exec",
                lambda es, e, task: seen.add(task.taskpool.job_id))
            job = svc.submit(_chain_factory(side, 5, name="tagged"))
            val = job.result(timeout=60.0)
            assert _until(lambda: ("job_done", job.job_id) in events, 10.0)
        return val, events, seen
    val, events, seen = _both(run)
    assert val == 5.0
    assert events == [("job_submit", 1), ("job_start", 1), ("job_done", 1)]
    assert seen == {1}


def test_server_and_client_roundtrip():
    """Socket front end: named app jobs over the framed-JSON wire.  The
    results agree between the packages (stencil norm to 1e-5 relative,
    potrf residual within the JAX package's test tolerance 1e-4)."""
    def run(side):
        service, server = side.server.serve(port=0, nb_cores=2,
                                            max_active=4, **side.kw)
        req = side.server.request
        try:
            h, p = server.host, server.port
            apps = req(h, p, {"op": "apps"})
            sub = req(h, p, {
                "op": "submit", "app": "stencil",
                "params": {"n": 32, "nb": 8, "steps": 3, "device": "cpu"},
                "priority": 1, "client": "pytest"})
            res = req(h, p, {"op": "result", "job": sub["job"],
                             "timeout": 60.0})
            st = req(h, p, {"op": "status", "job": sub["job"]})
            pot = req(h, p, {"op": "submit", "app": "potrf",
                             "params": {"n": 64, "nb": 16,
                                        "device": "cpu"}})
            pres = req(h, p, {"op": "result", "job": pot["job"],
                              "timeout": 60.0})
            stats = req(h, p, {"op": "stats"})
            gz = req(h, p, {"op": "gauges"})
            bad = req(h, p, {"op": "submit", "app": "nope"})
        finally:
            server.close()
            service.shutdown(timeout=30.0)
        assert res["ok"] and pres["ok"], (res, pres)
        assert pres["result"]["residual"] < 1e-4
        return {"apps": apps["apps"], "sub_ok": sub["ok"],
                "stencil": (res["result"]["app"], res["result"]["n"],
                            res["result"]["steps"]),
                "norm": res["result"]["norm"],
                "status": st["info"]["status"],
                "total": stats["stats"]["total"],
                "jobs_done": gz["gauges"]["jobs_done"],
                "bad_ok": bad["ok"]}
    got = {s.name: run(s) for s in SIDES}
    assert got["port"]["norm"] == pytest.approx(got["jax"]["norm"],
                                                rel=1e-5)
    for g in got.values():
        del g["norm"]
    assert got["port"] == got["jax"]
    assert got["port"] == {"apps": ["gemm", "potrf", "stencil"],
                           "sub_ok": True, "stencil": ("stencil", 32, 3),
                           "status": "DONE", "total": 2, "jobs_done": 2,
                           "bad_ok": False}


def test_server_rejects_bad_magic():
    """Garbage magic severs the connection instead of crashing the
    server, which keeps answering."""
    def run(side):
        service, server = side.server.serve(port=0, nb_cores=2, **side.kw)
        try:
            with socket.create_connection((server.host, server.port),
                                          timeout=5.0) as s:
                s.sendall(b"BAD?" + b"\0" * 16)
                s.settimeout(2.0)
                try:
                    eof = s.recv(64) == b""
                except ConnectionResetError:
                    eof = True
            alive = side.server.request(server.host, server.port,
                                        {"op": "apps"})["ok"]
        finally:
            server.close()
            service.shutdown(timeout=10.0)
        return eof, alive
    assert _both(run) == (True, True)


def test_gauges_pending_accounts_discards():
    """Cancellation discards are first-class in the base gauges: pending
    drains to zero even when tasks were dropped.  Gated as the
    mid-flight cancel above."""
    def run(side):
        with side.service(nb_cores=2, max_active=4) as svc:
            g = side.gauges.install_gauges(svc.context)
            box = {}
            victim = svc.submit(_chain_factory(
                side, 400, name="v",
                hold=(2, lambda: box["v"].status().name == "CANCELLED")))
            box["v"] = victim
            _wait_progress(svc, victim, min_tasks=2)
            victim.cancel()
            victim.taskpool.wait_local(timeout=10.0)
            ok = svc.submit(_chain_factory(side, 5, name="ok"))
            val = ok.result(timeout=60.0)
            drained = _until(lambda: g.snapshot()["pending_tasks"] == 0,
                             10.0)
            g.uninstall(svc.context)
            return val, drained
    assert _both(run) == (5.0, True)


# ---------------------------------------------------------------------------
# parity over the app catalog
# ---------------------------------------------------------------------------

#: the catalog's jobs at CPU sizes (the server's own defaults and the
#: JAX package's test sizes), plus a chain job
CATALOG = [("gemm", {"n": 64, "nb": 16, "seed": 3}),
           ("gemm", {"n": 96, "nb": 32, "seed": 4}),
           ("potrf", {"n": 64, "nb": 16, "seed": 5}),
           ("potrf", {"n": 128, "nb": 32, "seed": 6}),
           ("stencil", {"n": 64, "nb": 16, "steps": 5, "seed": 7}),
           ("stencil", {"n": 256, "nb": 64, "steps": 8, "seed": 8})]


@pytest.mark.parametrize("device", ["cpu", "device"])
def test_catalog_jobs_agree_between_packages(device):
    """The same chain, GEMM, potrf and stencil jobs, served by each
    package's JobService, give equal results: the chain value exactly,
    ``fro_norm`` to 1e-5 relative, each potrf residual within the JAX
    package's test tolerance (1e-4), the stencil norm to 1e-5 relative;
    and the same job-status sequence and job_submit/job_done events.
    ``device``: the jobs' own ``device`` param — "cpu" (CPU bodies) or
    each package's device bodies ("tpu" on the JAX package's mesh,
    "cuda" on the port's CPU-backed module)."""
    def run(side):
        dev = "cpu" if device == "cpu" else \
            ("tpu" if side.name == "jax" else "cuda")
        events = []
        with side.service(nb_cores=2, max_active=3) as svc:
            for ev in ("job_submit", "job_done"):
                svc.context.pins_register(
                    ev, lambda es, e, job: events.append(
                        (e, job.job_id, job.status().name)))
            jobs = [svc.submit(_chain_factory(side, 7, name="chain"),
                               name="chain")]
            jobs += [svc.submit(side.server.APPS[app](
                dict(params, device=dev)), name=app)
                for app, params in CATALOG]
            results = [j.result(timeout=120.0) for j in jobs]
            assert _until(lambda: sum(e[0] == "job_done"
                                      for e in events) == len(jobs), 10.0)
            return results, [j.status().name for j in jobs], \
                sorted(events)
    got = {s.name: run(s) for s in SIDES}
    (ref, ref_st, ref_ev), (res, st, ev) = got["jax"], got["port"]
    assert st == ref_st == ["DONE"] * (len(CATALOG) + 1)
    assert ev == ref_ev
    assert res[0] == ref[0] == 7.0
    for r, q, (app, _p) in zip(res[1:], ref[1:], CATALOG):
        assert r["app"] == q["app"] == app and r["n"] == q["n"]
        if app == "gemm":
            assert r["fro_norm"] == pytest.approx(q["fro_norm"], rel=1e-5)
            # the port's own check against the plain product
            assert r["rel_err"] <= 1e-5
        elif app == "potrf":
            assert r["residual"] < 1e-4 and q["residual"] < 1e-4
        else:
            assert r["steps"] == q["steps"]
            assert r["norm"] == pytest.approx(q["norm"], rel=1e-5)
            assert r["max_err"] <= 1e-5


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------

@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")


def test_job_service_and_fabric_run_on_the_card_by_default(no_card):
    """``JobService()`` and ``ServingFabric()`` build their Context on the
    card: with none visible they raise instead of carrying on on the
    CPU."""
    from parsec_tpu_torch.service.fabric import ServingFabric
    for cls in (port_service.JobService, ServingFabric):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(nb_cores=1)


def test_server_cli_refuses_without_a_card(no_card):
    """``python -m parsec_tpu_torch.service.server`` exits non-zero
    without a card, and serves nothing."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-m",
                          "parsec_tpu_torch.service.server", "--port", "0"],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "job server on" not in res.stdout


def test_server_cli_serves_on_the_cpu_backed_module_when_asked():
    """``--mca device cpu`` is the one way onto the CPU: the CLI's
    service then answers an apps request (the CLI is stopped with
    SIGINT, as from a terminal)."""
    import os
    import signal
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "parsec_tpu_torch.service.server", "--port",
         str(port), "--cores", "1", "--mca", "device", "cpu"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert f"job server on 127.0.0.1:{port}" in line, \
            (line, proc.stderr.read() if proc.poll() is not None else "")
        reply = port_server.request("127.0.0.1", port, {"op": "apps"},
                                    timeout=30.0)
        assert reply == {"ok": True, "apps": ["gemm", "potrf", "stencil"]}
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    assert proc.returncode == 0
