"""The port's live attribution plane (prof/liveattr.py): twins of the
single-rank tests of tests/test_liveattr.py, and parity with the JAX
package's engine.

The job server's status op and HTTP GET are twinned on both packages;
tools/live_view and the ETA of a running job are left out; the
online/offline agreement on the traced rtt leg waits for the comm
layer.  The straggler
and split-mode checks of the JAX package run a delayed task on a live
Context and read wall time; their twins here feed the engine synthetic
observations (tasks with a ``ready_at`` set in the past), so no
assertion rests on wall time under load.
"""

import pytest

import parsec_tpu_torch.core.context as port_context
from parsec_tpu_torch.prof import liveattr as la_mod
from parsec_tpu_torch.prof.liveattr import (bucket_quantile, class_totals,
                                            eta_seconds, merge_sections,
                                            telescope)
from parsec_tpu_torch.prof.metrics import render_text
from parsec_tpu_torch.utils.mca import params


def _flat_pool(n, name="flat", ptg=None):
    if ptg is None:
        import parsec_tpu_torch.dsl.ptg as ptg
    p = ptg.PTG(name, NT=n)
    p.task("W", k=ptg.Range(0, n - 1)).body(lambda: None)
    return p.build()


# ---------------------------------------------------------------------------
# unit: profiles / telescoping / merge / ETA
# ---------------------------------------------------------------------------

def test_profile_stream_and_quantiles():
    p = la_mod._Profile(ring=64)
    for i in range(100):
        p.observe(1e-3, alpha=0.2)
    p.observe(1.0, alpha=0.2)
    assert p.n == 101
    assert p.quantile(0.5) == pytest.approx(1e-3)
    assert p.quantile(0.99) in (1e-3, 1.0)
    assert 1e-3 < p.ewma < 1.0          # pulled toward the outlier
    w = p.to_wire()
    assert w["n"] == 101 and sum(w["b"]) == 101
    assert bucket_quantile(w["b"], 0.5) == pytest.approx(
        2.0 ** -10, rel=1.0)


def test_telescope_sums_to_elapsed_and_clamps():
    t = telescope(10.0, 2.0, 1.0, 3.0)
    assert t["idle"] == pytest.approx(4.0)
    assert t["exec"] + t["queue"] + t["comm"] + t["idle"] == \
        pytest.approx(t["elapsed"]) == pytest.approx(10.0)
    t = telescope(10.0, 2.0, 1.0, 100.0)
    assert t["comm"] == pytest.approx(7.0) and t["idle"] == 0.0
    t = telescope(6.0, 6.0, 3.0, 3.0)
    assert t["idle"] == 0.0 and t["comm"] == 0.0
    assert t["exec"] == pytest.approx(4.0)
    assert t["exec"] + t["queue"] == pytest.approx(6.0)
    assert telescope(0.0, 1.0, 1.0, 1.0)["elapsed"] == 0.0


def _sections():
    prof = la_mod._Profile(ring=16)
    for _ in range(10):
        prof.observe(1e-3, alpha=0.2)
    row = {"job": 7, "cls": "GEMM", "done": 10, "sel": 0,
           "t0": 5.0, "t1": 6.0, "lat": prof.to_wire(),
           "queue": None, "exec": None}
    sec_a = {"rank": 0, "recs": [row],
             "strag": [[7, "GEMM", "exec", 2]], "anomalies": [],
             "comm": {"acts": 4.0, "delay_s": 0.5, "per_peer": {}}}
    sec_b = {"rank": 1, "recs": [dict(row, done=5)],
             "strag": [[7, "GEMM", "exec", 1]], "anomalies": [],
             "comm": {"acts": 2.0, "delay_s": 0.5, "per_peer": {}}}
    return {0: sec_a, 1: sec_b}


def test_merge_sections_sums_counts_and_buckets():
    m = merge_sections(_sections())
    rec = m["recs"][(7, "GEMM")]
    assert rec["done"] == 15
    assert rec["lat"]["n"] == 20 and sum(rec["lat"]["b"]) == 20
    assert m["strag"][(7, "GEMM", "exec")] == 3
    assert m["comm_s"] == pytest.approx(6.0)
    assert m["window_s"] == pytest.approx(1.0)
    from parsec_tpu.prof.liveattr import merge_sections as ref_merge
    assert m == ref_merge(_sections())


def test_eta_through_dagsim():
    rows = [{"cls": "A", "pending": 100, "mean_s": 0.01},
            {"cls": "B", "pending": 100, "mean_s": 0.03}]
    eta = eta_seconds(rows, 200, n_chips=4)
    assert 0.9 <= eta <= 1.5
    rows.append({"cls": "C", "pending": 50, "mean_s": 0.0})
    assert eta_seconds(rows, 250, n_chips=4) > eta * 0.9
    assert eta_seconds([{"cls": "A", "pending": 5, "mean_s": 0.0}],
                       5, 2) is None


def test_eta_dynamic_pool_falls_back_to_aggregate_remaining():
    rows = [{"cls": "A", "pending": 0, "done": 50, "mean_s": 0.01}]
    eta = eta_seconds(rows, 200, n_chips=2)
    assert eta == pytest.approx(200 * 0.01 / 2, rel=0.5)
    eta = eta_seconds(rows, 200, n_chips=2, done_total=50,
                      window_s=1.0)
    assert 3.2 <= eta <= 4.8, eta


def test_finish_profile_is_non_destructive():
    prof = la_mod._Profile(ring=16)
    for _ in range(20):
        prof.observe(2e-3, alpha=0.2)
    merged = la_mod._merge_profile(None, prof.to_wire())
    first = la_mod._finish_profile(merged)
    second = la_mod._finish_profile(merged)
    assert first == second
    assert first["p99_s"] == pytest.approx(2e-3)   # ring, not bucket


def test_eta_throughput_calibration():
    rows = [{"cls": "W", "pending": 300, "done": 100,
             "mean_s": 0.1}]              # inflated sojourn mean
    eta = eta_seconds(rows, 300, n_chips=2, done_total=100,
                      window_s=1.0)
    assert 2.5 <= eta <= 3.6, eta
    assert eta_seconds(rows, 300, n_chips=2) > 10


@pytest.mark.parametrize("case", range(4))
def test_eta_agrees_with_the_jax_package(case):
    """Parity: the ETA goes through each package's dagsim; the same rows
    quote the same seconds."""
    from parsec_tpu.prof.liveattr import eta_seconds as ref_eta
    rows, pend, chips, kw = [
        ([{"cls": "A", "pending": 100, "mean_s": 0.01},
          {"cls": "B", "pending": 37, "mean_s": 0.03}], 137, 4, {}),
        ([{"cls": "A", "pending": 0, "done": 50, "mean_s": 0.01}], 200, 2,
         {"done_total": 50, "window_s": 1.0}),
        ([{"cls": "W", "pending": 3000, "done": 100, "mean_s": 0.1},
          {"cls": "V", "pending": 10, "mean_s": 0.0}], 3100, 3,
         {"done_total": 100, "window_s": 2.0}),
        ([{"cls": "X", "pending": 1, "mean_s": 5.0}], 1, 8, {}),
    ][case]
    assert eta_seconds(rows, pend, chips, **kw) == \
        ref_eta(rows, pend, chips, **kw)


def test_class_totals_enumerates_and_caches():
    tp = _flat_pool(40)
    assert class_totals(tp) == {"W": 40}
    assert tp._liveattr_totals == {"W": 40}     # cached
    big = _flat_pool(50)
    big._liveattr_totals = None                 # simulate cap overflow
    assert class_totals(big) is None


def test_class_totals_of_the_potrf_slice_match_the_jax_package():
    import parsec_tpu.data.matrix as jax_matrix
    from parsec_tpu.apps.potrf import potrf_taskpool as ref_potrf
    from parsec_tpu.prof.liveattr import class_totals as ref_totals
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    n, mb = 96, 16
    got = class_totals(potrf_taskpool(TwoDimBlockCyclic(mb, mb, n, n)))
    ref = ref_totals(ref_potrf(jax_matrix.TwoDimBlockCyclic(mb, mb, n, n)))
    assert got == ref
    assert sum(got.values()) == 56          # nt=6: 5+1+15+15+20


# ---------------------------------------------------------------------------
# end-to-end single rank: exact counts, profiles, status document
# ---------------------------------------------------------------------------

def test_liveattr_counts_exactly_and_profiles():
    params.set("metrics_sample", 1)
    try:
        with port_context.Context(nb_cores=2, device="cpu") as ctx:
            tp = _flat_pool(200)
            ctx.add_taskpool(tp)
            ctx.wait()
            la = ctx.metrics.liveattr
            sec = la.section()
            rows = {r["cls"]: r for r in sec["recs"]}
            assert rows["W"]["done"] == 200
            assert rows["W"]["lat"]["n"] > 0
            doc = la_mod.build_status(ctx, None, {0: sec})
            agg = doc["aggregate"]
            assert agg["done"] == 200
            att = agg["attribution"]
            assert att["elapsed"] > 0
            assert att["exec"] + att["queue"] + att["comm"] \
                + att["idle"] == pytest.approx(att["elapsed"],
                                               rel=1e-3)
            rec_old = tp.task_classes["W"]._la_rec
            la.reset()
            assert rec_old.la is None       # cache binding broken
            assert la.section()["recs"] == []
            ctx.add_taskpool(_flat_pool(30))
            ctx.wait()
            rows2 = {r["cls"]: r for r in la.section()["recs"]}
            assert rows2["W"]["done"] == 30
    finally:
        params.unset("metrics_sample")


def test_evicted_rec_does_not_orphan_live_classes():
    params.set("metrics_sample", 1)
    params.set("liveattr_max_series", 1)
    try:
        from parsec_tpu_torch.dsl.ptg import PTG, Range
        with port_context.Context(nb_cores=2, device="cpu") as ctx:
            p = PTG("two", NT=60)
            p.task("A", k=Range(0, 59)).body(lambda: None)
            p.task("B", k=Range(0, 59)).body(lambda: None)
            tp = p.build()
            ctx.add_taskpool(tp)
            ctx.wait()
            la = ctx.metrics.liveattr
            live = set(map(id, la._recs.values()))
            for tc in tp.task_classes.values():
                rec = getattr(tc, "_la_rec", None)
                if rec is not None and rec.la is la:
                    assert id(rec) in live
    finally:
        params.unset("metrics_sample")
        params.unset("liveattr_max_series")


def test_split_mode_separates_queue_and_exec():
    params.set("metrics_sample", 1)
    params.set("metrics_queue_wait", 1)
    try:
        with port_context.Context(nb_cores=2, device="cpu") as ctx:
            ctx.add_taskpool(_flat_pool(120))
            ctx.wait()
            sec = ctx.metrics.liveattr.section()
            row = {r["cls"]: r for r in sec["recs"]}["W"]
            assert row["done"] == 120
            assert row["sel"] == 120            # exact selections
            assert row["queue"] is not None and row["queue"]["n"] > 0
            assert row["exec"] is not None and row["exec"]["n"] > 0
    finally:
        params.unset("metrics_sample")
        params.unset("metrics_queue_wait")


def test_device_tasks_are_counted_off_the_worker_threads():
    """A card task completes on the device module's completer thread,
    under its own stream: its completions still reach liveattr (per
    class) and the latency histogram, sampled per stream."""
    import torch
    from parsec_tpu_torch.apps.gemm import gemm_taskpool
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    params.set("metrics_sample", 1)
    try:
        with port_context.Context(nb_cores=2, device="cpu") as ctx:
            mats = [TwoDimBlockCyclic(8, 8, 32, 32, name=nm).from_array(
                torch.ones(32, 32)) for nm in "ABC"]
            ctx.add_taskpool(gemm_taskpool(*mats))
            ctx.wait(timeout=60)
            rows = {r["cls"]: r for r in
                    ctx.metrics.liveattr.section()["recs"]}
            lat = ctx.metrics.task_latency.count
    finally:
        params.unset("metrics_sample")
    assert rows["GEMM"]["done"] == 64 and lat == 64


# ---------------------------------------------------------------------------
# parity: per-class done counts against the JAX package
# ---------------------------------------------------------------------------

def _done_counts(side, sample):
    import parsec_tpu.core.context as jax_context
    import parsec_tpu.dsl.ptg as jax_ptg
    from parsec_tpu.utils.mca import params as jax_params
    import parsec_tpu_torch.dsl.ptg as port_ptg
    ctx_mod, ptg, prm, kw = (
        (jax_context, jax_ptg, jax_params, {}) if side == "jax"
        else (port_context, port_ptg, params, {"device": "cpu"}))
    p = ptg.PTG("mix", NA=70, NB=45)
    p.task("A", k=ptg.Range(0, 69)).body(lambda: None)
    p.task("B", k=ptg.Range(0, 44)).flow("x", "CTL").body(lambda: None)
    prm.set("metrics_sample", sample)
    prm.set("comm_ici_enabled", 0)
    try:
        with ctx_mod.Context(nb_cores=1, **kw) as ctx:
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=60)
            sec = ctx.metrics.liveattr.section()
    finally:
        prm.unset("metrics_sample")
        prm.unset("comm_ici_enabled")
    return {r["cls"]: r["done"] for r in sec["recs"]}, \
        {r["cls"]: r["lat"]["n"] for r in sec["recs"]}


@pytest.mark.parametrize("sample", [1, 8])
def test_per_class_done_counts_match_the_jax_package(sample):
    """One stream, so the stride picks the same tasks in both packages:
    equal per-class done counts (stride-scaled) and profile sizes."""
    assert _done_counts("port", sample) == _done_counts("jax", sample)
    if sample == 1:
        assert _done_counts("port", 1)[0] == {"A": 70, "B": 45}


# ---------------------------------------------------------------------------
# straggler detection on synthetic observations
# ---------------------------------------------------------------------------

class _TC:
    def __init__(self, name):
        self.name = name


class _TP:
    job_id = None


class _Task:
    """What LiveAttr reads off a task: its class, pool and ready stamp."""

    def __init__(self, tc, ready_at):
        self.task_class = tc
        self.taskpool = _TP()
        self.ready_at = ready_at

    def __repr__(self):
        return f"{self.task_class.name}(synthetic)"


class _Metrics:
    context = None
    _split_queue = False
    _sample = 1

    def __init__(self):
        self.context = None


def _engine(cls=la_mod.LiveAttr):
    params.set("liveattr_straggler_min", 16)
    params.set("liveattr_straggler_mult", 8.0)
    params.set("liveattr_straggler_floor_ms", 40.0)
    try:
        return cls(_Metrics())
    finally:
        for k in ("liveattr_straggler_min", "liveattr_straggler_mult",
                  "liveattr_straggler_floor_ms"):
            params.unset(k)


#: the engines' clock in these tests: task_done reads "now" through its
#: ``_perf`` hook, so a sojourn is exactly what the test says it is
_NOW = 1000.0


def _feed(la, tc, sojourns):
    """Complete one synthetic task per sojourn (seconds before _NOW)."""
    for s in sojourns:
        t = _Task(tc, _NOW - s)
        la.task_done(la.rec_of(t), None, t, True, _perf=lambda: _NOW)


def test_straggler_fires_on_a_synthetic_outlier():
    """A warmed class (64 sojourns of ~1 ms, p99 1 ms) arms its threshold
    at max(8 x p99, 40 ms floor); one 300 ms sojourn is a straggler: the
    anomaly names the class and kind, and the counter exports with its
    {job,class,kind} labels."""
    la = _engine()
    tc = _TC("S")
    _feed(la, tc, [1e-3] * 64)
    rec = la.rec_of(_Task(tc, None))
    assert rec.thr_lat == pytest.approx(0.040)       # the floor wins
    assert la.anomalies() == []
    _feed(la, tc, [0.300])
    anomalies = la.anomalies()
    assert len(anomalies) == 1
    ev = anomalies[0]
    assert ev["cls"] == "S" and ev["kind"] == "exec"
    assert ev["latency_s"] > ev["threshold_s"] > 0
    text = render_text(la.samples())
    assert 'parsec_stragglers_total{class="S",job="-",kind="exec"} 1' \
        in text


def test_straggler_fires_the_flight_recorder_rate_limited():
    """A straggler fires ``Context.telemetry_incident`` (the flight
    recorder's dump), at most once per ``liveattr_straggler_incident_s``;
    at 0 the trigger is off."""
    class _Ctx:
        def __init__(self):
            self.reasons = []

        def telemetry_incident(self, reason):
            self.reasons.append(reason)

    for window, want in ((60.0, 1), (0.0, 0)):
        params.set("liveattr_straggler_incident_s", window)
        try:
            la = _engine()
        finally:
            params.unset("liveattr_straggler_incident_s")
        ctx = la._metrics.context = _Ctx()
        tc = _TC("S")
        _feed(la, tc, [1e-3] * 64)
        _feed(la, tc, [0.300, 0.400])       # two stragglers, one window
        assert len(la.anomalies()) == 2
        assert len(ctx.reasons) == want
        assert all(r.startswith("straggler: S job=") and " exec " in r
                   for r in ctx.reasons)


def test_straggler_stays_silent_on_ordinary_variance():
    """The same class with sojourns spread 0.5-3 ms and no outlier: no
    anomaly and no counter — detection must not cry wolf."""
    la = _engine()
    tc = _TC("S")
    _feed(la, tc, [0.5e-3 + 2.5e-3 * (i % 7) / 6 for i in range(260)])
    assert la.anomalies() == []
    assert "parsec_stragglers_total" not in render_text(la.samples())


def test_unwarmed_class_never_flags():
    """Below ``liveattr_straggler_min`` observations no threshold is
    armed: a slow task of a cold class is not a straggler."""
    la = _engine()
    tc = _TC("C")
    _feed(la, tc, [1e-3] * 10 + [5.0])
    assert la.anomalies() == []
    assert la.rec_of(_Task(tc, None)).thr_lat == 0.0


def test_split_mode_thresholds_on_synthetic_observations():
    """Split mode arms the queue and exec thresholds from their own
    distributions: a long queue wait and a long body each flag as their
    own kind, and exact selection counts ride the select hook."""
    la = _engine()
    tc = _TC("Q")
    for i in range(64):
        t = _Task(tc, None)
        la.task_selected(t, 1e-3)
        la.observe_exec(t, 2e-3, True)
    assert la.anomalies() == []
    la.task_selected(_Task(tc, None), 0.5)
    la.observe_exec(_Task(tc, None), 0.7, True)
    kinds = [a["kind"] for a in la.anomalies()]
    assert kinds == ["queue", "exec"]
    row = {r["cls"]: r for r in la.section()["recs"]}["Q"]
    assert row["sel"] == 65


def test_synthetic_straggler_matches_the_jax_package():
    """Parity: the same synthetic feed through both engines arms the same
    thresholds and flags the same outlier."""
    from parsec_tpu.prof.liveattr import LiveAttr as Ref
    from parsec_tpu.utils.mca import params as jax_params
    got = _engine()
    for k, v in (("liveattr_straggler_min", 16),
                 ("liveattr_straggler_mult", 8.0),
                 ("liveattr_straggler_floor_ms", 40.0)):
        jax_params.set(k, v)
    try:
        ref = Ref(_Metrics())
    finally:
        for k in ("liveattr_straggler_min", "liveattr_straggler_mult",
                  "liveattr_straggler_floor_ms"):
            jax_params.unset(k)
    tc = _TC("S")
    feed = [2e-3 * (1 + i % 5) for i in range(80)] + [1.5]
    for la in (got, ref):
        _feed(la, tc, feed)
    g, r = got.rec_of(_Task(tc, None)), ref.rec_of(_Task(tc, None))
    assert g.thr_lat == r.thr_lat == pytest.approx(8 * 10e-3)
    assert [(a["cls"], a["kind"]) for a in got.anomalies()] == \
        [(a["cls"], a["kind"]) for a in ref.anomalies()] == [("S", "exec")]


# ---------------------------------------------------------------------------
# the job server's status surfaces (the status-op half of the JAX
# package's test_status_op_and_http_surface), on both packages
# ---------------------------------------------------------------------------

def _http_get(host, port, path):
    import socket
    with socket.create_connection((host, port), timeout=10) as s:
        s.settimeout(10)
        s.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        buf = b""
        while True:
            c = s.recv(65536)
            if not c:
                break
            buf += c
    head, _, body = buf.partition(b"\r\n\r\n")
    return head, body


def test_status_op_and_http_surface():
    """The job-less ``{"op": "status"}`` document (per-job progress, the
    attribution split telescoping to the elapsed time, no stragglers,
    the service section), the per-job status op and ``GET /status`` and
    ``GET /metrics``: the same observations on both packages."""
    import json
    import parsec_tpu.dsl.ptg as jax_ptg
    import parsec_tpu.service.server as jax_server
    import parsec_tpu.service.service as jax_service
    import parsec_tpu_torch.service.server as port_server
    import parsec_tpu_torch.service.service as port_service
    from parsec_tpu.utils.mca import params as jax_params
    got = {}
    for side, srv, svcmod, prm, ptg, kw in (
            ("jax", jax_server, jax_service, jax_params, jax_ptg, {}),
            ("port", port_server, port_service, params, None,
             {"device": "cpu"})):
        prm.set("metrics_sample", 1)
        try:
            svc = svcmod.JobService(nb_cores=2, **kw)
            server = srv.JobServer(svc, port=0)
            try:
                job = svc.submit(lambda ptg=ptg: (_flat_pool(
                    150, name="job-pool", ptg=ptg), lambda: {"ok": 1}),
                    name="flat")
                assert job.wait(timeout=60)
                st = srv.request(server.host, server.port, {"op": "status"})
                info = srv.request(server.host, server.port,
                                   {"op": "status", "job": job.job_id})
                head, body = _http_get(server.host, server.port, "/status")
                mhead, mbody = _http_get(server.host, server.port,
                                         "/metrics")
            finally:
                server.close()
                svc.shutdown(timeout=15)
        finally:
            prm.unset("metrics_sample")
        doc = st["status"]
        (j,) = doc["jobs"]
        att = j["attribution"]
        cls = j["progress"]["classes"]["W"]
        got[side] = (
            st["ok"], doc["ranks"], j["job"] == job.job_id, j["status"],
            j["progress"]["done"], (cls["done"], cls["pending"]),
            att["exec"] + att["queue"] + att["comm"] + att["idle"]
            == pytest.approx(att["elapsed"], rel=1e-3),
            j["stragglers"], doc["service"]["running"],
            info["ok"], info["info"]["status"],
            b"200 OK" in head and b"application/json" in head,
            json.loads(body)["jobs"][0]["progress"]["done"],
            b"200 OK" in mhead, b"parsec_tasks_retired_total" in mbody)
    assert got["port"] == got["jax"]
    assert got["port"] == (True, [0], True, "DONE", 150, (150, 0), True,
                           [], 0, True, "DONE", True, 150, True, True)
