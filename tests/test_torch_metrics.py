"""The port's metrics registry (prof/metrics.py): twins of the
single-rank tests of tests/test_metrics.py, parity with the JAX package's
registry on the same DAGs, the native quantum's sampling-stride gate,
and the GEMM, QR and potrf slices with the plane armed and off.

The job server's scrape surfaces (the framed op and HTTP GET) run on
both packages; tools/metrics_client.py is the JAX package's and has no
twin.  The two-rank TAG_METRICS aggregation runs through
``cluster_exposition`` (the job-duration histogram of the JAX package's
case is checked over the job server instead).  The job SLO counter
counts; the flight-recorder incident the JAX package also fires on a
breach is not ported.

Parity (the same DAG on seeded inputs, each package's C path): the same
metric names — less ``parsec_sched_native_fallbacks_total``, which the
port leaves out on purpose (it has no silent fallback to count) — the
same label names, and equal histogram counts at a given
``metrics_sample``."""

import re
import time

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg as jax_ptg
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg as port_ptg
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.prof.metrics import (BUCKET_BOUNDS, Counter, Family,
                                           Gauge, Histogram, bucket_index,
                                           counter_sample, gauge_sample,
                                           histogram_sample, merge_samples,
                                           render_text)
from parsec_tpu_torch.utils.mca import params


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------

def test_bucket_index_le_invariant():
    """Every observation lands in the smallest bucket whose bound is
    >= the value (Prometheus ``le`` semantics) — including exact powers
    of two, the frexp edge case — and in the JAX package's bucket."""
    from parsec_tpu.prof.metrics import bucket_index as ref_index
    vals = [1e-9, 1e-6, 2.0 ** -20, 2.0 ** -10, 3e-4, 0.25, 0.5,
            0.500001, 1.0, 2.0, 63.9, 64.0, 100.0, 1e6]
    for v in vals:
        i = bucket_index(v)
        assert i == ref_index(v)
        if i < len(BUCKET_BOUNDS):
            assert v <= BUCKET_BOUNDS[i], (v, i)
        if 0 < i <= len(BUCKET_BOUNDS):
            assert v > BUCKET_BOUNDS[i - 1], (v, i)


def test_histogram_counts_sum_quantile():
    h = Histogram(ring=64)
    vals = [1e-5, 1e-5, 2e-3, 0.1, 0.1, 0.1, 5.0]
    for v in vals:
        h.observe(v)
    buckets, s, c = h.snapshot()
    assert c == len(vals)
    assert abs(s - sum(vals)) < 1e-12
    assert sum(buckets) == len(vals)
    for v in set(vals):
        assert buckets[bucket_index(v)] >= 1
    assert 1e-5 <= h.quantile(0.0) <= 5.0
    assert h.quantile(0.99) == 5.0


def test_counter_gauge_and_family_bounding():
    c = Counter()
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    g = Gauge()
    g.set(7)
    g.add(-2)
    assert g.value == 5.0
    fam = Family(Counter, ("peer",), max_series=3)
    for r in range(5):
        fam.labels(peer=r).inc(r)
    items = fam.items()
    assert len(items) == 3          # oldest two evicted
    peers = {lab["peer"] for lab, _m in items}
    assert peers == {"2", "3", "4"}


def test_render_text_exposition_format():
    h = Histogram()
    for v in (1e-4, 1e-4, 2.0):
        h.observe(v)
    samples = [counter_sample("parsec_demo_total", 3),
               gauge_sample("parsec_demo_depth", 2, {"peer": "1"}),
               histogram_sample("parsec_demo_seconds", h)]
    text = render_text(samples)
    assert "# TYPE parsec_demo_total counter" in text
    assert "parsec_demo_total 3" in text
    assert 'parsec_demo_depth{peer="1"} 2' in text
    counts = [int(m.group(1)) for m in re.finditer(
        r'parsec_demo_seconds_bucket\{le="[^"]+"\} (\d+)', text)]
    assert counts == sorted(counts)
    assert counts[-1] == 3
    assert 'le="+Inf"' in text
    assert "parsec_demo_seconds_count 3" in text
    m = re.search(r"parsec_demo_seconds_sum (\S+)", text)
    assert abs(float(m.group(1)) - 2.0002) < 1e-9
    # the same exposition as the JAX package's renderer
    from parsec_tpu.prof.metrics import render_text as ref_render
    assert text == ref_render(samples)


def test_merge_samples_sums_counters_and_labels_gauges():
    h0, h1 = Histogram(), Histogram()
    h0.observe(1e-4)
    h1.observe(1e-4)
    h1.observe(2.0)
    per_rank = {
        0: [counter_sample("parsec_x_total", 5),
            gauge_sample("parsec_x_depth", 2),
            histogram_sample("parsec_x_seconds", h0)],
        1: [counter_sample("parsec_x_total", 7),
            gauge_sample("parsec_x_depth", 9),
            histogram_sample("parsec_x_seconds", h1)],
    }
    merged = merge_samples(per_rank)
    by = {(s["n"], tuple(sorted(s["l"].items()))): s for s in merged}
    assert by[("parsec_x_total", ())]["v"] == 12
    assert by[("parsec_x_depth", (("rank", "0"),))]["v"] == 2
    assert by[("parsec_x_depth", (("rank", "1"),))]["v"] == 9
    hs = by[("parsec_x_seconds", ())]
    assert hs["cnt"] == 3 and sum(hs["b"]) == 3
    from parsec_tpu.prof.metrics import merge_samples as ref_merge
    assert merged == ref_merge(per_rank)


# ---------------------------------------------------------------------------
# the always-on registry on the port's Context
# ---------------------------------------------------------------------------

def _n_pool(n, name="m", ptg=port_ptg):
    p = ptg.PTG(name, N=n)
    p.task("E", i=ptg.Range(0, n - 1)).flow("x", "CTL").body(lambda: None)
    return p.build()


def test_runtime_metrics_counts_every_task():
    params.set("metrics_sample", 1)
    try:
        with port_context.Context(nb_cores=2, device="cpu") as ctx:
            assert ctx.metrics is not None
            assert ctx._ready_stamp     # schedule() stamps ready_at
            ctx.add_taskpool(_n_pool(40))
            ctx.wait(timeout=60)
            text = render_text(ctx.metrics.samples())
    finally:
        params.unset("metrics_sample")
    assert re.search(r"parsec_tasks_retired_total 40\b", text)
    assert re.search(r"parsec_pending_tasks 0\b", text)
    # with stride 1 every task contributes a sojourn-latency sample
    assert re.search(r"parsec_task_latency_seconds_count 40\b", text)


def test_queue_wait_split_is_opt_in():
    params.set("metrics_sample", 1)
    params.set("metrics_queue_wait", 1)
    try:
        with port_context.Context(nb_cores=2, device="cpu") as ctx:
            hooked = {ev for ev, cbs in ctx._pins.items() if cbs}
            ctx.add_taskpool(_n_pool(30))
            ctx.wait(timeout=60)
            text = render_text(ctx.metrics.samples())
    finally:
        params.unset("metrics_sample")
        params.unset("metrics_queue_wait")
    assert {"select", "exec_begin", "exec_end"} <= hooked
    assert re.search(r"parsec_task_queue_wait_seconds_count 30\b", text)
    assert re.search(r"parsec_task_latency_seconds_count 30\b", text)


def test_metrics_disabled_removes_every_hook():
    params.set("metrics_enabled", 0)
    try:
        with port_context.Context(nb_cores=1, device="cpu") as ctx:
            assert ctx.metrics is None
            assert not ctx._ready_stamp
            assert not any(ctx._pins.values())
            ctx.add_taskpool(_n_pool(5))
            ctx.wait(timeout=60)
    finally:
        params.unset("metrics_enabled")


def test_causal_tracer_keeps_ready_stamp_without_metrics():
    from parsec_tpu_torch.prof.causal import install_causal_tracer
    from parsec_tpu_torch.prof.profiling import Profile
    params.set("metrics_enabled", 0)
    try:
        with port_context.Context(nb_cores=1, device="cpu") as ctx:
            assert not ctx._ready_stamp and not ctx._device_spans
            tr = install_causal_tracer(ctx, Profile())
            assert ctx._ready_stamp and ctx._device_spans
            tr.uninstall(ctx)
            assert not ctx._ready_stamp and not ctx._device_spans
    finally:
        params.unset("metrics_enabled")


def test_uninstall_at_fini_drops_the_context():
    """fini uninstalls the registry (the JAX package's order): its hooks
    leave the PINS map and it stops referencing the Context, so an ended
    Context is not kept alive by its telemetry."""
    with port_context.Context(nb_cores=1, device="cpu") as ctx:
        m = ctx.metrics
        assert m.context is ctx
    assert m.context is None and ctx.metrics is None
    assert not any(ctx._pins.values())
    assert m.liveattr is None and m.health is None


def test_native_quantum_skips_the_unsampled_completions():
    """The registry's complete_exec callback advertises its stride
    (``__pins_stride__``): the C quantum calls it on every Nth completion
    of a stream only, while the Python chain calls it on every task and
    it returns early — the same observations either way."""
    calls = {}
    for flag in (1, 0):
        params.set("sched_native", flag)
        params.set("metrics_sample", 4)
        try:
            with port_context.Context(nb_cores=1, device="cpu") as ctx:
                m = ctx.metrics
                n = [0]
                real = m._complete_cb.fn

                def counting(es, event, task, real=real, n=n):
                    n[0] += 1
                    real(es, event, task)
                m._complete_cb.fn = counting
                assert m._complete_cb.__pins_stride__ == 4
                ctx.add_taskpool(_n_pool(64))
                ctx.wait(timeout=60)
                hist = m.task_latency.count
        finally:
            params.unset("sched_native")
            params.unset("metrics_sample")
        calls[flag] = (n[0], hist)
    # 64 tasks on one stream, 1 in 4 sampled either way.  The C quantum
    # calls the hook on the sampled completions only (a task the worker
    # takes through its doorbell probe runs the Python chain, which calls
    # it and returns early: a few at most)
    assert calls[1][1] == calls[0][1] == 16
    assert 16 <= calls[1][0] < 32
    assert calls[0][0] == 64        # the Python chain: every completion


# ---------------------------------------------------------------------------
# parity with the JAX package's registry
# ---------------------------------------------------------------------------

def _chain_and_fan(mat_mod, ptg, zeros, dev):
    """A trivial CTL class (the C chain), an RW chain on a collection
    tile (the extended chain) and a device class over a 2x2 tile grid
    (a device label and the non_trivial bailout)."""
    A = mat_mod.TwoDimBlockCyclic(1, 1, 1, 1, name="A").from_array(
        zeros(1, 1))
    D = mat_mod.TwoDimBlockCyclic(4, 4, 8, 8, name="D").from_array(
        zeros(8, 8))
    g = ptg.PTG("par", NE=50, NB=30)
    g.task("E", i=ptg.Range(0, 49)).flow("x", "CTL").body(lambda: None)
    g.task("S", k=ptg.Range(0, 29)) \
        .affinity(lambda k: A(0, 0)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda k: A(0, 0)), when=lambda k: k == 0),
              ptg.IN(ptg.TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              ptg.OUT(ptg.TASK("S", "T", lambda k: dict(k=k + 1)),
                      when=lambda k: k < 29),
              ptg.OUT(ptg.DATA(lambda k: A(0, 0)), when=lambda k: k == 29)) \
        .body(lambda T: T + 1.0)
    g.task("G", m=ptg.Range(0, 1), n=ptg.Range(0, 1)) \
        .affinity(lambda m, n: D(m, n)) \
        .flow("X", "RW", ptg.IN(ptg.DATA(lambda m, n: D(m, n))),
              ptg.OUT(ptg.DATA(lambda m, n: D(m, n)))) \
        .body(lambda X: X + 2.0, device=dev)
    return g.build()


def _cpu_only(mat_mod, ptg, zeros, dev):
    return _n_pool(100, "cpu", ptg)


def _scrape(side, build, sample=16, cores=1):
    if side == "jax":
        ctx_mod, mat_mod, ptg, prm, kw, dev = (
            jax_context, jax_matrix, jax_ptg, jax_params, {}, "tpu")
        zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
        # the conftest's virtual 8-device mesh attaches an ICI engine,
        # which (correctly) gates the extended chain off; the property
        # is about the C chain, so make it eligible
        prm.set("comm_ici_enabled", 0)
    else:
        ctx_mod, mat_mod, ptg, prm, kw, dev = (
            port_context, port_matrix, port_ptg, params,
            {"device": "cpu"}, "cuda")
        zeros = lambda *s: torch.zeros(*s)  # noqa: E731
    prm.set("metrics_sample", sample)
    prm.set("sched_native", 1)
    try:
        with ctx_mod.Context(nb_cores=cores, **kw) as ctx:
            ctx.add_taskpool(build(mat_mod, ptg, zeros, dev))
            ctx.wait(timeout=60)
            samples = [s for s in ctx.metrics.samples()
                       if s["t"] != "section"]
            la = ctx.metrics.liveattr.section()
    finally:
        for k in ("metrics_sample", "sched_native"):
            prm.unset(k)
        if side == "jax":
            prm.unset("comm_ici_enabled")
    return samples, la


def _shape(samples):
    """metric name -> set of label-name tuples (device names differ by
    design: the JAX package's are TPU devices)."""
    out = {}
    for s in samples:
        out.setdefault(s["n"], set()).add(tuple(sorted(s["l"])))
    return out


def test_sample_names_and_label_sets_match_the_jax_package():
    ref, _ = _scrape("jax", _chain_and_fan)
    got, _ = _scrape("port", _chain_and_fan)
    ref_shape = _shape(ref)
    # the deliberate difference: no fallback counter in the port
    left_out = {"parsec_sched_native_fallbacks_total"}
    for name in left_out:
        assert name in ref_shape
        del ref_shape[name]
    assert _shape(got) == ref_shape
    # label VALUES agree wherever they are not device names (nor the
    # bailout reasons, counted process-wide since the extension loaded)
    vals = lambda ss: {(s["n"], tuple(sorted(s["l"].items())))  # noqa: E731
                       for s in ss if "device" not in s["l"]
                       and s["n"] != "parsec_sched_native_bailouts_total"}
    assert vals(got) == vals(ref) - {(name, ()) for name in left_out}
    # the device family exists on both sides, one device each label
    for ss in (got, ref):
        assert any(s["n"] == "parsec_device_tasks_total" for s in ss)


@pytest.mark.parametrize("sample", [1, 4, 16])
def test_histogram_counts_match_the_jax_package(sample):
    """One stream, a CPU-only DAG: the sampled sojourn histogram's count
    is a function of the stride alone, in both packages."""
    ref, _ = _scrape("jax", _cpu_only, sample=sample)
    got, _ = _scrape("port", _cpu_only, sample=sample)

    def counts(ss):
        return {s["n"]: s["cnt"] for s in ss if s["t"] == "histogram"}

    def counters(ss):
        # the per-Context counters (the bailout and fallback counters are
        # process-wide: they count whatever ran before in the process)
        return {s["n"]: s["v"] for s in ss if s["n"] in (
            "parsec_tasks_retired_total", "parsec_tasks_discarded_total",
            "parsec_sched_native_pushes_total",
            "parsec_sched_native_pops_total")}
    assert counts(got) == counts(ref)
    assert counts(got)["parsec_task_latency_seconds"] == -(-100 // sample)
    assert counters(got) == counters(ref)
    assert counters(got)["parsec_tasks_retired_total"] == 100


# ---------------------------------------------------------------------------
# the slices with the plane armed and off: the same bits
# ---------------------------------------------------------------------------

def _mat(mb, n, arr, name):
    return port_matrix.TwoDimBlockCyclic(mb, mb, n, n, name=name) \
        .from_array(torch.from_numpy(arr.copy()))


def _slice_run(app, armed):
    from parsec_tpu_torch.prof.causal import install_causal_tracer
    from parsec_tpu_torch.prof.pins import install_task_profiler
    from parsec_tpu_torch.prof.profiling import Profile
    rng = np.random.default_rng(31)
    knobs = () if armed else (("metrics_enabled", 0), ("journal_enabled", 0))
    for k, v in knobs:
        params.set(k, v)
    try:
        with port_context.Context(nb_cores=3, device="cpu") as ctx:
            assert (ctx.metrics is not None) == armed
            mods = []
            if armed:
                prof = Profile("armed")
                mods = [install_task_profiler(ctx, prof),
                        install_causal_tracer(ctx, prof)]
            if app == "gemm":
                from parsec_tpu_torch.apps.gemm import gemm_taskpool
                n, mb = 48, 16
                mats = [_mat(mb, n, rng.standard_normal((n, n)).astype(
                    np.float32), nm) for nm in "ABC"]
                tp, out = gemm_taskpool(*mats), mats[2]
            elif app == "qr":
                from parsec_tpu_torch.apps.qr import qr_taskpool
                n, mb = 64, 16
                out = _mat(mb, n, rng.standard_normal((n, n)).astype(
                    np.float32), "Q")
                tp = qr_taskpool(out)
            else:
                from parsec_tpu_torch.apps.potrf import potrf_taskpool
                n, mb = 64, 16
                a = rng.standard_normal((n, n))
                spd = (a @ a.T + n * np.eye(n)).astype(np.float32)
                out = _mat(mb, n, spd, "P")
                tp = potrf_taskpool(out)
            ctx.add_taskpool(tp)
            ctx.wait(timeout=120)
            for mod in mods:
                mod.uninstall(ctx)
            retired = None if not armed else \
                [s["v"] for s in ctx.metrics.samples()
                 if s["n"] == "parsec_device_tasks_total"]
        return out.to_array().clone(), retired
    finally:
        for k, _v in knobs:
            params.unset(k)


@pytest.mark.parametrize("app", ["gemm", "qr", "potrf"])
def test_slice_is_bit_identical_with_the_plane_armed_and_off(app):
    """The GEMM, QR and potrf slices at small sizes on the CPU-backed
    device module: the plane at its defaults plus the task profiler and
    the causal tracer, against metrics and journal off — the same bits
    (telemetry never touches a tile)."""
    armed, dev_tasks = _slice_run(app, True)
    off, _ = _slice_run(app, False)
    assert torch.equal(armed, off)
    assert bool(torch.isfinite(armed).all())
    assert dev_tasks and dev_tasks[0] > 0


# ---------------------------------------------------------------------------
# cross-rank: the TAG_METRICS aggregation
# ---------------------------------------------------------------------------

def test_two_rank_scrape_aggregates_over_tag_metrics():
    """One scrape on rank 0 sees the mesh: comm counters summed across
    both ranks via TAG_METRICS, gauges labeled per rank, and the clock
    probes' frame-RTT histogram — in both packages."""
    import torch_comm_workers as W
    j, p = W.run_both(W.scrape, 2, timeout=180)
    for res in (p, j):
        assert res[0]["ranks"] == [0, 1]
        text = res[0]["text"]
        m = re.search(r"parsec_comm_frames_sent_total (\d+)", text)
        assert m is not None
        total = int(m.group(1))
        assert total >= res[0]["frames"] + 1, (total, res)
        assert total >= res[1]["frames"] + 1, (total, res)
        assert re.search(r'parsec_pending_tasks\{rank="1"\}', text)
        m = re.search(r"parsec_comm_frame_rtt_seconds_count (\d+)", text)
        assert m is not None and int(m.group(1)) >= 1, text[:2000]
    names = lambda t: set(re.findall(r"^# TYPE (\S+)", t, re.M))  # noqa
    assert names(p[0]["text"]) - names(j[0]["text"]) == set()


# ---------------------------------------------------------------------------
# the job server's scrape surfaces and the job SLO, on both packages
# ---------------------------------------------------------------------------

def _serve(side, **kw):
    """A JobService + JobServer pair of one package, on the CPU."""
    if side == "jax":
        from parsec_tpu.service.server import request, serve
        return serve(port=0, nb_cores=2, **kw), request, jax_params
    from parsec_tpu_torch.service.server import request, serve
    return serve(port=0, nb_cores=2, device="cpu", **kw), request, params


def _job_lines(text, job_id):
    """The scrape lines a served job must produce."""
    counts = [int(m.group(1)) for m in re.finditer(
        r'parsec_job_duration_seconds_bucket\{le="[^"]+"\} (\d+)', text)]
    return ("parsec_tasks_retired_total" in text,
            'parsec_jobs_done_total{status="done"} 1' in text,
            bool(re.search(r"parsec_job_duration_seconds_count 1\b", text)),
            counts == sorted(counts) and counts[-1] == 1,
            bool(re.search(r'parsec_job_tasks_total\{job="%d",'
                           r'kind="retired"\} 8\b' % job_id, text)))


def test_scrape_over_job_server_framed():
    """The framed ``{"op": "metrics"}`` scrape carries the task and job
    families — one completed job in the job histogram, its 8 retired
    tasks in the per-job counters — on both packages."""
    got = {}
    for side in ("jax", "port"):
        (service, server), request, prm = _serve(side)
        ptg = jax_ptg if side == "jax" else port_ptg
        prm.set("metrics_sample", 1)
        try:
            job = service.submit(lambda: _n_pool(8, "job-pool", ptg),
                                 name="scrapee")
            assert job.wait(timeout=30)
            reply = request(server.host, server.port, {"op": "metrics"})
        finally:
            prm.unset("metrics_sample")
            server.close()
            service.shutdown(timeout=10.0)
        got[side] = (reply["ok"], reply["ranks"],
                     _job_lines(reply["text"], job.job_id))
    assert got["port"] == got["jax"] == (True, [0], (True,) * 5)


def test_scrape_over_http_get():
    """A plain HTTP ``GET /metrics`` on the same port answers the text
    exposition, and a wrong path 404s, on both packages."""
    import socket
    got = {}
    for side in ("jax", "port"):
        (service, server), _request, _prm = _serve(side)
        try:
            with socket.create_connection((server.host, server.port),
                                          timeout=10.0) as s:
                s.sendall(b"GET /metrics HTTP/1.0\r\nHost: x\r\n\r\n")
                data = b""
                while True:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    data += chunk
            head, body = data.split(b"\r\n\r\n", 1)
            with socket.create_connection((server.host, server.port),
                                          timeout=10.0) as s:
                s.sendall(b"GET /nope HTTP/1.0\r\n\r\n")
                nope = s.recv(4096)
        finally:
            server.close()
            service.shutdown(timeout=10.0)
        got[side] = (head.startswith(b"HTTP/1.0 200 OK"),
                     b"text/plain" in head,
                     b"parsec_tasks_retired_total" in body,
                     nope.startswith(b"HTTP/1.0 404"))
    assert got["port"] == got["jax"] == (True,) * 4


def test_job_slo_breach_counts():
    """The counter half of the JAX package's
    ``test_job_slo_breach_counts_and_triggers_incident``: with
    ``metrics_slo_job_s`` below any job's duration every job counts in
    ``parsec_jobs_slo_breached_total``, and a Context accepts the knob.
    The incident half is ``test_job_slo_breach_counts_and_triggers_incident``
    below."""
    from parsec_tpu_torch.service.service import JobService
    params.set("metrics_slo_job_s", 1e-9)   # every job breaches
    try:
        with JobService(nb_cores=2, device="cpu") as svc:
            jobs = [svc.submit(lambda: _n_pool(8, "slo"), name="slo")
                    for _ in range(3)]
            assert all(j.wait(timeout=30) for j in jobs)
            m = svc.context.metrics
            # wait() returns at the DONE transition; the job_done PINS
            # emission follows on the finishing thread a moment later
            deadline = time.monotonic() + 10
            while m._slo_breached.value < 3 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            text = render_text(m.samples())
    finally:
        params.unset("metrics_slo_job_s")
    assert re.search(r"parsec_jobs_slo_breached_total 3\b", text)


def test_job_slo_breach_counts_and_triggers_incident(tmp_path):
    """Twin of the JAX package's test: a breach with the flight recorder
    armed counts and dumps an incident bundle."""
    from parsec_tpu_torch.service.service import JobService
    params.set("metrics_slo_job_s", 1e-9)   # every job breaches
    params.set("flightrec_enabled", 1)
    params.set("flightrec_dir", str(tmp_path))
    try:
        with JobService(nb_cores=2, device="cpu") as svc:
            job = svc.submit(lambda: _n_pool(8, "slo"), name="slo")
            assert job.wait(timeout=30)
            ctx = svc.context
            deadline = time.monotonic() + 10
            while ctx._flightrec.incidents < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert ctx._flightrec.incidents >= 1
            text = render_text(ctx.metrics.samples())
            assert re.search(r"parsec_jobs_slo_breached_total [1-9]",
                             text)
            assert (tmp_path / "rank0.ptt").exists()
    finally:
        params.unset("metrics_slo_job_s")
        params.unset("flightrec_enabled")
        params.unset("flightrec_dir")


def test_job_slo_off_by_default_counts_nothing():
    from parsec_tpu_torch.service.service import JobService
    with JobService(nb_cores=2, device="cpu") as svc:
        job = svc.submit(lambda: _n_pool(8, "noslo"), name="noslo")
        assert job.wait(timeout=30)
        text = render_text(svc.context.metrics.samples())
    assert re.search(r"parsec_jobs_slo_breached_total 0\b", text)
