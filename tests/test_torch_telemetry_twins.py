"""The telemetry plane's last reference cases on the port: the journal
auditor's invariant corpus, the clock-offset estimator, the forwarded
activation in a merged trace, the online attribution split against the
offline one, the ETA of a running job, the PINS iterators checker and
the trace sink's one-call interval.

Twins of the cases of tests/test_journal.py, tests/test_critpath.py,
tests/test_liveattr.py and tests/test_prof.py that no other port test
covers (the health plane's H1 audit corpus is twinned in
tests/test_torch_fabric.py, the straggler legs on synthetic
observations in tests/test_torch_liveattr.py, the trace tools' CLI in
tests/test_torch_tools.py).  Pure functions run on both packages with
the same inputs and must agree; runtime cases run the port on
``device="cpu"`` (multi-rank ones through tests/torch_comm_workers.py)
and hold it to the reference test's expectations, and where a trace is
read, the JAX package's reader of the same files must agree.
"""

import copy
import json
import os
import time

import numpy as np
import pytest

import torch_comm_workers as W
from parsec_tpu.comm.engine import clock_offset_estimate as jax_offset
from parsec_tpu_torch.comm.engine import clock_offset_estimate as port_offset
from parsec_tpu_torch.utils.mca import params
from tools import journal_audit as jax_audit
from parsec_tpu_torch.tools import journal_audit as port_audit


# ---------------------------------------------------------------------------
# the journal auditor: the clean reference round + one corpus per invariant
# ---------------------------------------------------------------------------

def _snap(rank, events, clock=None, inc=0):
    return {"rank": rank, "inc": inc, "nranks": 2, "wall": 0.0,
            "perf": 0.0, "clock": clock or {}, "events": events}


def _bundle(*rank_events, incs=None):
    """rank_events[i] = events of rank i (t/seq/inc auto-filled)."""
    per_rank = {}
    for rank, evs in enumerate(rank_events):
        out = []
        for i, ev in enumerate(evs):
            e = {"t": float(i), "seq": i + 1,
                 "inc": (incs or {}).get(rank, 0)}
            e.update(ev)
            out.append(e)
        per_rank[rank] = [_snap(rank, out)]
    return per_rank


def _clean_round():
    """A consistent 2-survivor skip round: same membership, cut under
    every offer, one retirement each, negotiation answered."""
    r0 = [
        {"e": "mode_decl", "pool": 1, "round": 1, "mode": "minimal",
         "peers": [0, 2]},
        {"e": "skip_offer", "pool": 1, "round": 1, "frontier": 18},
        {"e": "skip_offer", "pool": 1, "round": 1, "frontier": 40,
         "src": 2},
        {"e": "skip_cut", "pool": 1, "round": 1, "prefix": 17},
        {"e": "epoch_fence", "pool": 1, "epoch": 1},
        {"e": "need_req", "pool": 1, "src": 2, "n": 1},
        {"e": "need_ack", "pool": 1, "dst": 2, "ok": True},
        {"e": "retired", "pool": 1},
    ]
    r2 = [
        {"e": "mode_decl", "pool": 1, "round": 1, "mode": "minimal",
         "peers": [0, 2]},
        {"e": "skip_offer", "pool": 1, "round": 1, "frontier": 40},
        {"e": "skip_cut", "pool": 1, "round": 1, "prefix": 17,
         "src": 0},
        {"e": "need_send", "pool": 1, "round": 1, "peers": [0]},
        {"e": "need_round", "pool": 1, "round": 1, "outcome": "acked",
         "peers": [0]},
        {"e": "epoch_fence", "pool": 1, "epoch": 1},
        {"e": "retired", "pool": 1},
    ]
    return _bundle(r0, [], r2)


def _audit(bundle):
    """Both auditors over (copies of) one bundle; they must agree."""
    got = port_audit.audit(copy.deepcopy(bundle))
    assert got == jax_audit.audit(copy.deepcopy(bundle))
    return got


def test_audit_clean_reference_round():
    assert _audit(_clean_round()) == []


def test_audit_flags_membership_disagreement():
    b = _clean_round()
    b[2][0]["events"][0]["peers"] = [0, 1, 2]   # divergent gang view
    vs = _audit(b)
    assert any(v.startswith("I1") for v in vs), vs


def test_audit_flags_cut_above_offer():
    b = _clean_round()
    # rank 0's own offer drops below the agreed prefix
    b[0][0]["events"][1]["frontier"] = 10
    vs = _audit(b)
    assert any(v.startswith("I2") and "exceeds" in v for v in vs), vs


def test_audit_flags_cut_despite_full_vote():
    b = _clean_round()
    b[2][0]["events"][1]["frontier"] = -1
    b[2][0]["events"][1]["full"] = "region-lane pool"
    vs = _audit(b)
    assert any(v.startswith("I2") and "full" in v for v in vs), vs


def test_audit_flags_incarnation_regression():
    b = _clean_round()
    b[0][0]["events"][3]["inc"] = 1
    b[0][0]["events"][4]["inc"] = 0    # regressed mid-file
    vs = _audit(b)
    assert any(v.startswith("I3") and "incarnation" in v for v in vs), vs


def test_audit_flags_nonmonotone_epoch_fence():
    b = _clean_round()
    b[0][0]["events"].append({"e": "epoch_fence", "pool": 1, "epoch": 1,
                              "t": 9.0, "seq": 99, "inc": 0})
    vs = _audit(b)
    assert any(v.startswith("I3") and "run_epoch" in v for v in vs), vs


def test_audit_flags_double_retirement_outcome():
    b = _clean_round()
    b[0][0]["events"].append({"e": "retire_degraded", "pool": 1,
                              "t": 9.0, "seq": 99, "inc": 0})
    vs = _audit(b)
    assert any(v.startswith("I4") for v in vs), vs


def test_audit_flags_unanswered_need():
    b = _clean_round()
    b[0][0]["events"].pop(6)           # the need_ack vanishes
    vs = _audit(b)
    assert any(v.startswith("I5") and "unanswered" in v for v in vs), vs


def test_audit_flags_silent_need_round():
    b = _clean_round()
    b[2][0]["events"].pop(4)           # need_send with no outcome
    vs = _audit(b)
    assert any(v.startswith("I5") and "no terminal outcome" in v
               for v in vs), vs


def test_audit_recycled_pool_id_across_incarnations_is_clean():
    """Pool ids are a per-process counter: a restarted incarnation
    legitimately reuses its predecessor's ids.  A rank that retired
    pool 1, restarted (higher inc), and retired a NEW pool 1 must not
    flag I3/I4 — the incarnation stamp disambiguates."""
    first = [{"e": "epoch_fence", "pool": 1, "epoch": 1, "t": 1.0,
              "seq": 1, "inc": 0},
             {"e": "retired", "pool": 1, "t": 2.0, "seq": 2, "inc": 0}]
    second = [{"e": "epoch_fence", "pool": 1, "epoch": 1, "t": 10.0,
               "seq": 1, "inc": 1},
              {"e": "need_req", "pool": 1, "src": 1, "t": 10.5,
               "seq": 2, "inc": 1},
              {"e": "need_ack", "pool": 1, "dst": 1, "ok": True,
               "t": 10.6, "seq": 3, "inc": 1},
              {"e": "retired", "pool": 1, "t": 11.0, "seq": 4,
               "inc": 1}]
    per_rank = {0: [_snap(0, first, inc=0), _snap(0, second, inc=1)]}
    assert _audit(per_rank) == []
    # the true violations still flag WITHIN one incarnation
    per_rank[0][1]["events"].append(
        {"e": "retired", "pool": 1, "t": 12.0, "seq": 5, "inc": 1})
    vs = _audit(per_rank)
    assert any(v.startswith("I4") for v in vs), vs


def test_skip_rounds_attribute_replay_to_its_own_round():
    """A pool whose round 1 fell back to full and whose round 2
    agreed a cut must not report ghost replays in round 1."""
    evs = [
        {"e": "skip_offer", "pool": 1, "round": 1, "frontier": -1,
         "full": "no prefix", "t": 1.0, "seq": 1, "inc": 0},
        {"e": "skip_cut", "pool": 1, "round": 1, "prefix": 0,
         "t": 1.1, "seq": 2, "inc": 0},
        {"e": "skip_offer", "pool": 1, "round": 2, "frontier": 20,
         "t": 5.0, "seq": 3, "inc": 0},
        {"e": "skip_cut", "pool": 1, "round": 2, "prefix": 17,
         "t": 5.1, "seq": 4, "inc": 0},
        {"e": "replay_mode", "pool": 1, "mode": "skip", "round": 2,
         "prefix": 17, "tasks": 9, "t": 5.2, "seq": 5, "inc": 0},
        {"e": "retired", "pool": 1, "t": 6.0, "seq": 6, "inc": 0},
    ]
    got = port_audit.skip_rounds({0: [_snap(0, copy.deepcopy(evs))]})
    assert got == jax_audit.skip_rounds({0: [_snap(0, evs)]})
    rounds = {(r["pool"], r["round"]): r for r in got}
    assert rounds[(1, 1)]["replays"] == []
    assert rounds[(1, 1)]["retired"] == []
    assert len(rounds[(1, 2)]["replays"]) == 1
    assert len(rounds[(1, 2)]["retired"]) == 1


def test_skip_round_reconstruction_and_timeline():
    rounds = port_audit.skip_rounds(_clean_round())
    assert rounds == jax_audit.skip_rounds(_clean_round())
    assert len(rounds) == 1
    r = rounds[0]
    assert r["cut"]["prefix"] == 17
    offers = {o["rank"]: o["frontier"] for o in r["offers"]}
    assert offers == {0: 18, 2: 40}
    assert len(r["retired"]) == 2
    text = port_audit.render_timeline(_clean_round())
    assert text == jax_audit.render_timeline(_clean_round())
    assert "skip round pool=1" in text and "agreed cut 17" in text


def test_chrome_export_instant_events(tmp_path):
    docs = {}
    for name, tool in (("port", port_audit), ("jax", jax_audit)):
        out = str(tmp_path / f"ctl-{name}.json")
        n = tool.write_chrome(_clean_round(), out)
        with open(out) as fh:
            docs[name] = (n, json.load(fh))
    assert docs["port"] == docs["jax"]
    n, doc = docs["port"]
    evs = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert len(evs) == n and n > 0
    assert {e["pid"] for e in evs} == {0, 2}
    assert all(e["ts"] >= 0 for e in evs)


# ---------------------------------------------------------------------------
# the clock-offset estimator (comm/engine.py)
# ---------------------------------------------------------------------------

def _offset(samples):
    got = port_offset(samples)
    assert got == jax_offset(samples)
    return got


def test_clock_offset_symmetric_delay_exact():
    """Symmetric path delay: the midpoint estimate recovers the true
    offset exactly, whatever the delay magnitude."""
    true_off = 3.25          # peer clock ahead of ours by 3.25s
    for delay in (1e-4, 2e-3, 0.5):
        t0 = 100.0
        t1 = t0 + delay + true_off           # peer stamps on ITS clock
        t2 = t0 + 2 * delay
        off, rtt = _offset([(t0, t1, t2)])
        assert off == pytest.approx(true_off, abs=1e-12)
        assert rtt == pytest.approx(2 * delay)


def test_clock_offset_asymmetric_delay_bounded_by_half_rtt():
    """Asymmetric delay biases the estimate by (fwd-back)/2 — always
    within rtt/2 (the Cristian bound the estimator documents)."""
    true_off = -7.5
    fwd, back = 3e-3, 1e-3
    t0 = 50.0
    t1 = t0 + fwd + true_off
    t2 = t0 + fwd + back
    off, rtt = _offset([(t0, t1, t2)])
    assert abs(off - true_off) <= rtt / 2 + 1e-12
    assert off - true_off == pytest.approx((fwd - back) / 2)


def test_clock_offset_min_rtt_sample_wins():
    """Queueing only inflates rtt, so the tightest sample is the most
    symmetric: a noisy batch must resolve to the clean sample's
    estimate, not an average polluted by the congested ones."""
    true_off = 1.0
    clean = (10.0, 10.0 + 1e-4 + true_off, 10.0 + 2e-4)
    noisy = [(t0, t0 + 0.05 + true_off + 0.04, t0 + 0.1)   # asym + slow
             for t0 in (11.0, 12.0, 13.0)]
    off, rtt = _offset(noisy + [clean] + noisy)
    assert off == pytest.approx(true_off, abs=1e-9)
    assert rtt == pytest.approx(2e-4)


# ---------------------------------------------------------------------------
# multi-rank traces: the forwarded edge, the online split
# ---------------------------------------------------------------------------

def _online_split(la, sections):
    """The online exec/queue/comm/idle split of merged per-rank liveattr
    sections, through package ``la``'s own functions."""
    merged = la.merge_sections(sections)
    exec_s, queue_s = la._bucket_sums(list(merged["recs"].values()))
    return la.telescope(merged["window_s"], exec_s, queue_s,
                        merged["comm_s"])


def test_tree_forwarded_edge_attributes_to_producer(tmp_path):
    """Chain broadcast on 3 ranks: rank 1 FORWARDS rank 0's activation
    to rank 2.  The forwarded frame's flow edge must attach to the
    producer's task node on rank 0 (the frame's root), not to a
    nonexistent task on the forwarder.  The JAX package's pipeline reads
    the port's traces to the same critical path."""
    from parsec_tpu.prof import critpath as jax_critpath
    from parsec_tpu_torch.prof import critpath
    prior = os.environ.get("PARSEC_MCA_COMM_COLL_BCAST")
    os.environ["PARSEC_MCA_COMM_COLL_BCAST"] = "chain"
    try:
        paths = W.run_port(W.traced_fanout, 3, args=(str(tmp_path),),
                           timeout=240)
    finally:
        if prior is None:
            os.environ.pop("PARSEC_MCA_COMM_COLL_BCAST", None)
        else:
            os.environ["PARSEC_MCA_COMM_COLL_BCAST"] = prior
    rows, _metas = critpath.merge_traces(paths)
    # rank 1's forward carries the producer's rank
    fwd = [r["info"] for r in rows
           if r["name"] == "comm_send" and r["rank"] == 1
           and r["info"].get("src_rank") == 0]
    assert fwd, "no forwarded activation traced on the relay rank"
    tasks, preds, _ready = critpath.build_dag(rows)
    b2 = [n for n, t in tasks.items()
          if t["name"] == "B" and t["rank"] == 2]
    assert b2, "consumer task missing from rank 2's trace"
    comm_in = [(pn, e) for pn, e in preds.get(b2[0], [])
               if e is not None]
    assert comm_in, "no flow edge into the forwarded consumer"
    assert any(tasks.get(pn, {}).get("name") == "A" and pn[0] == 0
               for pn, _e in comm_in), comm_in
    ref = jax_critpath.attribution(paths)
    att = critpath.attribution(paths)
    assert [(s["task"], s["rank"], s["via"]) for s in ref["path"]] == \
        [(s["task"], s["rank"], s["via"]) for s in att["path"]]


def test_online_split_matches_offline_attribution(tmp_path):
    """On the traced 2-rank rtt leg the ONLINE exec/queue/comm/idle split
    agrees with the offline ``critpath.attribute()`` decomposition within
    10 percentage points per bucket (offline coverage within 10% of 1),
    with the reference test's one retry.  Both halves are held to the
    JAX package on the same observations first: its critpath reads the
    port's trace files to the same buckets and makespan, and its
    liveattr merges the port's sections to the same online split."""
    from parsec_tpu.prof import critpath as jax_critpath
    from parsec_tpu.prof import liveattr as jax_la
    from parsec_tpu_torch.prof import critpath
    from parsec_tpu_torch.prof import liveattr as la_mod
    env = {"PARSEC_MCA_METRICS_SAMPLE": "1",
           "PARSEC_MCA_METRICS_QUEUE_WAIT": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    last = None
    try:
        # one retry: host-load noise can produce a pathological OFFLINE
        # trace (coverage far from 1) or smear one window
        for attempt in range(2):
            out = tmp_path / f"try{attempt}"
            out.mkdir()
            res = W.run_port(W.online_pingpong, 2, args=(str(out),),
                             timeout=240)
            paths = [r["path"] for r in res]
            offline = critpath.attribution(paths)
            ref = jax_critpath.attribution(paths)
            assert offline["makespan"] == ref["makespan"]
            assert offline["buckets"] == ref["buckets"]
            assert offline["coverage"] == ref["coverage"]
            sections = {i: r["section"] for i, r in enumerate(res)}
            online = _online_split(la_mod, copy.deepcopy(sections))
            assert online == _online_split(jax_la, sections)
            ms = offline["makespan"]
            last = (offline, online)
            if not 0.9 <= offline["coverage"] <= 1.1:
                continue     # unusable offline reference — re-trace
            deltas = {
                b: abs(offline["buckets"][b] / ms
                       - online[b] / online["elapsed"])
                for b in ("exec", "queue", "comm", "idle")}
            if all(d <= 0.10 for d in deltas.values()):
                return
        raise AssertionError(
            f"online split disagrees with offline attribution "
            f"beyond 10pp after retry: {last}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# the ETA of a running job (liveattr status surface)
# ---------------------------------------------------------------------------

def test_eta_quote_tracks_actual_completion():
    """ETA honesty end to end: a mid-run quote from the status surface
    of a JobService on the CPU-backed module lands within a small factor
    of the ACTUAL remaining wall time.  The quote is held to the JAX
    package on the same observation: its ``merge_sections`` and
    ``eta_seconds`` turn the quoted section and the status document's
    class rows into the same number.  A second run through the JAX
    package's JobService would quote from other timings, so the two
    quotes are not compared across runs."""
    from parsec_tpu.prof import liveattr as jax_la
    from parsec_tpu_torch.dsl.ptg.api import PTG, Range
    from parsec_tpu_torch.prof import liveattr as la_mod
    from parsec_tpu_torch.service.service import JobService

    def slow_pool(n=400, ms=3.0):
        p = PTG("slowjob", NT=n)
        p.task("W", k=Range(0, n - 1)).body(
            lambda: time.sleep(ms * 1e-3))
        return p.build()

    params.set("metrics_sample", 1)
    try:
        svc = JobService(nb_cores=2, device="cpu")
        try:
            job = svc.submit(lambda: (slow_pool(), lambda: "ok"),
                             name="eta")
            la = svc.context.metrics.liveattr
            quote = None
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                sections = {0: la.section()}
                doc = la_mod.build_status(svc.context, svc,
                                          copy.deepcopy(sections))
                js = [j for j in doc["jobs"] if j["job"] == job.job_id]
                if js and js[0]["status"] == "RUNNING" \
                        and js[0]["eta_s"] is not None \
                        and js[0]["progress"]["done"] >= 80:
                    quote = (time.monotonic(), js[0]["eta_s"])
                    break
                time.sleep(0.05)
            assert quote, "no mid-run ETA quote observed"
            # the reference's estimator on the quoted observation
            ctx = svc.context
            recs = jax_la.merge_sections(sections)["recs"]
            window = max(r.get("window_s", 0.0)
                         for (j, _c), r in recs.items() if j == job.job_id)
            classes = js[0]["progress"]["classes"]
            rows = [{"cls": cls, "pending": ent["pending"] or 0,
                     "done": ent["done"],
                     "mean_s": (ent.get("exec") or ent.get("lat")
                                or {}).get("mean_s", 0.0)}
                    for cls, ent in classes.items()]
            assert quote[1] == jax_la.eta_seconds(
                rows, js[0]["progress"]["remaining"],
                max(1, ctx.nranks) * max(1, len(ctx.streams)),
                done_total=sum(e["done"] for e in classes.values()),
                window_s=window)
            assert job.wait(timeout=120)
            actual = time.monotonic() - quote[0]
            # generous band: the quote must be the right ORDER
            assert 0.15 * actual <= quote[1] <= 5.0 * actual, (
                quote[1], actual)
        finally:
            svc.shutdown(timeout=15)
    finally:
        params.unset("metrics_sample")


# ---------------------------------------------------------------------------
# PINS iterators checker, trace sink interval
# ---------------------------------------------------------------------------

def test_iterators_checker_clean_run():
    """PINS iterators_checker (reference: mca/pins/iterators_checker):
    re-derived successor sets match the engine's deliveries on a real
    DAG, the potrf slice, in both packages, over the same tasks."""
    import parsec_tpu.apps.potrf as jax_potrf
    import parsec_tpu.core.context as jax_context
    import parsec_tpu.data.matrix as jax_matrix
    import parsec_tpu.prof.pins as jax_pins
    import parsec_tpu_torch.apps.potrf as port_potrf
    import parsec_tpu_torch.core.context as port_context
    import parsec_tpu_torch.data.matrix as port_matrix
    import parsec_tpu_torch.prof.pins as port_pins
    rng = np.random.default_rng(1)
    n = 32
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = a @ a.T + n * np.eye(n, dtype=np.float32)
    got = {}
    for pkg, ctx_mod, matrix, potrf, pins, kw in (
            ("jax", jax_context, jax_matrix, jax_potrf, jax_pins, {}),
            ("port", port_context, port_matrix, port_potrf, port_pins,
             {"device": "cpu"})):
        A = matrix.TwoDimBlockCyclic(mb=8, nb=8, lm=n, ln=n).from_array(
            spd.copy())
        chk = pins.IteratorsCheckerPins()
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            chk.install(ctx)
            ctx.add_taskpool(potrf.potrf_taskpool(A, device="cpu"))
            ctx.wait(timeout=120)
            chk.uninstall(ctx)
        assert chk.checked > 0 and chk.flagged == 0, (pkg, chk.display())
        got[pkg] = chk.checked
    assert got["port"] == got["jax"]


def test_interval_python_fallback_matches(monkeypatch):
    """The JAX package's StreamBuffer without its C sink degrades to two
    plain records; the port has no such tier (its StreamBuffer raises
    when the sink does not load — ROADMAP "No silent native tiers"), and
    its one-call interval gives the records the fallback gives."""
    import time as _time
    from parsec_tpu.prof import profiling as jax_prof
    from parsec_tpu_torch.native import NativeBuildError
    from parsec_tpu_torch.prof import profiling as port_prof
    sb = jax_prof.StreamBuffer(1, "t")
    sb._sink = None
    sb._sink_interval = None
    sb._native = None
    t0 = _time.perf_counter()
    sb.interval(5, 2, 10, 0, t0)
    ref = sb.merged_events()
    assert [e[1] for e in ref] == [jax_prof.EV_START, jax_prof.EV_END]
    assert ref[0][5] == t0 and ref[1][5] >= t0
    psb = port_prof.StreamBuffer(1, "t")
    psb.interval(5, 2, 10, 0, t0)
    got = psb.merged_events()
    assert [e[:5] for e in got] == [e[:5] for e in ref]
    assert got[0][5] == t0 and got[1][5] >= t0
    assert (port_prof.EV_START, port_prof.EV_END) == \
        (jax_prof.EV_START, jax_prof.EV_END)

    def no_sink():
        raise NativeBuildError("pinsext unavailable")
    import parsec_tpu_torch.native as native
    monkeypatch.setattr(native, "load_pinsext", no_sink)
    with pytest.raises(NativeBuildError):
        port_prof.StreamBuffer(2, "t")
