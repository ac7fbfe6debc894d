"""The port's control-plane journal (prof/journal.py): twins of the
single-rank tests of tests/test_journal.py, and the journal on the
port's Context at its defaults.

The job-port pull is twinned on both packages; the recovery cases of
the JAX package's file (the flight-recorder bundle, the autopsy tail,
the retirement handshake, the recovery catalog) wait for those layers;
the two-rank pull over the comm layer's control lane is twinned; the auditor's corpus tests exercise tools/, not the
journal.  The port's dump is read back by the JAX package's own auditor
loader where the twin needs a reader, so both agree on the file format.
"""

import json
import os

import pytest

from parsec_tpu_torch.prof.journal import (EVENT_SCHEMA, Journal,
                                           cluster_journals, format_event,
                                           merge_journals)
from parsec_tpu_torch.utils.mca import params


# ---------------------------------------------------------------------------
# ring + emit discipline
# ---------------------------------------------------------------------------

def test_ring_bounded_and_stamps():
    j = Journal(rank=3, cap=128)
    for i in range(300):
        j.emit("retired", pool=i)
    assert len(j) == 128
    evs = j.tail(128)
    # oldest overwritten, stamps monotone
    assert evs[0]["pool"] == 300 - 128
    assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)
    assert all(e["inc"] == 0 and "t" in e for e in evs)


def test_disabled_journal_is_a_noop():
    params.set("journal_enabled", 0)
    try:
        j = Journal(rank=0)
        j.emit("retired", pool=1)
        assert len(j) == 0 and j.tail() == []
    finally:
        params.unset("journal_enabled")


def test_emit_normalizes_sets_for_the_wire():
    j = Journal(rank=0)
    j.emit("mode_decl", pool=1, round=2, mode="minimal",
           peers={2, 0, 1}, extra=frozenset({"b", "a"}))
    ev = j.tail(1)[0]
    assert ev["peers"] == [0, 1, 2]
    assert ev["extra"] == ["a", "b"]
    json.dumps(j.snapshot())   # must serialize as-is


def test_schema_table_well_formed():
    for etype, fields in EVENT_SCHEMA.items():
        assert isinstance(etype, str) and etype
        assert isinstance(fields, tuple)
        assert all(isinstance(f, str) for f in fields)
    # the round-scoped protocol families all demand round attribution
    for etype in ("mode_decl", "mode_vote", "mode_result", "skip_offer",
                  "skip_cut", "need_send", "need_round"):
        assert "round" in EVENT_SCHEMA[etype], etype


def test_schema_table_is_the_jax_packages():
    """The schema is the contract the JAX package's auditor checks: the
    port's table is the same, type for type and field for field."""
    from parsec_tpu.prof.journal import EVENT_SCHEMA as REF
    assert EVENT_SCHEMA == REF


def _load_jsonl(path):
    """One snapshot per ``{"h": header}`` line, followed by its events
    (the dump format)."""
    snaps = []
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if "h" in rec:
                snaps.append(dict(rec["h"], events=[]))
            else:
                snaps[-1]["events"].append(rec)
    return snaps


def test_dump_appends_and_loads_roundtrip(tmp_path):
    j = Journal(rank=2, cap=64)
    j.emit("epoch_fence", pool=1, epoch=1)
    path = j.dump(str(tmp_path))
    j.emit("retired", pool=1)
    assert j.dump(str(tmp_path)) == path
    snaps = _load_jsonl(path)
    assert len(snaps) == 2            # one header per dump, appended
    assert len(snaps[0]["events"]) == 1
    assert len(snaps[1]["events"]) == 2   # ring re-dumped whole
    assert os.path.basename(path) == "journal-rank2.jsonl"


def test_dump_reads_back_through_the_jax_packages_auditor(tmp_path):
    """The port's bundle is one the JAX package's journal auditor loads:
    same file name, header and event lines."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools import journal_audit
    j = Journal(rank=1, cap=64)
    j.emit("health_transition", peer=1, frm="ok", to="degraded",
           score=0.7)
    path = j.dump(str(tmp_path))
    assert journal_audit.load_file(path) == _load_jsonl(path)
    per_rank = journal_audit.load_bundle([str(tmp_path)])
    assert sorted(per_rank) == [1]


# ---------------------------------------------------------------------------
# clock-aligned merge
# ---------------------------------------------------------------------------

def _snap(rank, events, clock=None, inc=0):
    return {"rank": rank, "inc": inc, "nranks": 2, "wall": 0.0,
            "perf": 0.0, "clock": clock or {}, "events": events}


def test_merge_aligns_on_reference_clock():
    """Rank 1's clock runs 100 s ahead; its own measured offset to
    rank 0 (clock_0 - clock_1 = -100) must pull its events back onto
    rank 0's timeline so causality reads correctly."""
    e0 = [{"e": "skip_cut", "t": 5.0, "seq": 1, "inc": 0, "pool": 1,
           "round": 1, "prefix": 3}]
    e1 = [{"e": "skip_offer", "t": 104.0, "seq": 1, "inc": 0,
           "pool": 1, "round": 1, "frontier": 4}]
    merged = merge_journals({
        0: _snap(0, e0),
        1: _snap(1, e1, clock={0: {"offset": -100.0, "rtt": 0.001}})})
    assert [m["e"] for m in merged] == ["skip_offer", "skip_cut"]
    assert abs(merged[0]["t"] - 4.0) < 1e-9
    assert merged[0]["rank"] == 1
    line = format_event(merged[0], t0=merged[0]["t"])
    assert "skip_offer" in line and "rank 1" in line


def test_merge_falls_back_to_reference_measurement():
    """No own-table entry: the reference's measurement of the peer is
    negated (offset = clock_peer - clock_ref)."""
    e1 = [{"e": "retired", "t": 107.0, "seq": 1, "inc": 0, "pool": 9}]
    merged = merge_journals({
        0: _snap(0, [], clock={1: {"offset": 100.0, "rtt": 0.001}}),
        1: _snap(1, e1)})
    assert abs(merged[0]["t"] - 7.0) < 1e-9
    # JSON round-trip stringifies clock keys; alignment must survive
    rt = json.loads(json.dumps(
        {0: _snap(0, [], clock={1: {"offset": 100.0}}), 1: _snap(1, e1)}))
    merged2 = merge_journals({int(r): s for r, s in rt.items()})
    assert abs(merged2[0]["t"] - 7.0) < 1e-9


def test_merge_and_format_agree_with_the_jax_package():
    """Parity: the same per-rank snapshots merge to the same timeline and
    format to the same lines in both packages."""
    from parsec_tpu.prof import journal as ref
    per_rank = {
        0: _snap(0, [{"e": "retired", "t": 3.0, "seq": 1, "inc": 0,
                      "pool": 4}],
                 clock={1: {"offset": 2.5, "rtt": 0.01}}),
        1: _snap(1, [{"e": "epoch_fence", "t": 4.0, "seq": 1, "inc": 1,
                      "pool": 4, "epoch": 2},
                     {"e": "retired", "t": 6.0, "seq": 2, "inc": 1,
                      "pool": 4}]),
        2: _snap(2, [{"e": "barrier", "t": 1.0, "seq": 1, "inc": 0,
                      "gen": 3, "outcome": "ok"}],
                 clock={0: {"offset": 0.5, "rtt": 0.02}}),
    }
    got = merge_journals(per_rank)
    want = ref.merge_journals(per_rank)
    assert got == want
    assert [format_event(e, 1.0) for e in got] == \
        [ref.format_event(e, 1.0) for e in want]


# ---------------------------------------------------------------------------
# the journal on the port's Context
# ---------------------------------------------------------------------------

def _n_pool(n, name="jpool"):
    from parsec_tpu_torch.dsl.ptg import PTG, Range
    p = PTG(name, N=n)
    p.task("T", i=Range(0, n - 1)).body(lambda: None)
    return p.build()


def test_journal_installed_at_the_defaults_and_dumped_at_fini(tmp_path):
    """Every Context carries an enabled journal (``journal_enabled`` 1),
    and with ``journal_dir`` set its fini appends the rank's bundle."""
    from parsec_tpu_torch.core.context import Context
    params.set("journal_dir", str(tmp_path))
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            assert isinstance(ctx.journal, Journal)
            assert ctx.journal.enabled and ctx.journal.rank == 0
            ctx.add_taskpool(_n_pool(20))
            ctx.wait(timeout=60)
            # no per-task emits: a run leaves the ring as it was
            assert len(ctx.journal) == 0
            ctx.journal.emit("retired", pool=1)
    finally:
        params.unset("journal_dir")
    snaps = _load_jsonl(str(tmp_path / "journal-rank0.jsonl"))
    assert len(snaps) == 1 and snaps[0]["rank"] == 0
    assert [e["e"] for e in snaps[0]["events"]] == ["retired"]


def test_disabled_journal_skips_fini_dump(tmp_path):
    """At ``journal_enabled`` 0 the port installs no journal and dumps
    nothing at fini: a header-only file would let an audit pass
    vacuously over zero events."""
    from parsec_tpu_torch.core.context import Context
    params.set("journal_enabled", 0)
    params.set("journal_dir", str(tmp_path))
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            assert ctx.journal is None
        assert os.listdir(str(tmp_path)) == []
    finally:
        params.unset("journal_enabled")
        params.unset("journal_dir")


def test_health_transitions_land_in_the_context_journal():
    """The port's one emit site: the health plane journals its state
    transitions into the Context's journal, with the observed rank in
    ``peer``."""
    import time
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=1, device="cpu") as ctx:
        hm = ctx.metrics.health
        now = time.monotonic()
        with hm._lock:
            for s in (0.9, 0.4, 0.1, 0.05, 0.01):
                hm._observe_locked(0, s, now)
        evs = [e for e in ctx.journal.tail(64)
               if e["e"] == "health_transition"]
    assert evs and all(e["peer"] == 0 for e in evs)
    assert set(EVENT_SCHEMA["health_transition"]) <= set(evs[0])


def test_cluster_journals_local_view_and_multi_rank_refusal():
    """One rank: the local snapshot.  Several ranks with no comm engine
    attached: the pull has nothing to ride, so it degrades to the local
    view (it refused, with NotImplementedError, while the port had no
    comm layer; the pull itself is the two-rank test below)."""
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=1, device="cpu") as ctx:
        ctx.journal.emit("retired", pool=3)
        per_rank = cluster_journals(ctx)
        assert list(per_rank) == [0]
        assert [e["e"] for e in per_rank[0]["events"]] == ["retired"]

    class _TwoRanks:
        rank, nranks, journal, comm = 0, 2, Journal(rank=0), None
    assert list(cluster_journals(_TwoRanks())) == [0]


def test_two_rank_journal_pull_over_control_lane():
    """Rank 0 pulls rank 1's journal over TAG_METRICS: the peer's
    barrier rounds crossed the wire, in both packages."""
    import torch_comm_workers as W
    j, p = W.run_both(W.journal_pull, 2, timeout=180)
    for res in (p, j):
        assert res[0]["ranks"] == [0, 1]
        assert "barrier" in res[0]["peer_kinds"], res
    assert p[0]["peer_kinds"] == j[0]["peer_kinds"]


def test_journal_op_on_job_server():
    """The framed ``{"op": "journal"}`` pull returns this rank's snapshot
    with the job lifecycle on the record, as the JAX package's does on
    the same job."""
    import parsec_tpu.core.context as jax_context
    import parsec_tpu.dsl.ptg as jax_ptg
    import parsec_tpu.service.server as jax_server
    import parsec_tpu.service.service as jax_service
    import parsec_tpu_torch.core.context as port_context
    import parsec_tpu_torch.service.server as port_server
    import parsec_tpu_torch.service.service as port_service

    def jax_pool():
        p = jax_ptg.PTG("jpool", N=8)
        p.task("T", i=jax_ptg.Range(0, 7)).body(lambda: None)
        return p.build()

    got = {}
    for side, ctxmod, srv, svcmod, pool, kw in (
            ("jax", jax_context, jax_server, jax_service, jax_pool, {}),
            ("port", port_context, port_server, port_service,
             lambda: _n_pool(8), {"device": "cpu"})):
        with ctxmod.Context(nb_cores=2, **kw) as ctx:
            svc = svcmod.JobService(context=ctx)
            server = srv.JobServer(svc, port=0)
            try:
                job = svc.submit(pool, name="boxed")
                assert job.wait(timeout=30)
                reply = srv.request(server.host, server.port,
                                    {"op": "journal"})
            finally:
                server.close()
                svc.shutdown(timeout=10.0)
        snap = reply["ranks"]["0"]
        jobs = [(e["e"], e["job"], e.get("status"))
                for e in snap["events"] if e["e"].startswith("job_")]
        got[side] = (reply["ok"], sorted(reply["ranks"]), jobs)
    assert got["port"] == got["jax"]
    assert got["port"] == (True, ["0"], [("job_admit", 1, None),
                                         ("job_start", 1, None),
                                         ("job_done", 1, "done")])


# ---------------------------------------------------------------------------
# the journal in incident bundles, the autopsy tail, degraded retirement
# ---------------------------------------------------------------------------

def _ctx(**kw):
    from parsec_tpu_torch.core.context import Context
    return Context(device="cpu", **kw)


def test_flightrec_bundle_includes_journal(tmp_path):
    """Every incident bundle carries the control-plane story next to
    the data-plane ring (read back by the port's journal auditor)."""
    import time
    from parsec_tpu_torch.tools import journal_audit
    params.set("flightrec_enabled", 1)
    params.set("flightrec_dir", str(tmp_path))
    params.set("flightrec_min_interval_s", 0.0)
    try:
        with _ctx(nb_cores=2) as ctx:
            ctx.journal.emit("epoch_fence", pool=7, epoch=1)
            bundle = ctx.telemetry_incident("unit-test incident")
            assert bundle == str(tmp_path)
            jpath = os.path.join(bundle, "journal-rank0.jsonl")
            deadline = time.monotonic() + 10.0
            found = False
            while not found and time.monotonic() < deadline:
                if os.path.exists(jpath):
                    try:
                        snaps = journal_audit.load_file(jpath)
                        found = any(
                            e["e"] == "epoch_fence" and e["pool"] == 7
                            for s in snaps for e in s["events"])
                    except (ValueError, OSError):
                        pass   # torn mid-append read
                if not found:
                    time.sleep(0.05)
            assert found
    finally:
        params.unset("flightrec_enabled")
        params.unset("flightrec_dir")
        params.unset("flightrec_min_interval_s")


def test_autopsy_prints_clock_aligned_journal_tail():
    with _ctx(nb_cores=2) as ctx:
        ctx.journal.emit("retired", pool=3)
        text = ctx.hang_autopsy()
    assert "control-plane journal tail" in text
    assert "retired" in text and "pool=3" in text


def test_retire_degraded_counted_and_journaled():
    """A completed pool whose retirement handshake never concluded
    (coordinator unreachable) falls back to the grace-window eviction —
    counted in parsec_recovery_retire_degraded_total and journaled."""
    import time
    import torch
    from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic
    params.set("recovery_enable", 1)
    params.set("recovery_completed_grace_s", 0.05)
    try:
        with _ctx(nb_cores=2) as ctx:
            rec = ctx.recovery
            assert rec is not None

            class _StubCE:
                nranks = 2
                rank = 0
                dead_peers = ()

                def send_am(self, *a, **k):
                    raise OSError("coordinator unreachable")

            class _StubRDE:
                ce = _StubCE()

                def recovery_coordinator(self):
                    return 1   # someone else, and unreachable

            rec._rde = _StubRDE()
            V = VectorTwoDimCyclic(mb=4, lm=16, nodes=1, myrank=0)
            for m, _ in V.local_tiles():
                V.data_of(m).copy_on(0).payload.copy_(torch.zeros(4))
            tp = _n_pool(4, name="degrader")
            tp.recovery_collections = [V]
            ctx.add_taskpool(tp, start=True)
            ctx.wait(timeout=30)
            time.sleep(0.1)        # past the shrunk grace window
            with rec._lock:
                rec._sweep_locked()
            assert rec.retire_degraded == 1
            assert rec.stats()["retire_degraded"] == 1
            kinds = [e["e"] for e in ctx.journal.tail(50)]
            assert "retire_report" in kinds
            assert "retire_degraded" in kinds
            fams = {s["n"]: s["v"] for s in rec._collect()
                    if s["t"] == "counter" and not s["l"]}
            assert fams["parsec_recovery_retire_degraded_total"] == 1
    finally:
        params.unset("recovery_enable")
        params.unset("recovery_completed_grace_s")

