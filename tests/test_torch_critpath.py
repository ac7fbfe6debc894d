"""The port's causal trace pipeline (prof/causal.py, prof/critpath.py on
the pandas-free reader): twins of the single-rank tests of
tests/test_critpath.py, traced runs of the QR slice with chain fusion on
and of the potrf slice, and parity with the JAX package's pipeline.

The two-rank merged trace runs over the port's comm layer (its comm
events and clock table, the clock-offset estimator of the comm engine).
The DTD front-end's region lanes leave their ``dtd_lane`` events.

Parity: the same trace files through both packages' ``attribution``
(the JAX package's on pandas DataFrames) give the same critical path and
the same buckets.  On hand-built traces the buckets sum to the makespan
exactly; on traces of real CPU runs they sum to the makespan plus the
critical path's overlap (an async task's exec span ends after it
released its successors), to the buckets' rounding — the JAX package's
5% check of that sum is held on the card, by chip_smoke.py."""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.ptg import DATA, IN, OUT, PTG, Range, TASK
from parsec_tpu_torch.prof import critpath
from parsec_tpu_torch.prof.causal import install_causal_tracer
from parsec_tpu_torch.prof.pins import install_task_profiler
from parsec_tpu_torch.prof.profiling import (EV_END, EV_POINT, EV_START,
                                             Profile)
from parsec_tpu_torch.prof.reader import intervals, read_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- critical path on a synthetic hand-built DAG ----------------------------

def _mk_profile(rank, nranks, offsets=None):
    p = Profile(f"synth-r{rank}")
    p.add_information("rank", str(rank))
    p.add_information("nranks", str(nranks))
    if offsets:
        p.add_information("clock_offsets", json.dumps(offsets))
    return p


def _iv(p, sb, name, tpid, oid, t0, t1):
    k = p.add_event_class(name).key
    eid = p.next_event_id()
    sb.trace(k, EV_START, tpid, eid, oid, timestamp=t0)
    sb.trace(k, EV_END, tpid, eid, oid, timestamp=t1)


def _pt(p, sb, name, oid, ts, info, tpid=1):
    k = p.add_event_class(name).key
    sb.trace(k, EV_POINT, tpid, p.next_event_id(), oid, info,
             timestamp=ts)


def _synthetic_two_rank(tmp_path):
    p0 = _mk_profile(0, 2)
    w0 = p0.stream(0, "worker-0")
    c0 = p0.stream(800, "comm")
    _iv(p0, w0, "A", 1, 101, 0.0, 1.0)
    _iv(p0, w0, "B", 1, 102, 1.5, 3.0)
    _pt(p0, w0, "dep_edge", 101, 1.0, {"dst": 102})
    _pt(p0, c0, "comm_send", 101, 1.0,
        {"corr": (0, 1), "tag": 1, "dst": 1, "nbytes": 64})
    p1 = _mk_profile(1, 2, offsets={"0": 0.0})
    w1 = p1.stream(0, "worker-0")
    c1 = p1.stream(800, "comm")
    _pt(p1, c1, "comm_recv", 0, 1.2,
        {"corr": (0, 1), "tag": 1, "src": 0, "sent_at": 1.0,
         "nbytes": 64})
    _pt(p1, c1, "dep_deliver", 103, 1.2, {"corr": (0, 1)})
    _iv(p1, w1, "queue_wait", 1, 103, 1.4, 2.0)
    _iv(p1, w1, "C", 1, 103, 2.0, 5.0)
    return [p0.dump(str(tmp_path / "r0.ptt")),
            p1.dump(str(tmp_path / "r1.ptt"))]


def test_critpath_synthetic_known_path(tmp_path):
    """Hand-built 2-rank DAG with a known critical path A -> C (the
    cross-rank comm edge), a decoy local chain A -> B, and buckets that
    sum exactly to the makespan."""
    att = critpath.attribution(_synthetic_two_rank(tmp_path))
    names = [s["task"] for s in att["path"]]
    assert names == ["A", "C"], names          # not the decoy A -> B
    assert att["path"][0]["via"] == "local"
    assert att["path"][1]["via"] == "comm"
    b = att["buckets"]
    assert b["exec"] == pytest.approx(4.0)
    assert b["comm"] == pytest.approx(0.2)
    assert b["idle"] == pytest.approx(0.2)
    assert b["queue"] == pytest.approx(0.6)
    assert att["makespan"] == pytest.approx(5.0)
    assert att["coverage"] == pytest.approx(1.0)
    assert att["flows"] == {"sends": 1, "recvs": 1, "matched": 1}


def test_critpath_clock_offset_alignment(tmp_path):
    p0 = _mk_profile(0, 2)
    _iv(p0, p0.stream(0, "w"), "A", 1, 1, 0.0, 1.0)
    _pt(p0, p0.stream(800, "comm"), "comm_send", 1, 1.0,
        {"corr": (0, 1), "tag": 1, "dst": 1, "nbytes": 0})
    p1 = _mk_profile(1, 2, offsets={"0": -100.0})
    _pt(p1, p1.stream(800, "comm"), "dep_deliver", 2, 101.5,
        {"corr": (0, 1)})
    _iv(p1, p1.stream(0, "w"), "C", 1, 2, 102.0, 103.0)
    att = critpath.attribution([p0.dump(str(tmp_path / "a.ptt")),
                                p1.dump(str(tmp_path / "b.ptt"))])
    assert [s["task"] for s in att["path"]] == ["A", "C"]
    assert att["makespan"] == pytest.approx(3.0)
    assert att["buckets"]["comm"] == pytest.approx(0.5)   # 1.0 -> 1.5
    assert att["coverage"] == pytest.approx(1.0)


def test_synthetic_attribution_matches_the_jax_package(tmp_path):
    from parsec_tpu.prof import critpath as ref
    paths = _synthetic_two_rank(tmp_path)
    got = critpath.attribution(paths)
    # the port's one extra key: a hand-built path whose steps never overlap
    assert got.pop("overlap") == 0.0
    assert got == ref.attribution(paths)


def test_reader_tolerates_unknown_event_classes(tmp_path):
    """A trace whose dictionary misses a key (a newer writer's class) or
    carries extra dictionary fields still reads: unknown classes degrade
    to key<N> names."""
    import pickle
    import struct
    from parsec_tpu_torch.prof.profiling import MAGIC
    p = Profile("fwd")
    sb = p.stream(0, "w")
    k = p.add_event_class("KNOWN").key
    _iv_id = p.next_event_id()
    sb.trace(k, EV_START, 1, _iv_id, 7, timestamp=1.0)
    sb.trace(k, EV_END, 1, _iv_id, 7, timestamp=2.0)
    sb.trace(k + 57, EV_POINT, 1, p.next_event_id(), 0,
             {"new": True}, timestamp=1.5)    # class not in dictionary
    path = p.dump(str(tmp_path / "f.ptt"))
    raw = open(path, "rb").read()
    (mlen,) = struct.unpack_from("!Q", raw, 8)
    meta = pickle.loads(raw[16:16 + mlen])
    meta["dictionary"] = [(kk, nn, aa, {"future": 1})
                          for kk, nn, aa in meta["dictionary"]]
    mb = pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL)
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("!Q", len(mb)) + mb
                + raw[16 + mlen:])
    _meta2, rows = read_trace(path)
    assert {r["name"] for r in rows} == {"KNOWN", f"key{k + 57}"}
    assert [iv["duration"] for iv in intervals(rows)] == [1.0]


# -- single-rank causal spans on the port's runtime -------------------------

def _chain_pool(A, nt, device="cpu"):
    p = PTG("chain", NT=nt)
    p.task("S", k=Range(0, nt - 1)) \
        .affinity(lambda k, A=A: A(0, 0)) \
        .flow("T", "RW",
              IN(DATA(lambda A=A: A(0, 0)), when=lambda k: k == 0),
              IN(TASK("S", "T", lambda k: dict(k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("S", "T", lambda k, NT=nt: dict(k=k + 1)),
                  when=lambda k, NT=nt: k < NT - 1),
              OUT(DATA(lambda A=A: A(0, 0)),
                  when=lambda k, NT=nt: k == NT - 1)) \
        .body(lambda T: T + 1.0, device=device)
    return p.build()


def _traced_run(tmp_path, name, build, cores=2):
    prof = Profile(name)
    with Context(nb_cores=cores, device="cpu") as ctx:
        mod = install_task_profiler(ctx, prof)
        tr = install_causal_tracer(ctx, prof)
        tp = build()
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        mod.uninstall(ctx)
        tr.uninstall(ctx)
        # every device task finalized, so each fired its device_done
        assert not any(d._inflight or d._retire for d in
                       ctx.device_registry.accelerators), \
            "a device span never closed"
        stats = ctx.device_registry.accelerators[0].stats.as_dict()
    return prof.dump(str(tmp_path / f"{name}.ptt")), tp, stats


def test_causal_spans_single_rank(tmp_path):
    """Queue-wait and device spans land with the SAME object id as the
    task profiler's exec interval, so the per-task latency decomposes;
    local dep_edge events reconstruct the chain."""
    nt = 10
    A = TwoDimBlockCyclic(4, 4, 4, 4).from_array(torch.zeros(4, 4))
    path, _tp, _st = _traced_run(tmp_path, "c",
                                 lambda: _chain_pool(A, nt, "cuda"))
    meta, rows = read_trace(path)
    assert meta["info"]["rank"] == "0"
    iv = intervals(rows)
    ex = [i for i in iv if i["name"] == "S"]
    qw = [i for i in iv if i["name"] == "queue_wait"]
    dev = [i for i in iv if i["name"] == "dev:S"]
    assert len(ex) == nt and len(qw) == nt and len(dev) == nt
    oids = {i["object_id"] for i in ex}
    assert {i["object_id"] for i in qw} == oids
    assert {i["object_id"] for i in dev} == oids
    assert all(i["duration"] >= 0 for i in qw)
    assert all(i["duration"] > 0 for i in dev)
    edges = [r for r in rows if r["name"] == "dep_edge"]
    assert len(edges) == nt - 1              # the chain's local edges
    for r in rows:
        r["rank"] = 0
    path_, _att = _check_buckets(rows)
    assert len(path_) == nt


def test_dtd_lane_events_traced(tmp_path):
    """DTD region-lane operations leave dtd_lane events: per-lane writes,
    reads, and lane ids are all in the trace, write versions in
    insertion order."""
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, INOUT, INPUT, Region
    A = TwoDimBlockCyclic(4, 4, 4, 4).from_array(torch.zeros(4, 4))
    prof = Profile("dtd")
    top = Region("top", slices=(slice(0, 2),))
    bot = Region("bot", slices=(slice(2, 4),))
    with Context(nb_cores=2, device="cpu") as ctx:
        tr = install_causal_tracer(ctx, prof)
        tp = DTDTaskpool("lanes")
        ctx.add_taskpool(tp)
        ctx.start()
        t = tp.tile_of(A, 0, 0)
        for _ in range(3):
            tp.insert_task(lambda T: T + 1.0, (t, INOUT | top))
            tp.insert_task(lambda T: T + 2.0, (t, INOUT | bot))
        tp.insert_task(lambda T: None, (t, INPUT))
        tp.wait()
        tr.uninstall(ctx)
    _meta, rows = read_trace(prof.dump(str(tmp_path / "d.ptt")))
    lanes = [r["info"] for r in rows if r["name"] == "dtd_lane"]
    assert lanes
    ops = {i["op"] for i in lanes}
    assert "write" in ops and "read" in ops
    assert {"top", "bot"} <= {i["lane"] for i in lanes}
    top_vers = [i["ver"] for i in lanes
                if i["op"] == "write" and i["lane"] == "top"]
    assert top_vers == sorted(top_vers) and len(top_vers) == 3


def _check_buckets(rows):
    """The attribution of real (CPU) traces: its buckets sum to the
    makespan plus the path's overlap, exactly (to the buckets' 1e-6 s
    rounding).  The JAX package's 5%-of-the-makespan check is held on the
    card (chip_smoke.py), where tasks are long against the host's
    scheduling delays; on a loaded CPU the overlap alone exceeded it."""
    tasks, preds, ready = critpath.build_dag(rows)
    path = critpath.critical_path(tasks, preds)
    att = critpath.attribute(path, tasks, ready)
    over = att["overlap"]
    total = sum(att["buckets"].values())
    assert abs(total - att["makespan"] - over) <= 1e-5, (att, over)
    assert att["makespan"] > 0 and over >= 0
    return path, att


def test_path_overlap_identity_on_a_synthetic_overlap(tmp_path):
    """The identity on a hand-built trace: A's exec span runs 0.4 past B's
    ready time (B is released before A's completion closes A's span), so
    the buckets sum to the makespan plus 0.4."""
    p = _mk_profile(0, 1)
    w = p.stream(0, "w")
    _iv(p, w, "A", 1, 1, 0.0, 2.0)
    _pt(p, w, "dep_edge", 1, 1.6, {"dst": 2})
    _iv(p, w, "queue_wait", 1, 2, 1.6, 1.8)
    _iv(p, w, "B", 1, 2, 1.8, 3.0)
    rows, _m = critpath.merge_traces([p.dump(str(tmp_path / "o.ptt"))])
    path, att = _check_buckets(rows)
    assert [n["name"] for n, _e in path] == ["A", "B"]
    assert att["makespan"] == pytest.approx(3.0)
    assert sum(att["buckets"].values()) == pytest.approx(3.4)
    assert att["buckets"]["queue"] == pytest.approx(0.2)
    assert att["overlap"] == pytest.approx(0.4)


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _check_pairs(path, want_tasks):
    """Every exec and dev: span paired, one of each per task, and the
    critical path's buckets summing to the makespan."""
    _meta, rows = read_trace(path)
    starts = collections.Counter(r["name"] for r in rows
                                 if r["flags"] & EV_START)
    ends = collections.Counter(r["name"] for r in rows
                               if r["flags"] & EV_END)
    assert starts == ends
    iv = intervals(rows)
    assert len(iv) == sum(starts.values())          # nothing unpaired
    by = collections.Counter(i["name"] for i in iv)
    dev = {k[4:]: v for k, v in by.items() if k.startswith("dev:")}
    exe = {k: v for k, v in by.items()
           if k != "queue_wait" and not k.startswith("dev:")}
    assert exe == dev == want_tasks
    # one span of each kind per task: the exec and device spans of a task
    # share its object id, and no id repeats within a class
    for cls in want_tasks:
        e = [i["object_id"] for i in iv if i["name"] == cls]
        d = [i["object_id"] for i in iv if i["name"] == f"dev:{cls}"]
        assert len(set(e)) == len(e) and sorted(e) == sorted(d)
    rows, _metas = critpath.merge_traces([path])
    _cpath, att = _check_buckets(rows)
    assert att["ntasks"] == sum(want_tasks.values())
    return att


def test_traced_qr_slice_with_chains_pairs_every_span(tmp_path):
    """The QR slice at the device module's defaults: TSQRT/GEQRT panels
    are chain-held and run inside their consumer wave.  Their device span
    opens when the chain runs, so every task — held, chained or fused —
    has exactly one exec span and one dev: span."""
    from parsec_tpu_torch.apps.qr import qr_taskpool
    mb, nt = 8, 5
    n = mb * nt
    a = np.random.default_rng(22).standard_normal((n, n)).astype(np.float32)
    A = TwoDimBlockCyclic(mb, mb, n, n).from_array(
        torch.from_numpy(a.copy()))
    path, _tp, stats = _traced_run(tmp_path, "qr",
                                   lambda: qr_taskpool(A), cores=3)
    assert stats["chained_launches"] > 0 and stats["chained_tasks"] > 0
    want = {"GEQRT": nt, "UNMQR": nt * (nt - 1) // 2,
            "TSQRT": nt * (nt - 1) // 2,
            "TSMQR": sum(k * k for k in range(1, nt))}
    _check_pairs(path, want)
    R = np.triu(A.to_array().numpy()).astype(np.float64)
    ata = a.astype(np.float64).T @ a
    assert np.abs(R.T @ R - ata).max() / np.abs(ata).max() < 1e-4


def test_traced_potrf_slice_pairs_every_span(tmp_path):
    """The potrf slice at the defaults (waves fused, POTRF chained into
    its TRSM wave): one exec and one device span per task, and the
    single-rank critical path's buckets sum to the makespan."""
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    mb, nt = 8, 5
    n = mb * nt
    spd = _spd(n, 3)
    A = TwoDimBlockCyclic(mb, mb, n, n).from_array(
        torch.from_numpy(spd.copy()))
    path, _tp, stats = _traced_run(tmp_path, "potrf",
                                   lambda: potrf_taskpool(A), cores=3)
    assert stats["chained_launches"] > 0
    want = {"POTRF": nt - 1, "POTRFL": 1, "TRSM": nt * (nt - 1) // 2,
            "SYRK": nt * (nt - 1) // 2,
            "GEMM": nt * (nt - 1) * (nt - 2) // 6}
    att = _check_pairs(path, want)
    assert att["path"][-1]["task"] == "POTRFL"     # the last factor
    L = np.tril(A.to_array().numpy())
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-4, atol=1e-3)


def test_port_traces_attribute_alike_in_both_packages(tmp_path):
    """Parity on a real trace: a traced potrf run of the port, read by
    both packages' critpath (the JAX package's on DataFrames), gives the
    same critical path and buckets."""
    from parsec_tpu.prof import critpath as ref
    from parsec_tpu.prof.reader import intervals as ref_intervals
    from parsec_tpu.prof.reader import read_trace as ref_read
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    mb, nt = 8, 4
    n = mb * nt
    A = TwoDimBlockCyclic(mb, mb, n, n).from_array(
        torch.from_numpy(_spd(n, 5)))
    path, _tp, _st = _traced_run(tmp_path, "par",
                                 lambda: potrf_taskpool(A))
    got = critpath.attribution([path])
    want = ref.attribution([path])
    # the port's one extra key, which closes the buckets' sum
    over = got.pop("overlap")
    assert got == want
    assert sum(want["buckets"].values()) == pytest.approx(
        want["makespan"] + over, abs=1e-5)
    _m, rows = read_trace(path)
    _m, df = ref_read(path)
    assert intervals(rows) == ref_intervals(df).to_dict("records")


def test_critpath_cli_runs_as_a_module(tmp_path):
    """``python -m parsec_tpu_torch.prof.critpath`` on a trace: the text
    summary, and ``--json`` giving what ``attribution`` returns."""
    A = TwoDimBlockCyclic(4, 4, 4, 4).from_array(torch.zeros(4, 4))
    path, _tp, _st = _traced_run(tmp_path, "cli",
                                 lambda: _chain_pool(A, 6, "cuda"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m",
                        "parsec_tpu_torch.prof.critpath", path],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert "makespan:" in r.stdout and "critical path:" in r.stdout
    assert r.stdout.count("local") == 6
    r = subprocess.run([sys.executable, "-m",
                        "parsec_tpu_torch.prof.critpath", path, "--json"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout) == critpath.attribution([path])


# -- 2-rank loopback: the merged trace --------------------------------------

def test_two_rank_potrf_merged_trace(tmp_path):
    """A 2-rank potrf whose merged trace (a) matches a recv to every
    cross-rank activation send, (b) has clock offsets in the peer's
    header, (c) binds cross-rank deliveries to consumer tasks and puts
    a comm step on the critical path, with buckets summing to the
    makespan plus the path's overlap; the JAX package's attribution of
    the same files agrees."""
    import torch_comm_workers as W
    from parsec_tpu.prof import critpath as jax_critpath
    from parsec_tpu_torch.comm.engine import TAG_ACTIVATE
    paths = W.run_port(W.traced_potrf, 2, args=(str(tmp_path),),
                       timeout=240)
    rows, metas = critpath.merge_traces(paths)
    assert json.loads(metas[1]["info"]["clock_offsets"]).keys() == {"0"}
    act = {tuple(r["info"]["corr"]) for r in rows
           if r["name"] == "comm_send" and r["info"].get("tag") ==
           TAG_ACTIVATE}
    assert act, "no cross-rank activations traced"
    recv = {tuple(r["info"]["corr"]) for r in rows
            if r["name"] == "comm_recv"}
    assert act <= recv
    delivered = {tuple(r["info"]["corr"]) for r in rows
                 if r["name"] == "dep_deliver"
                 and r["info"].get("corr") is not None}
    assert delivered & act
    att = critpath.attribution(paths)
    assert att["makespan"] > 0
    assert any(s["via"] == "comm" for s in att["path"])
    total = sum(att["buckets"].values())
    assert abs(total - (att["makespan"] + att["overlap"])) <= \
        1e-5 * max(1.0, len(att["path"])), att
    ref = jax_critpath.attribution(paths)
    assert [(s["task"], s["rank"], s["via"]) for s in ref["path"]] == \
        [(s["task"], s["rank"], s["via"]) for s in att["path"]]
    for k, v in ref["buckets"].items():
        assert att["buckets"][k] == pytest.approx(v, abs=1e-5)
