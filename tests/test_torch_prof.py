"""The port's tracing and PINS layer (prof/profiling.py, prof/pins.py,
prof/gauges.py, prof/reader.py, utils/properties.py, utils/info.py and
the pinsext trace sink): twins of the single-rank tests of
tests/test_prof.py, and parity with the JAX package's tracer.

The gauge aggregator's twins run each script through both packages'
aggregators, and the DOT grapher's twins each DAG through both
packages' graphers.  Left out: the tools/ trace CLIs.  The JAX package's test
of its Python event path has no twin: the port has no such tier, and a
pinsext that does not build raises (tested here) instead.

Parity: the same DAG on seeded inputs, traced by the task profiler and
the causal tracer in both packages, gives the same number of events per
class name and the same paired intervals; the JAX package's reader
builds DataFrames, converted here with ``to_dict("records")``.
"""

import collections
import os

import numpy as np
import pytest
import torch

from parsec_tpu_torch import native
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.ptg import DATA, IN, OUT, PTG, Range, TASK
from parsec_tpu_torch.prof import (install_gauges, install_task_profiler,
                                   profiling_init, read_trace)
from parsec_tpu_torch.prof.reader import intervals
from parsec_tpu_torch.utils.mca import params


def _chain_pool(A, nt, device="cpu", ptg=None):
    if ptg is None:
        import parsec_tpu_torch.dsl.ptg as ptg
    p = ptg.PTG("chain", NT=nt)
    p.task("S", k=ptg.Range(0, nt - 1)) \
        .affinity(lambda k, A=A: A(0, 0)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda A=A: A(0, 0)), when=lambda k: k == 0),
              ptg.IN(ptg.TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              ptg.OUT(ptg.TASK("S", "T", lambda k, NT=nt: dict(k=k + 1)),
                      when=lambda k, NT=nt: k < NT - 1),
              ptg.OUT(ptg.DATA(lambda A=A: A(0, 0)),
                      when=lambda k, NT=nt: k == NT - 1)) \
        .body(lambda T: T + 1.0, device=device)
    return p.build()


def _zero_tile():
    return TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4).from_array(
        torch.zeros(4, 4))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_trace_intervals_complete(tmp_path, device):
    """Every executed task appears as one START/END pair with positive
    duration — including ASYNC device tasks, which the CPU-backed device
    module completes on its completer thread."""
    nt = 12
    A = _zero_tile()
    prof = profiling_init("test")
    with Context(nb_cores=2, device="cpu") as ctx:
        mod = install_task_profiler(ctx, prof, with_locals=True)
        ctx.add_taskpool(_chain_pool(A, nt, device))
        ctx.wait()
        mod.uninstall(ctx)
    path = prof.dump(str(tmp_path / "trace.ptt"))
    meta, rows = read_trace(path)
    assert meta["hr_id"] == "test"
    ivs = intervals(rows)
    assert len(ivs) == nt                       # one interval per task
    assert all(iv["duration"] > 0 for iv in ivs)
    assert {iv["name"] for iv in ivs} == {"S"}
    # info payloads carry the task parameters
    ks = sorted(iv["info"]["locals"]["k"] for iv in ivs)
    assert ks == list(range(nt))
    assert float(A.to_array()[0, 0]) == nt


def test_gauges_track_lifecycle():
    nt = 9
    A = _zero_tile()
    with Context(nb_cores=2, device="cpu") as ctx:
        g = install_gauges(ctx)
        ctx.add_taskpool(_chain_pool(A, nt))
        ctx.wait()
        snap = g.snapshot()
        g.uninstall(ctx)
    assert snap["tasks_retired"] == nt
    assert snap["tasks_enabled"] == nt
    assert snap["pending_tasks"] == 0


def test_gauges_read_the_device_module_stats():
    nt = 6
    A = _zero_tile()
    with Context(nb_cores=2, device="cpu") as ctx:
        g = install_gauges(ctx)
        ctx.add_taskpool(_chain_pool(A, nt, "cuda"))
        ctx.wait()
        snap = g.snapshot()
        (dev,) = ctx.device_registry.accelerators
        g.uninstall(ctx)
    assert snap["device_tasks"] == dev.stats.executed_tasks == nt
    assert snap["device_bytes_in"] == dev.stats.bytes_in > 0


def test_trace_roundtrip_dictionary_and_streams(tmp_path):
    prof = profiling_init("dicts")
    prof.add_information("who", "tester")
    sb = prof.stream(7, "custom")
    ec = prof.add_event_class("MYEV", "u64:val")
    sb.trace(ec.key, 4, 1, 1, 0, info={"val": 42})
    path = prof.dump(str(tmp_path / "t.ptt"))
    meta, rows = read_trace(path)
    assert meta["info"]["who"] == "tester"
    assert all(r["name"] == "MYEV" for r in rows)
    assert rows[0]["info"] == {"val": 42}
    assert rows[0]["stream"] == 7


def test_trace_reads_back_through_the_jax_packages_reader(tmp_path):
    """The port writes the JAX package's .ptt format: its reader loads
    the port's trace into the same rows the port's reader gives."""
    from parsec_tpu.prof.reader import read_trace as ref_read
    from parsec_tpu_torch.prof.profiling import EV_END, EV_POINT, \
        EV_START, Profile
    p = Profile("fmt")
    sb = p.stream(3, "w")
    k = p.add_event_class("X").key
    sb.trace(k, EV_START, 2, 1, 11, timestamp=1.0)
    sb.trace(k, EV_END, 2, 1, 11, timestamp=2.5)
    sb.trace(k, EV_POINT, 2, 2, 0, {"a": [1, 2]}, timestamp=1.5)
    sb.interval(k, 2, 3, 12, 3.0)
    path = p.dump(str(tmp_path / "f.ptt"))
    meta, rows = read_trace(path)
    ref_meta, df = ref_read(path)
    assert meta == ref_meta
    assert rows == df.to_dict("records")


def test_pins_mca_selection(capfd):
    """``pins`` installs named instrumentation modules at context init
    (reference: the pins framework module list, pins_init.c); unknown
    names warn instead of failing, and each module's stats are displayed
    at fini."""
    from parsec_tpu_torch.prof.pins import StealCounterPins
    params.set("pins", "print_steals,nosuchmodule")
    try:
        V = TwoDimBlockCyclic(2, 1, 8, 1).from_array(torch.zeros(8, 1))
        p = PTG("pinsrun", NT=4)
        p.task("T", k=Range(0, 3)) \
            .affinity(lambda k, V=V: V(k, 0)) \
            .flow("X", "RW", IN(DATA(lambda k, V=V: V(k, 0))),
                  OUT(DATA(lambda k, V=V: V(k, 0)))) \
            .body(lambda X: X + 1.0)
        with Context(nb_cores=2, device="cpu") as ctx:
            mods = ctx._pins_modules
            assert len(mods) == 1 and isinstance(mods[0], StealCounterPins)
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=60)
            assert sum(mods[0].selects.values()) >= 4
            assert "selects total=" in mods[0].display()
        assert ctx._pins_modules == []          # uninstalled at fini
        assert not ctx._pins.get("select")
    finally:
        params.unset("pins")
    err = capfd.readouterr().err
    assert "nosuchmodule" in err          # warned, not failed
    assert "StealCounterPins" in err      # stats displayed at fini


def test_all_three_pins_modules_run_the_potrf_slice_clean():
    """``pins=print_steals,alperf,iterators_checker`` installs the three
    modules of the reference's list, and the potrf slice with device
    bodies runs clean under them: every delivery the checker re-derives
    was made, the gauges retire every task, the selects are counted."""
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    from parsec_tpu_torch.prof.pins import (GaugesPins,
                                            IteratorsCheckerPins,
                                            StealCounterPins)
    rng = np.random.default_rng(1)
    n = 32
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = a @ a.T + n * np.eye(n, dtype=np.float32)
    A = TwoDimBlockCyclic(8, 8, n, n).from_array(
        torch.from_numpy(spd.copy()))
    params.set("pins", "print_steals,alperf,iterators_checker")
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            steals, gauges, chk = ctx._pins_modules
            assert isinstance(steals, StealCounterPins)
            assert isinstance(gauges, GaugesPins)
            assert isinstance(chk, IteratorsCheckerPins)
            ctx.add_taskpool(potrf_taskpool(A))
            ctx.wait(timeout=120)
            snap = gauges.gauges.snapshot()
    finally:
        params.unset("pins")
    ntasks = 4 + 6 + 6 + 4          # nt=4: POTRF+POTRFL, TRSM, SYRK, GEMM
    assert chk.checked == ntasks and chk.flagged == 0, chk.display()
    assert snap["tasks_retired"] == ntasks and snap["pending_tasks"] == 0
    assert snap["device_tasks"] == ntasks
    assert sum(steals.selects.values()) == ntasks
    L = np.tril(A.to_array().numpy())
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-4, atol=1e-3)


def test_properties_dictionary_runtime_and_taskpool():
    """Properties dictionary (reference: parsec/dictionary.c): live device
    counters and taskpool class properties readable by path."""
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    rng = np.random.default_rng(0)
    n = 32
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = a @ a.T + n * np.eye(n, dtype=np.float32)
    A = TwoDimBlockCyclic(8, 8, n, n).from_array(torch.from_numpy(spd))
    with Context(nb_cores=2, device="cpu") as ctx:
        ps = ctx.properties
        assert ps.lookup("runtime/nranks") == 1
        assert ps.lookup("runtime/nb_cores") == 2
        assert ps.lookup("runtime/scheduler") == "NativeSched"
        dev_paths = [p for p in ps.paths("runtime/devices")
                     if p.endswith("/executed_tasks")]
        assert dev_paths, "no device counters registered"
        before = sum(ps.lookup(p) for p in dev_paths)
        ctx.add_taskpool(potrf_taskpool(A))
        flops = ps.lookup("taskpool/potrf/classes/GEMM/flops")
        assert flops == 2.0 * 8 ** 3
        assert ps.lookup("taskpool/potrf/nb_tasks") is not None
        ctx.wait(timeout=120)
        after = sum(ps.lookup(p) for p in dev_paths)
        assert after - before == 20, "live counters did not advance"
        (dev,) = ctx.device_registry.accelerators
        base = f"runtime/devices/{dev.name}"
        assert ps.lookup(f"{base}/kind") == "cuda"
        for field in ("executed_tasks", "bytes_in", "bytes_out", "faults",
                      "evictions", "fused_launches", "fused_tasks"):
            assert ps.lookup(f"{base}/{field}") == getattr(dev.stats, field)
        assert ps.lookup(f"{base}/load") == dev.load
        tree = ps.tree("taskpool/potrf/classes")
        assert any(p.endswith("POTRF/flops") for p in tree)


def test_property_keys_match_the_jax_package():
    """Parity: the same potrf pool on both packages registers the same
    property paths, the device segment aside (device names differ by
    design)."""
    import parsec_tpu.core.context as jax_context
    import parsec_tpu.data.matrix as jax_matrix
    from parsec_tpu.apps.potrf import potrf_taskpool as ref_potrf
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    n = 32

    def shape(ps, devs):
        out = set()
        for p in ps.paths():
            parts = p.split("/")
            if parts[:2] == ["runtime", "devices"]:
                kind = devs[parts[2]]
                parts[2] = "<host>" if kind == "cpu" else "<accelerator>"
            out.add("/".join(parts))
        return out

    with Context(nb_cores=1, device="cpu") as ctx:
        ctx.add_taskpool(potrf_taskpool(TwoDimBlockCyclic(8, 8, n, n)))
        got = shape(ctx.properties,
                    {d.name: d.kind for d in ctx.device_registry.devices})
        ctx.wait(timeout=60)
    with jax_context.Context(nb_cores=1) as rctx:
        rctx.add_taskpool(ref_potrf(jax_matrix.TwoDimBlockCyclic(
            8, 8, n, n).from_array(np.eye(n, dtype=np.float32))))
        ref = shape(rctx.properties,
                    {d.name: d.kind for d in rctx.device_registry.devices})
        rctx.wait(timeout=120)
    assert got == ref


def test_info_arrays_hang_off_taskpools_and_devices():
    """Per-object info slots (reference: class/info.h) on the port's
    taskpools and device modules, with lazy per-object constructors."""
    from parsec_tpu_torch.utils.info import device_info, taskpool_info
    iid = taskpool_info.register("test_tp_slot", lambda tp: tp.name + "!")
    did = device_info.register("test_dev_slot", lambda d: d.kind)
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            tp = _chain_pool(_zero_tile(), 2)
            assert tp.info.get("test_tp_slot") == "chain!"
            assert tp.info.get(iid) == "chain!"
            (dev,) = ctx.device_registry.accelerators
            assert dev.info.get(did) == "cuda"
            dev.info.set("test_dev_slot", "set")
            assert dev.info.get("test_dev_slot") == "set"
            assert ctx.device_registry.host.info.get(did) == "cpu"
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
    finally:
        taskpool_info.unregister("test_tp_slot")
        device_info.unregister("test_dev_slot")


def test_iterators_checker_catches_lost_delivery():
    """Negative: a seeded mis-delivery (one delivery the checker never
    sees) is flagged as a context error."""
    from parsec_tpu_torch.prof.pins import IteratorsCheckerPins
    V = TwoDimBlockCyclic(2, 1, 8, 1).from_array(torch.zeros(8, 1))
    dropped = {"n": 0}
    chk = IteratorsCheckerPins()
    p = PTG("chain", NT=4)
    p.task("T", k=Range(0, 3)) \
        .affinity(lambda k, V=V: V(k, 0)) \
        .flow("X", "RW",
              IN(DATA(lambda k, V=V: V(k, 0)), when=lambda k: k == 0),
              IN(TASK("T", "X", lambda k: dict(k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("T", "X", lambda k: dict(k=k + 1)),
                  when=lambda k: k < 3),
              OUT(DATA(lambda k, V=V: V(k, 0)), when=lambda k: k == 3)) \
        .body(lambda X: X + 1.0)
    real_deliver = chk._deliver

    def lossy_record(es, event, payload):
        _task, _tc, succ_locals, _fl = payload
        if succ_locals.get("k") == 2 and not dropped["n"]:
            dropped["n"] += 1
            return               # the checker never sees this delivery
        real_deliver(es, event, payload)
    chk._deliver = lossy_record

    with Context(nb_cores=2, device="cpu") as ctx:
        ctx.pins_register("deliver_dep", chk._deliver)
        ctx.pins_register("complete_exec", chk._complete)
        ctx.add_taskpool(p.build())
        with pytest.raises(RuntimeError) as exc:
            ctx.wait(timeout=60)
        assert "iterators_checker" in str(exc.value.__cause__)
    assert dropped["n"] == 1 and chk.flagged >= 1


# ---------------------------------------------------------------------------
# the pinsext trace sink
# ---------------------------------------------------------------------------

def test_pinsext_builds_into_the_build_directory():
    px = native.load_pinsext()
    assert px.__name__ == "parsec_tpu_torch_pinsext"
    assert os.path.dirname(px.__file__) == native._BUILD
    assert os.path.basename(px.__file__) == "parsec_tpu_torch_pinsext.so"
    assert not [f for f in os.listdir(native._HERE) if f.endswith(".so")]


def test_interval_single_crossing_pairs_edges():
    """Both edges of a task interval ride ONE C call (pinsext interval):
    the START record carries the caller's begin timestamp, the END a
    C-side stamp, paired by event id."""
    import time
    from parsec_tpu_torch.prof.profiling import EV_END, EV_START, Profile
    prof = Profile()
    sb = prof.stream(0, "t")
    t0 = time.perf_counter()
    sb.interval(7, 3, 42, 99, t0)
    t1 = time.perf_counter()
    evs = sb.merged_events()
    assert len(evs) == 2
    (k1, f1, tp1, e1, o1, ts1, _i1), (k2, f2, tp2, e2, o2, ts2, _i2) = evs
    assert (k1, tp1, e1, o1) == (7, 3, 42, 99)
    assert (k2, tp2, e2, o2) == (7, 3, 42, 99)
    assert f1 == EV_START and f2 == EV_END
    assert ts1 == t0 and t0 <= ts2 <= t1 + 1e-4   # perf_counter's clock
    assert sb.merged_events() == evs               # drain is idempotent


def _no_cached_pinsext(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cexts", {})
    monkeypatch.setattr(native, "_pinsext", None)


def test_a_pinsext_that_does_not_build_makes_profile_raise(tmp_path,
                                                          monkeypatch):
    """No silent tier: where the JAX package falls back to slower tracer
    paths, a pinsext that does not build raises NativeBuildError with the
    compiler's message, from the Profile that needs it."""
    from parsec_tpu_torch.prof.profiling import Profile
    _no_cached_pinsext(monkeypatch, tmp_path)
    (tmp_path / "pinsext.c").write_text("this is not C;\n")
    with pytest.raises(native.NativeBuildError, match="pinsext.c"):
        Profile("broken")
    with pytest.raises(native.NativeBuildError):   # the failure is cached
        profiling_init("broken again")


def test_a_sink_off_perf_counters_clock_raises(tmp_path, monkeypatch):
    """A sink whose clock is not perf_counter's timeline would put C- and
    Python-stamped events on two clocks: load_pinsext raises."""
    _no_cached_pinsext(monkeypatch, tmp_path)

    class _Skewed:
        @staticmethod
        def now():
            return -1.0e9
    monkeypatch.setattr(native, "_load_cext", lambda name: _Skewed)
    with pytest.raises(native.NativeBuildError, match="clock"):
        native.load_pinsext()


def test_task_profiler_deferred_begin_intervals_pair():
    from parsec_tpu_torch.prof.profiling import EV_END, EV_START, Profile
    N = 16
    p = PTG("iv", N=N)
    p.task("E", i=Range(0, N - 1)).flow("x", "CTL").body(lambda: None)
    prof = Profile()
    with Context(nb_cores=2, device="cpu") as ctx:
        mod = install_task_profiler(ctx, prof)
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
        mod.uninstall(ctx)
    opened = {}
    closed = 0
    for sb in prof._streams.values():
        for key, flags, _tp, eid, _oid, ts, _info in sb.merged_events():
            if flags & EV_START:
                opened[eid] = ts
            elif flags & EV_END:
                assert eid in opened and ts >= opened[eid]
                closed += 1
    assert closed == N


# ---------------------------------------------------------------------------
# parity: the same traced DAG in both packages
# ---------------------------------------------------------------------------

def _traced(side, tmp_path):
    """A device chain and a CPU fan (dep edges, queue waits, device spans
    and exec intervals) traced by the task profiler and causal tracer."""
    if side == "jax":
        import parsec_tpu.core.context as ctx_mod
        import parsec_tpu.data.matrix as mat_mod
        import parsec_tpu.dsl.ptg as ptg
        from parsec_tpu.prof import causal, pins, profiling, reader
        from parsec_tpu.utils.mca import params as prm
        kw, dev = {}, "tpu"
        A = mat_mod.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
        A.data_of(0, 0).copy_on(0).payload[:] = 0.0
        prm.set("comm_ici_enabled", 0)
    else:
        import parsec_tpu_torch.core.context as ctx_mod
        import parsec_tpu_torch.dsl.ptg as ptg
        from parsec_tpu_torch.prof import causal, pins, profiling, reader
        prm, kw, dev = params, {"device": "cpu"}, "cuda"
        A = _zero_tile()
    try:
        prof = profiling.Profile(side)
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            mods = [pins.install_task_profiler(ctx, prof),
                    causal.install_causal_tracer(ctx, prof)]
            ctx.add_taskpool(_chain_pool(A, 9, dev, ptg))
            f = ptg.PTG("fan", W=7)
            f.task("SRC").flow("x", "CTL", ptg.OUT(ptg.TASK(
                "W", "x", lambda: [dict(i=i) for i in range(7)]))) \
                .body(lambda: None)
            f.task("W", i=ptg.Range(0, 6)) \
                .flow("x", "CTL", ptg.IN(ptg.TASK("SRC", "x",
                                                  lambda i: dict()))) \
                .body(lambda: None)
            ctx.add_taskpool(f.build())
            ctx.wait(timeout=120)
            for m in mods:
                m.uninstall(ctx)
        path = prof.dump(str(tmp_path / f"{side}.ptt"))
    finally:
        if side == "jax":
            prm.unset("comm_ici_enabled")
    meta, rows = reader.read_trace(path)
    if side == "jax":
        ivs = reader.intervals(rows).to_dict("records")
        rows = rows.to_dict("records")
    else:
        ivs = reader.intervals(rows)
    return meta, rows, ivs


def test_trace_event_counts_and_intervals_match_the_jax_package(tmp_path):
    ref_meta, ref_rows, ref_ivs = _traced("jax", tmp_path)
    meta, rows, ivs = _traced("port", tmp_path)
    count = lambda rs: collections.Counter(  # noqa: E731
        (r["name"], r["flags"]) for r in rs)
    assert count(rows) == count(ref_rows)
    ivc = lambda ii: collections.Counter(i["name"] for i in ii)  # noqa: E731
    assert ivc(ivs) == ivc(ref_ivs) == {
        "S": 9, "dev:S": 9, "queue_wait": 17, "SRC": 1, "W": 7}
    # every START paired: as many intervals as START records
    starts = sum(1 for r in rows if r["flags"] & 1)
    assert len(ivs) == starts
    assert all(i["duration"] >= 0 for i in ivs)
    assert meta["info"] == {"rank": "0", "nranks": "1"} == ref_meta["info"]


# -- live gauge aggregator (prof/aggregator.py): twins of test_prof.py's
# -- four aggregator cases, each script run through both packages --------

def _aggregators():
    import parsec_tpu.prof.aggregator as jax_agg
    import parsec_tpu_torch.prof.aggregator as port_agg
    return {"jax": jax_agg, "port": port_agg}


def _agg_until(pred, timeout=10.0):
    import time
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_aggregator_ingest_and_totals():
    """Latest table, totals, history and the rendered table agree with
    the JAX package's on the same ingests (the age column aside)."""
    got = {}
    for side, mod in _aggregators().items():
        agg = mod.Aggregator(port=0)
        try:
            agg.ingest(0, {"tasks_retired": 10, "pending_tasks": 2}, t=1.0)
            agg.ingest(1, {"tasks_retired": 5, "pending_tasks": 1}, t=1.0)
            agg.ingest(0, {"tasks_retired": 12, "pending_tasks": 0}, t=2.0)
            t = agg.table()
            rows = {r: {k: v for k, v in g.items() if k != "_age_s"}
                    for r, g in t.items()}
            for g in t.values():
                g["_age_s"] = 0.0
            got[side] = (rows, agg.totals(),
                         agg.history(0, "tasks_retired"),
                         mod.render_table(t, agg.totals()))
        finally:
            agg.close()
    assert got["port"] == got["jax"]
    rows, totals, hist, text = got["port"]
    assert rows[0]["tasks_retired"] == 12 and rows[1]["tasks_retired"] == 5
    assert totals["tasks_retired"] == 17
    assert [v for _ts, v in hist] == [10, 12]
    assert "rank" in text and "17" in text


def test_gauge_publisher_streams_over_tcp():
    """A publisher streams a rank's snapshots over TCP; either package's
    publisher feeds either package's aggregator (one wire format)."""
    class FakeGauges:
        def __init__(self):
            self.n = 0

        def snapshot(self):
            self.n += 1
            return {"tasks_retired": self.n}

    mods = _aggregators()
    for pub_side, agg_side in (("port", "port"), ("port", "jax"),
                               ("jax", "port")):
        agg = mods[agg_side].Aggregator(port=0)
        pub = mods[pub_side].GaugePublisher(FakeGauges(), rank=3,
                                            host="127.0.0.1",
                                            port=agg.port, interval=0.05)
        try:
            assert _agg_until(lambda: agg.table().get(3, {}).get(
                "tasks_retired", 0) >= 2), (pub_side, agg_side)
        finally:
            pub.close()
            agg.close()


def test_aggregator_live_with_runtime_gauges():
    """A real Context's Gauges publish through TCP while a pool runs; the
    aggregator's final totals see every retirement, as in the JAX
    package."""
    import parsec_tpu.core.context as jax_ctx
    import parsec_tpu.data.matrix as jax_mat
    import parsec_tpu.dsl.ptg as jax_ptg
    import parsec_tpu.prof.gauges as jax_gauges
    nt = 30
    totals = {}
    for side, mod in _aggregators().items():
        agg = mod.Aggregator(port=0)
        try:
            if side == "jax":
                ctx = jax_ctx.Context(nb_cores=2)
                A = jax_mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
                tp = _chain_pool(A, nt, ptg=jax_ptg)
                g = jax_gauges.install_gauges(ctx)
            else:
                ctx = Context(nb_cores=2, device="cpu")
                tp = _chain_pool(_zero_tile(), nt)
                g = install_gauges(ctx)
            with ctx:
                pub = mod.GaugePublisher(g, rank=0, host="127.0.0.1",
                                         port=agg.port, interval=0.02)
                ctx.add_taskpool(tp)
                ctx.wait()
                pub.close()          # final flush carries the end state
            assert _agg_until(
                lambda: agg.totals().get("tasks_retired", 0) >= nt)
            totals[side] = agg.totals()["tasks_retired"]
        finally:
            agg.close()
    assert totals["port"] == totals["jax"] == nt


def test_aggregator_nonnumeric_ingest_and_clean_close():
    """String/null gauges are dropped at ingest, rendering never raises,
    and close() joins the accept thread."""
    got = {}
    for side, mod in _aggregators().items():
        agg = mod.Aggregator(port=0)
        try:
            agg.ingest(0, {"ok": 3, "bad": "oops", "worse": None, "f": 1.5})
            row = {k: v for k, v in agg.table()[0].items() if k != "_age_s"}
            mod.render_table(agg.table(), agg.totals())
        finally:
            agg.close()
        got[side] = (row, agg._thread.is_alive())
    assert got["port"] == got["jax"] == ({"ok": 3.0, "f": 1.5}, False)


def _dot_of(pkg, tmp_path, build):
    """Run ``build(ctx, A)`` under the package's DOT grapher; the DOT."""
    import importlib
    root = "parsec_tpu" if pkg == "jax" else "parsec_tpu_torch"
    Ctx = importlib.import_module(f"{root}.core.context").Context
    Grapher = importlib.import_module(f"{root}.prof.grapher").DotGrapher
    TDBC = importlib.import_module(f"{root}.data.matrix").TwoDimBlockCyclic
    A = TDBC(mb=4, nb=4, lm=4, ln=4)
    A.data_of(0, 0).copy_on(0).payload[:] = 0.0
    with (Ctx(nb_cores=2) if pkg == "jax"
          else Ctx(nb_cores=2, device="cpu")) as ctx:
        g = Grapher(rank=0)
        g.install(ctx)
        assert ctx.grapher is g
        build(ctx, A, root)
    return open(g.dump(str(tmp_path / f"{pkg}.dot"))).read()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dot_grapher_records_dag(tmp_path, pkg):
    nt = 5

    def build(ctx, A, root):
        import importlib
        api = importlib.import_module(f"{root}.dsl.ptg")
        ctx.add_taskpool(_chain_pool(A, nt, ptg=api))
        ctx.wait()
    text = _dot_of(pkg, tmp_path, build)
    assert text.startswith("digraph")
    assert text.count("->") == nt - 1           # the chain's edges
    assert text.count('label="S(') == nt        # one node per task
    assert 'label="T"' in text                  # edges carry flow names


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dot_grapher_covers_dtd_edges(tmp_path, pkg):
    def build(ctx, A, root):
        import importlib
        dtd = importlib.import_module(f"{root}.dsl.dtd")
        tp = dtd.DTDTaskpool("d")
        ctx.add_taskpool(tp)
        ctx.start()
        t = tp.tile_of(A, 0, 0)
        for _ in range(4):
            tp.insert_task(lambda T: T + 1.0, (t, dtd.INOUT))
        tp.wait()
    assert _dot_of(pkg, tmp_path, build).count("->") == 3

