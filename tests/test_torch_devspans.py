"""The device module's spans (devices/cuda.py, prof/causal.py): ``dev:``
spans from the launch steps, the manager's and the completer's host
stages, the clock anchor, and what the trace tools read of them.

On the CPU-backed module, which has no CUDA events, a launch step is
timed by host stamps around it (which there is the work itself), so a
``dev:`` span says ``clock: host`` and lies inside the ``mgr.dispatch``
span of its launch.  The card's case (a K1 launch's ``dev:`` interval
against CUDA events around the same call) is in tests/test_torch_cuda.py.
"""

import collections
import io
import time
from contextlib import redirect_stdout

import numpy as np
import torch

from parsec_tpu_torch.apps.potrf import potrf_taskpool
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.devices import cuda as cuda_mod
from parsec_tpu_torch.prof import critpath, install_task_profiler
from parsec_tpu_torch.prof.causal import STAGE_CLASSES, install_causal_tracer
from parsec_tpu_torch.prof.profiling import Profile
from parsec_tpu_torch.prof.reader import intervals, read_trace, wall_ns
from parsec_tpu_torch.tools import trace_info

NT, MB = 5, 8
#: potrf at nt=5: POTRF 0..3 (+ POTRFL), TRSM, SYRK, GEMM
COUNTS = {"POTRF": 4, "POTRFL": 1, "TRSM": 10, "SYRK": 10, "GEMM": 10}


def _spd_matrix():
    rng = np.random.default_rng(7)
    n = NT * MB
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = a @ a.T + n * np.eye(n, dtype=np.float32)
    return TwoDimBlockCyclic(MB, MB, n, n).from_array(
        torch.from_numpy(spd.copy()))


def _traced_potrf(tmp_path, classes=None, profiler=False):
    """One potrf pass on the CPU-backed module under a causal tracer of
    ``classes``: (meta, rows, intervals, the device's stats)."""
    A = _spd_matrix()
    prof = Profile("devspans")
    with Context(nb_cores=2, device="cpu") as ctx:
        mods = [install_task_profiler(ctx, prof)] if profiler else []
        mods.append(install_causal_tracer(ctx, prof, classes=classes))
        ctx.add_taskpool(potrf_taskpool(A))
        ctx.wait(timeout=120)
        for m in mods:
            m.uninstall(ctx)
        stats = ctx.device_registry.accelerators[0].stats.as_dict()
    meta, rows = read_trace(prof.dump(str(tmp_path / "devspans.ptt")))
    return meta, rows, intervals(rows), stats


def _by_name(ivs, prefix):
    return [i for i in ivs if i["name"].startswith(prefix)]


# ---------------------------------------------------------------------------
# dev: spans
# ---------------------------------------------------------------------------

def test_one_dev_span_per_task_from_its_launch_step(tmp_path):
    """Every device task leaves one ``dev:`` span carrying its launch
    step (launch id, width, clock) and its own oid; a wave's tasks share
    one interval and one launch id, and a step's width is the number of
    tasks that share it."""
    meta, rows, ivs, stats = _traced_potrf(tmp_path, profiler=True)
    dev = _by_name(ivs, "dev:")
    assert collections.Counter(i["name"][4:] for i in dev) == COUNTS
    exe = [i for i in ivs if i["name"] in COUNTS]
    assert {(i["taskpool_id"], i["object_id"]) for i in dev} == \
        {(i["taskpool_id"], i["object_id"]) for i in exe}
    assert len({i["object_id"] for i in dev}) == len(dev)
    for i in dev:
        assert i["info"]["clock"] == "host"       # no events on the CPU
        assert i["duration"] >= 0
    steps = collections.defaultdict(list)
    for i in dev:
        steps[(i["info"]["lid"], i["info"].get("part"))].append(i)
    for members in steps.values():
        assert {(m["ts_begin"], m["ts_end"]) for m in members} == \
            {(members[0]["ts_begin"], members[0]["ts_end"])}
        assert all(m["info"]["width"] == len(members) for m in members)
    # the fused waves of the device module's counters, seen in the spans
    wide = [m for m in steps.values() if len(m) > 1]
    assert sum(len(m) for m in wide) >= stats["fused_tasks"]
    assert meta["info"] == {"rank": "0", "nranks": "1"}


def test_device_pins_fire_once_per_task_as_in_the_jax_package():
    """``device_dispatch`` and ``device_done`` fire exactly once per
    device task, as the JAX package's do on the same DAG; the port's
    payload is the device's in-flight entry, whose ``task`` is each task
    once."""
    import parsec_tpu.core.context as jctx
    import parsec_tpu.data.matrix as jmat
    import parsec_tpu.dsl.ptg as jptg
    from parsec_tpu.prof import causal as jcausal
    from parsec_tpu.prof import profiling as jprofiling
    from parsec_tpu.utils.mca import params as jparams

    from test_torch_prof import _chain_pool, _zero_tile

    def run(ctx_mod, causal, profiling, A, ptg, dev, **kw):
        seen = collections.defaultdict(list)
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            tr = causal.install_causal_tracer(ctx, profiling.Profile("p"))
            for ev in ("device_dispatch", "device_done"):
                ctx.pins_register(ev, lambda es, e, p: seen[e].append(
                    getattr(p, "task", p).key))
            ctx.add_taskpool(_chain_pool(A, 9, dev, ptg))
            ctx.wait(timeout=120)
            tr.uninstall(ctx)
        return {e: collections.Counter(keys) for e, keys in seen.items()}

    A = jmat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    A.data_of(0, 0).copy_on(0).payload[:] = 0.0
    jparams.set("comm_ici_enabled", 0)
    try:
        ref = run(jctx, jcausal, jprofiling, A, jptg, "tpu")
    finally:
        jparams.unset("comm_ici_enabled")
    import parsec_tpu_torch.core.context as pctx
    import parsec_tpu_torch.dsl.ptg as pptg
    from parsec_tpu_torch.prof import causal, profiling
    port = run(pctx, causal, profiling, _zero_tile(), pptg, "cuda",
               device="cpu")
    assert {e: sorted(c.values()) for e, c in port.items()} == \
        {e: sorted(c.values()) for e, c in ref.items()} == \
        {"device_dispatch": [1] * 9, "device_done": [1] * 9}


def test_chain_held_body_span_precedes_its_wave(tmp_path):
    """A chained launch times its held body (POTRF with tri_inv) and its
    consumer wave (TRSM) as parts of one launch: the same launch id, the
    held part first and ending where the wave's part begins."""
    _meta, _rows, ivs, stats = _traced_potrf(tmp_path, classes=("device",))
    assert stats["chained_launches"] > 0
    held = {i["info"]["lid"]: i for i in _by_name(ivs, "dev:POTRF")
            if i["name"] == "dev:POTRF" and "part" in i["info"]}
    assert held, "no POTRF ran in a chained launch"
    waves = collections.defaultdict(list)
    for i in _by_name(ivs, "dev:TRSM"):
        if "part" in i["info"]:
            waves[i["info"]["lid"]].append(i)
    for lid, h in held.items():
        w = waves[lid]
        assert w and h["info"]["part"] == 0 and h["info"]["width"] == 1
        assert all(x["info"]["part"] == 1 for x in w)
        assert h["ts_end"] <= w[0]["ts_begin"]


# ---------------------------------------------------------------------------
# host stages
# ---------------------------------------------------------------------------

def test_stage_spans_nest_and_carry_launch_ids(tmp_path):
    """With the ``stages`` class the manager's stages of a launch (pop,
    stage-in, dispatch) follow one another on the manager's stream and
    carry its launch id; each ``dev:`` span of a manager step lies in
    that step's ``mgr.dispatch`` (on the CPU the step runs inside the
    enqueue); the completer's ``fin.complete`` spans carry the tasks'
    oids and its ``fin.finalize`` spans launch ids."""
    _meta, rows, ivs, _stats = _traced_potrf(
        tmp_path, classes=("device", "stages"))
    names = {i["name"] for i in ivs}
    assert {"mgr.pop", "mgr.stage_in", "mgr.dispatch", "fin.complete",
            "fin.finalize"} <= names <= set(STAGE_CLASSES) | {
        "dev:" + c for c in COUNTS}
    streams = collections.defaultdict(set)
    for i in ivs:
        streams[i["name"].split(".")[0].split(":")[0]].add(i["stream"])
    assert streams["mgr"] == {930 + 1} and streams["fin"] == {960 + 1}
    assert streams["dev"] == {900 + 1}
    mgr = sorted((i for i in ivs if i["name"].startswith("mgr.")),
                 key=lambda i: (i["ts_begin"], i["ts_end"]))
    for a, b in zip(mgr, mgr[1:]):   # one thread: no two overlap
        assert a["ts_end"] <= b["ts_begin"] + 1e-9, (a, b)
    by_lid = collections.defaultdict(dict)
    for i in mgr:
        by_lid[i["object_id"]][i["name"]] = i
    order = ("mgr.pop", "mgr.stage_in", "mgr.dispatch")
    for stages in by_lid.values():
        seq = [stages[n] for n in order if n in stages]
        assert [s["name"] for s in seq] == list(order)
        assert all(x["ts_end"] <= y["ts_begin"] + 1e-9
                   for x, y in zip(seq, seq[1:]))
    dev = _by_name(ivs, "dev:")
    inside = 0
    for d in dev:
        disp = by_lid.get(d["info"]["lid"], {}).get("mgr.dispatch")
        if disp is not None:
            assert disp["ts_begin"] <= d["ts_begin"] <= d["ts_end"] \
                <= disp["ts_end"]
            inside += 1
    assert inside >= len(dev) - COUNTS["POTRFL"] - 1
    fin = [i for i in ivs if i["name"] == "fin.complete"]
    assert sorted(i["object_id"] for i in fin) == \
        sorted(d["object_id"] for d in dev)
    lids = {d["info"]["lid"] for d in dev}
    assert {i["object_id"] for i in ivs if i["name"] == "fin.finalize"} \
        <= lids | {0}


def test_default_tracer_records_no_stage_span(tmp_path):
    """The default classes keep the trace's shape: ``dev:`` spans, no
    host stage (the ``stages`` class is opt-in)."""
    _meta, rows, ivs, _stats = _traced_potrf(tmp_path)
    assert not [r for r in rows if r["name"] in STAGE_CLASSES]
    assert len(_by_name(ivs, "dev:")) == sum(COUNTS.values())


def test_spans_off_take_no_clock_read_step_or_event(monkeypatch):
    """With no tracer the device module makes no launch step, no timing
    event and no stage span, and reads no clock on the launch path."""
    made = collections.Counter()
    real_step, real_now = cuda_mod._Step, cuda_mod._now

    class CountedStep(real_step):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made["step"] += 1
            super().__init__(*a, **kw)

    def counted_now():
        made["clock"] += 1
        return real_now()

    def no_event(*a, **kw):
        raise AssertionError("a CUDA event on the CPU-backed module")

    monkeypatch.setattr(cuda_mod, "_Step", CountedStep)
    monkeypatch.setattr(cuda_mod, "_now", counted_now)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(cuda_mod.CudaDevice, "_stage",
                        lambda *a, **kw: made.update(["stage"]))
    A = _spd_matrix()
    with Context(nb_cores=2, device="cpu") as ctx:
        ctx.add_taskpool(potrf_taskpool(A))
        ctx.wait(timeout=120)
        assert ctx.device_registry.accelerators[0].stats.executed_tasks \
            == sum(COUNTS.values())
    assert made == {}
    # the same run with spans on makes them
    prof = Profile("on")
    with Context(nb_cores=2, device="cpu") as ctx:
        tr = install_causal_tracer(ctx, prof, classes=("device", "stages"))
        ctx.add_taskpool(potrf_taskpool(_spd_matrix()))
        ctx.wait(timeout=120)
        tr.uninstall(ctx)
    assert made["step"] > 0 and made["clock"] > 0 and made["stage"] > 0


# ---------------------------------------------------------------------------
# the clock and the readers
# ---------------------------------------------------------------------------

def test_header_anchor_lays_spans_on_the_wall_clock(tmp_path):
    """The header's anchor pair maps a span's perf_counter stamps onto
    ``time.time_ns()``, the clock of a ``torch.profiler`` trace."""
    ns0 = time.time_ns()
    meta, _rows, ivs, _stats = _traced_potrf(tmp_path, classes=("device",))
    ns1 = time.time_ns()
    pc, ns = meta["clock_anchor"]
    assert ns0 <= ns <= ns1
    for i in _by_name(ivs, "dev:"):
        assert ns0 <= wall_ns(meta, i["ts_begin"]) <= \
            wall_ns(meta, i["ts_end"]) <= ns1
    assert wall_ns({"info": {}}, 1.0) is None


def test_trace_tools_read_the_device_spans(tmp_path):
    """trace_info's statistics and occupancy and critpath's DAG read a
    profile with device spans and host stages: the stages are classes of
    their own and no task node."""
    A = _spd_matrix()
    prof = Profile("tools")
    with Context(nb_cores=2, device="cpu") as ctx:
        mods = [install_task_profiler(ctx, prof),
                install_causal_tracer(ctx, prof,
                                      classes=("queue", "deps", "device",
                                               "stages"))]
        ctx.add_taskpool(potrf_taskpool(A))
        ctx.wait(timeout=120)
        for m in mods:
            m.uninstall(ctx)
    path = prof.dump(str(tmp_path / "tools.ptt"))
    out = io.StringIO()
    with redirect_stdout(out):
        assert trace_info.main([path, "--stats", "--gaps"]) == 0
    text = out.getvalue()
    for name in ("dev:TRSM", "mgr.dispatch", "fin.complete",
                 "per-class queue-wait", "stream 931"):
        assert name in text, name
    rows, _metas = critpath.merge_traces([path])
    tasks, preds, ready = critpath.build_dag(rows)
    assert len(tasks) == sum(COUNTS.values())
    att = critpath.attribute(critpath.critical_path(tasks, preds), tasks,
                             ready)
    assert att["makespan"] > 0
