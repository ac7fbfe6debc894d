"""The port's C task-object core (schedext TaskCore/TaskVT/run_quantum):
native-vs-Python parity in the port, parity with the JAX package's own C
path on the same DAGs, batched-termdet semantics and the coalesced worker
doorbell.  Twins of the single-rank tests of tests/test_taskcore.py.

The parity property is the gate that matters: identical DAG results,
executed-task counts, termdet final counts, PINS event counts and bailout
histograms — a fast path that drops an event or a count is a regression
no throughput number can excuse."""

import re

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg as jax_ptg
import parsec_tpu.native as jax_native
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg as port_ptg
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.native import load_schedext
from parsec_tpu_torch.utils.mca import params

se = load_schedext()

_EVENTS = ("select", "exec_begin", "exec_end", "complete_exec",
           "task_discard")


def _side(side):
    """(context module, matrix module, PTG module, params, schedext,
    Context kwargs, zeros, fill-like) of one package."""
    if side == "jax":
        jse = jax_native.load_schedext()
        if jse is None:
            pytest.skip("the JAX package's schedext did not build")
        return (jax_context, jax_matrix, jax_ptg, jax_params, jse, {},
                lambda *s: np.zeros(s, np.float32),
                lambda w, v: np.full_like(w, v))
    return (port_context, port_matrix, port_ptg, params, se,
            {"device": "cpu"}, lambda *s: torch.zeros(*s),
            lambda w, v: torch.full_like(w, v))


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bail_delta(mod, before):
    after = mod.bailout_stats()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def _run(side, native, build, prep=None):
    """Run the DAG ``build`` makes on one package with ``sched_native``
    set; return every observable the parity properties compare."""
    ctx_mod, mat_mod, ptg, prm, ext, kw, zeros, full = _side(side)
    prm.set("sched_native", native)
    if side == "jax":
        # the conftest's virtual 8-device mesh attaches an IciEngine,
        # whose placement walk (correctly) gates the extended chain off;
        # these properties are about the chain, so make it eligible
        prm.set("comm_ici_enabled", 0)
    try:
        events = []       # list.append is GIL-atomic across workers
        tp, mats, extra = build(mat_mod, ptg, zeros, full)
        if prep is not None:
            prep(tp)
        bail0 = dict(ext.bailout_stats())
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            assert (ctx.scheduler.name == "native") == bool(native)
            for ev in _EVENTS:
                ctx.pins_register(ev, lambda es, e, t: events.append(e))
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
            streams = sum(es.nb_tasks_done for es in ctx.streams)
        return {"arrays": {k: _as_numpy(m.to_array())
                           for k, m in mats.items()},
                "counts": {ev: events.count(ev) for ev in _EVENTS},
                "done": streams,
                "termdet": (tp.nb_tasks, tp.nb_pending_actions),
                "bailouts": _bail_delta(ext, bail0), "extra": extra}
    finally:
        prm.unset("sched_native")
        if side == "jax":
            prm.unset("comm_ici_enabled")


def _mixed(mat_mod, ptg, zeros, full):
    """A trivial CTL class (the C chain's trivial fast path) plus an RW
    data chain (the extended chain: FromDesc binding, FromTask inputs,
    local ToTask delivery walks all C-side)."""
    A = mat_mod.TwoDimBlockCyclic(1, 1, 1, 1, name="A").from_array(
        zeros(1, 1))
    NE, NB = 40, 6
    order = []

    def chain_body(T, k):
        order.append(k)
        T += 1.0

    g = ptg.PTG("parity", NE=NE, NB=NB)
    g.task("E", i=ptg.Range(0, NE - 1)).flow("x", "CTL") \
        .body(lambda: None)
    g.task("S", k=ptg.Range(0, NB - 1)) \
        .affinity(lambda k: A(0, 0)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda k: A(0, 0)), when=lambda k: k == 0),
              ptg.IN(ptg.TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              ptg.OUT(ptg.TASK("S", "T", lambda k: dict(k=k + 1)),
                      when=lambda k, NB=NB: k < NB - 1)) \
        .body(chain_body)
    return g.build(), {"A": A}, order


def _new_binding(mat_mod, ptg, zeros, full):
    """NEW-arena scratch binding through the extended chain: MAKE binds a
    fresh arena block (CK_NEW), fills it, and hands it to USE over a
    ToTask edge; USE folds it into a FromDesc-bound RW tile in place."""
    NI = 4
    A = mat_mod.TwoDimBlockCyclic(1, 1, 1, NI, name="A").from_array(
        zeros(1, NI))
    g = ptg.PTG("newbind", NI=NI)
    g.arena("tmp", (2,))
    g.task("MAKE", i=ptg.Range(0, NI - 1)) \
        .affinity(lambda i: A(0, i)) \
        .flow("W", "WRITE",
              ptg.IN(ptg.NEW("tmp")),
              ptg.OUT(ptg.TASK("USE", "W", lambda i: dict(i=i)))) \
        .body(lambda W: full(W, 3.0))
    g.task("USE", i=ptg.Range(0, NI - 1)) \
        .affinity(lambda i: A(0, i)) \
        .flow("W", "READ",
              ptg.IN(ptg.TASK("MAKE", "W", lambda i: dict(i=i)))) \
        .flow("T", "RW", ptg.IN(ptg.DATA(lambda i: A(0, i)))) \
        .body(lambda W, T: T.__iadd__(float(W.sum())) and None)
    return g.build(), {"A": A}, None


def _potrf_device(mat_mod, ptg, zeros, full):
    """The potrf slice with device bodies: every class has a device
    incarnation, so the C core builds the tasks and counts them down but
    hands each one back to Python at run_quantum."""
    n, mb = 48, 16
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n))
    spd = (a @ a.T + n * np.eye(n)).astype(np.float32)
    if mat_mod is port_matrix:
        from parsec_tpu_torch.apps.potrf import potrf_taskpool
        A = mat_mod.TwoDimBlockCyclic(mb, mb, n, n, name="A").from_array(
            torch.from_numpy(spd))
        return potrf_taskpool(A, device="cuda"), {}, A
    from parsec_tpu.apps.potrf import potrf_taskpool
    A = mat_mod.TwoDimBlockCyclic(mb, mb, n, n, name="A").from_array(spd)
    return potrf_taskpool(A, device="tpu"), {}, A


def _check_counts(r, total):
    assert r["counts"]["select"] == total
    assert r["counts"]["exec_begin"] == total
    assert r["counts"]["exec_end"] == total
    assert r["counts"]["complete_exec"] == total
    assert r["counts"]["task_discard"] == 0
    assert r["done"] == total
    assert r["termdet"] == (0, 0)


def test_native_vs_python_parity_property():
    nat = _run("port", 1, _mixed)
    py = _run("port", 0, _mixed)
    assert nat["arrays"]["A"].tolist() == py["arrays"]["A"].tolist() \
        == [[6.0]]
    # the serialized chain runs in order on both paths
    assert nat["extra"] == py["extra"] == list(range(6))
    assert nat["counts"] == py["counts"]
    _check_counts(nat, 46)
    _check_counts(py, 46)
    # the RW chain is C-chain-covered end to end: not one task fell back
    assert nat["bailouts"] == {} and py["bailouts"] == {}


@pytest.mark.parametrize("build", [_mixed, _new_binding],
                         ids=["mixed", "new_binding"])
def test_parity_with_the_jax_package_c_path(build):
    """The same DAG on the same inputs under both packages' C chains:
    equal results, executed-task counts, termdet finals, PINS event
    counts and bailout histograms."""
    ref = _run("jax", 1, build)
    got = _run("port", 1, build)
    for k in ref["arrays"]:
        np.testing.assert_array_equal(got["arrays"][k], ref["arrays"][k])
    assert got["counts"] == ref["counts"]
    assert got["done"] == ref["done"]
    assert got["termdet"] == ref["termdet"] == (0, 0)
    assert got["bailouts"] == ref["bailouts"] == {}
    if build is _mixed:
        assert got["extra"] == ref["extra"] == list(range(6))


def test_device_classes_bail_alike_in_both_packages():
    """Device classes leave the C chain as non_trivial in both packages,
    one bailout per task, and the factor agrees."""
    ref = _run("jax", 1, _potrf_device)
    got = _run("port", 1, _potrf_device)
    # nt=3: 3 POTRF, 3 TRSM, 3 SYRK, 1 GEMM (device tasks complete on
    # the device module's stream, not a worker's: count complete_exec)
    total = got["counts"]["complete_exec"]
    assert total == ref["counts"]["complete_exec"] == 10
    assert got["bailouts"] == ref["bailouts"] == {"non_trivial": total}
    assert got["counts"] == ref["counts"]
    assert got["termdet"] == ref["termdet"] == (0, 0)
    L_ref = np.tril(np.asarray(ref["extra"].to_array()))
    L_got = np.tril(got["extra"].to_array().numpy())
    np.testing.assert_allclose(L_got, L_ref, rtol=1e-4, atol=1e-4)


def test_new_arena_binding_parity():
    nat = _run("port", 1, _new_binding)
    py = _run("port", 0, _new_binding)
    assert nat["arrays"]["A"].tolist() == py["arrays"]["A"].tolist() \
        == [[6.0] * 4]
    assert nat["termdet"] == py["termdet"] == (0, 0)
    assert nat["counts"] == py["counts"]
    assert nat["bailouts"] == {}


def test_a_pool_with_a_lineage_log_leaves_the_c_chain():
    """Twin of the JAX package's lineage-ring parity at the gate the C
    chain owns: a pool carrying a lineage log (the recovery plane, not
    ported) is deferred to the Python completion path, every task
    counted under ``lineage``, with the same results."""
    def prep(tp):
        tp._lineage = object()

    nat = _run("port", 1, _mixed, prep)
    py = _run("port", 0, _mixed, prep)
    assert nat["arrays"]["A"].tolist() == py["arrays"]["A"].tolist() \
        == [[6.0]]
    assert nat["counts"] == py["counts"]
    assert nat["bailouts"] == {"lineage": 46}


def test_taskcore_object_contract():
    """vt.build_one's TaskCore matches Task field-for-field for the
    attributes every runtime layer reads, shares the process-global
    seq counter, and reprs identically."""
    from parsec_tpu_torch.core.task import Task, TaskClass
    from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
    params.set("sched_native", 1)
    try:
        tp = ParameterizedTaskpool("tc-contract")
        tp.priority = 7
        tc = tp.add_task_class(TaskClass(
            "C", params=[("i", lambda g, l: range(4))],
            priority=lambda loc: loc["i"] * 10,
            body=lambda es, task: None))
        vt = tc.native_vt()
        assert vt is not None and vt.trivial
        ct = vt.build_one({"i": 3})
        pt = Task(tc, tp, {"i": 3})
        assert type(ct) is se.TaskCore
        assert ct.key == pt.key == ("C", 3)
        assert ct.priority == pt.priority == 37   # class prio + pool bias
        assert ct.locals == pt.locals
        assert ct.status == 0 and ct.chore_mask == 0xFFFF
        assert ct.data == {} and ct.input_sources == {}
        assert ct.pinned_flows == set()
        assert ct.ready_at is None and ct.retry_snap is None
        assert ct.device is None
        assert ct.pool_epoch == 0 and ct.retries == 0
        assert repr(ct) == repr(pt) == "C(i=3)"
        # one process-global sequence: C- and Python-constructed tasks
        # interleave monotonically
        assert pt.seq == ct.seq + 1
        b = vt.build_range("i", 0, 4, 1)
        assert [t.key for t in b] == [("C", i) for i in range(4)]
        assert [t.priority for t in b] == [7, 17, 27, 37]
    finally:
        params.unset("sched_native")


def test_taskcore_and_task_carry_the_same_fields():
    """The field contract: every slot of the port's Task is a member of
    TaskCore and back (plus TaskCore's read-only vtable), so a C-built
    task carries whatever any layer reads."""
    from parsec_tpu_torch.core.task import Task
    members = {n for n in dir(se.TaskCore)
               if not n.startswith("_") and
               type(getattr(se.TaskCore, n)).__name__ == "member_descriptor"}
    assert members - {"vt"} == set(Task.__slots__)
    # the telemetry planes' slots are carried (task profiler, metrics
    # split mode, the ready stamp) and the DTD front-end's
    for carried in ("prof", "mtr_t0", "ready_at", "dtd"):
        assert carried in members


def test_nontrivial_class_has_no_trivial_vtable():
    """Data flows keep a class off the TRIVIAL chain, but a single-cpu
    class with binding-table-coverable flows is extended-chain (cchain)
    eligible; a device incarnation keeps a class off both chains
    (construction stays)."""
    from parsec_tpu_torch.core.task import Dep, FromDesc, RW, TaskClass
    from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
    params.set("sched_native", 1)
    try:
        tp = ParameterizedTaskpool("vt-gate")
        tc = tp.add_task_class(TaskClass(
            "D", params=[("i", lambda g, l: range(2))],
            flows=[RW("T", inputs=[Dep(FromDesc(lambda loc: None))])],
            body=lambda es, task: None))
        vt = tc.native_vt()
        assert vt is not None and not vt.trivial
        assert vt.cchain == 1
        tc2 = tp.add_task_class(TaskClass(
            "D2", params=[("i", lambda g, l: range(2))],
            incarnations=[("cuda", lambda es, task: None),
                          ("cpu", lambda es, task: None)]))
        vt2 = tc2.native_vt()
        assert vt2 is not None and not vt2.trivial and vt2.cchain == 0
        assert type(vt2.build_one({"i": 0})) is se.TaskCore
    finally:
        params.unset("sched_native")


def test_sched_native_off_builds_python_tasks():
    from parsec_tpu_torch.core.task import TaskClass
    from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
    params.set("sched_native", 0)
    try:
        tp = ParameterizedTaskpool("off")
        tc = tp.add_task_class(TaskClass(
            "C", params=[("i", lambda g, l: range(2))],
            body=lambda es, task: None))
        assert tc.native_vt() is None
        assert tp._native_deps is None
    finally:
        params.unset("sched_native")


def test_invalid_hook_return_is_contained_on_native_path():
    """A trivial body returning an int that is no HookReturn code must
    become a CONTAINED task failure on the C chain, exactly like the
    Python chain — not a ValueError escaping run_quantum that kills the
    worker thread and hangs the run with zero recorded errors."""
    from parsec_tpu_torch.core.task import TaskClass
    from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
    for native in (1, 0):
        params.set("sched_native", native)
        try:
            # raw incarnation hook (no PTG value-normalizing wrapper):
            # its return IS treated as a lifecycle code
            tp = ParameterizedTaskpool("badret")
            tp.add_task_class(TaskClass(
                "B", params=[("i", lambda g_, l: range(4))],
                properties={"idempotent": False},
                incarnations=[("cpu", lambda es, task: 7)]))
            with port_context.Context(nb_cores=2, device="cpu") as ctx:
                ctx.add_taskpool(tp)
                with pytest.raises(RuntimeError,
                                   match=re.escape("task B(")):
                    ctx.wait(timeout=15)
        finally:
            params.unset("sched_native")


def test_batched_termdet_epoch_fence():
    """A torn-generation batch flush drops under the termdet lock
    instead of corrupting the re-counted pool (the recovery rewind
    contract for accumulated decrements)."""
    from parsec_tpu_torch.core.taskpool import Taskpool
    from parsec_tpu_torch.core.termdet import LocalTermdet
    tp = Taskpool("fence")
    td = LocalTermdet()
    fired = []
    td.monitor(tp, lambda: fired.append(1))
    td.taskpool_addto_nb_tasks(tp, 5)
    # matching epoch applies
    assert td.taskpool_addto_nb_tasks(tp, -2, epoch=tp.run_epoch) == 3
    # a restart bumped the generation: the stale batch drops whole
    tp.run_epoch += 1
    assert td.taskpool_addto_nb_tasks(tp, -3, epoch=0) == 3
    assert tp.nb_tasks == 3
    # current-generation flushes keep applying
    assert td.taskpool_addto_nb_tasks(tp, -3, epoch=1) == 0
    assert not fired   # NOT_READY: no termination fired


def test_c_chain_discards_a_stale_generation_task():
    """The recovery fence the C chain carries: a task built under an
    older run_epoch is discarded without running or decrementing."""
    from parsec_tpu_torch.core.task import TaskClass
    from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
    ran = []
    tp = ParameterizedTaskpool("stale")
    tc = tp.add_task_class(TaskClass(
        "C", params=[("i", lambda g, l: range(1))],
        body=lambda es, task: ran.append(1)))
    stale = tc.native_vt().build_one({"i": 0})
    tp.run_epoch = 1
    events = []
    with port_context.Context(nb_cores=1, device="cpu") as ctx:
        ctx.pins_register("task_discard", lambda es, e, t: events.append(t))
        tp.context = ctx
        es = ctx.streams[0]
        ctx.scheduler.schedule(es, [stale])
        # the worker may already have taken it: wait for the discard
        import time
        deadline = time.monotonic() + 10
        while not events and time.monotonic() < deadline:
            time.sleep(0.01)
    assert events == [stale] and not ran


def test_doorbell_suppression_no_lost_wakeup():
    """ring_doorbell skips the condvar entirely while no worker has
    raised its waiting flag, and the probe-under-lock discipline means a
    push racing the flag is never lost: N sequential waves complete."""
    done = []
    with port_context.Context(nb_cores=2, device="cpu") as ctx:
        for _ in range(5):
            p = port_ptg.PTG("dbw", N=64)
            p.task("E", i=port_ptg.Range(0, 63)).flow("x", "CTL") \
                .body(lambda: done.append(1))
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=20)
        # idle workers park with their waiting flag raised; the flag
        # count can never exceed the worker population
        assert 0 <= ctx._db_waiters <= ctx.nb_cores
    assert len(done) == 5 * 64
