"""The port's native core (parsec_tpu_torch/native): the ctypes-bound C++
primitives against their Python twins, the schedext ready queue and dep
countdown, the ``sched_native`` A/B gate, the build hardening, and the
GEMM, QR and potrf slices on both scheduler paths.

Twins of the JAX package's tests/test_native.py and
tests/test_sched_native.py.  One deliberate difference: a native source
that does not build raises here (NativeBuildError) instead of degrading
to the Python path with a warning."""

import threading

import numpy as np
import pytest
import torch

from parsec_tpu_torch import native
from parsec_tpu_torch.native import load_schedext
from parsec_tpu_torch.utils.mca import params

se = load_schedext()


# ---------------------------------------------------------------------------
# core.cpp through ctypes (twins of tests/test_native.py)
# ---------------------------------------------------------------------------

def test_dequeue_order_and_identity():
    d = native.NativeDequeue()
    objs = [object() for _ in range(8)]
    for o in objs:
        d.push_back(o)
    assert len(d) == 8
    assert d.pop_front() is objs[0]
    assert d.pop_back() is objs[-1]
    d.push_front(objs[0])
    assert d.pop_front() is objs[0]


def test_dequeue_same_object_twice():
    d = native.NativeDequeue()
    o = object()
    d.push_back(o)
    d.push_back(o)
    assert d.pop_front() is o and d.pop_front() is o and d.pop_front() is None


def test_dequeue_mpmc_stress():
    """Multithreaded producers/consumers: nothing lost, nothing doubled
    (the tests/class/lifo.c pattern)."""
    d = native.NativeDequeue()
    N, NPROD = 2000, 4
    seen = []
    seen_lock = threading.Lock()
    done = threading.Event()

    def produce(base):
        for i in range(N):
            d.push_back(base + i)

    def consume():
        while not (done.is_set() and len(d) == 0):
            v = d.pop_front()
            if v is not None:
                with seen_lock:
                    seen.append(v)

    cons = [threading.Thread(target=consume) for _ in range(3)]
    for c in cons:
        c.start()
    prods = [threading.Thread(target=produce, args=(k * N,))
             for k in range(NPROD)]
    for p in prods:
        p.start()
    for p in prods:
        p.join()
    done.set()
    for c in cons:
        c.join(timeout=30)
    assert sorted(seen) == sorted(k * N + i
                                  for k in range(NPROD) for i in range(N))


def test_zone_parity_with_python():
    """The native allocator mirrors ZoneAllocator semantics exactly."""
    from parsec_tpu_torch.utils.zone_alloc import ZoneAllocator
    py = ZoneAllocator(8192, 512)
    cc = native.NativeZoneAllocator(8192, 512)
    offs_py, offs_cc = [], []
    for nbytes in (100, 512, 1024, 2048, 513):
        offs_py.append(py.malloc(nbytes))
        offs_cc.append(cc.malloc(nbytes))
    assert offs_py == offs_cc
    py.free(offs_py[2])
    cc.free(offs_cc[2])
    assert py.malloc(700) == cc.malloc(700)
    assert py.used_bytes() == cc.used_bytes()
    assert py.free_bytes() == cc.free_bytes()
    with pytest.raises(ValueError):
        cc.free(offs_cc[2] + 1 * 512 * 100)   # never-allocated offset


def test_zone_exhaustion_and_defrag():
    z = native.NativeZoneAllocator(2048, 512)
    offs = [z.malloc(512) for _ in range(4)]
    assert None not in offs
    assert z.malloc(1) is None
    for o in offs:
        z.free(o)
    assert z.check_defrag()
    assert z.malloc(2048) == 0


def test_zone_matches_the_jax_package_allocator():
    """The same allocation trace gives the same offsets and byte counts
    as the JAX package's native allocator."""
    ref_native = pytest.importorskip("parsec_tpu.native")
    if not ref_native.available():
        pytest.skip("the JAX package's native core did not build")
    ours = native.NativeZoneAllocator(1 << 16, 512)
    ref = ref_native.NativeZoneAllocator(1 << 16, 512)
    rng = np.random.default_rng(5)
    live = []
    for step in range(200):
        if live and rng.random() < 0.4:
            i = int(rng.integers(len(live)))
            a, b = live.pop(i)
            ours.free(a)
            ref.free(b)
        else:
            nb = int(rng.integers(1, 4096))
            a, b = ours.malloc(nb), ref.malloc(nb)
            assert a == b, step
            if a is not None:
                live.append((a, b))
        assert ours.used_bytes() == ref.used_bytes()
        assert ours.free_bytes() == ref.free_bytes()


def test_trace_buffer_drain():
    t = native.NativeTraceBuffer()
    for i in range(100):
        t.event(i, i & 3, 1, i, 0, float(i))
    assert len(t) == 100
    evs = t.drain()
    assert evs[0] == (0, 0, 1, 0, 0, 0.0)
    assert evs[99] == (99, 3, 1, 99, 0, 99.0)
    assert t.drain(start=98) == evs[98:]
    t.events_bulk([(7, 1, 2, 3, -1, 4.5)])
    assert t.drain(start=100) == [(7, 1, 2, 3, -1, 4.5)]


def test_runtime_on_native_ledger():
    """A full PTG run on the native device memory ledger gives correct
    numerics, and the scheduler's object queues stay the Python Dequeue
    (the native dequeue has no consumer; the integration seam)."""
    from parsec_tpu_torch.apps.gemm import gemm_taskpool
    from parsec_tpu_torch.containers.lists import Dequeue
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

    rng = np.random.default_rng(9)
    n, mb = 64, 16
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    A = TwoDimBlockCyclic(mb, mb, n, n, name="A").from_array(
        torch.from_numpy(a))
    B = TwoDimBlockCyclic(mb, mb, n, n, name="B").from_array(
        torch.from_numpy(b))
    C = TwoDimBlockCyclic(mb, mb, n, n, name="C").from_array(
        torch.zeros(n, n))
    params.set("device_mem_mb", 1)
    try:
        with Context(nb_cores=2, scheduler="gd", device="cpu") as ctx:
            assert type(ctx.scheduler._q) is Dequeue
            (dev,) = ctx.device_registry.accelerators
            assert type(dev._zone) is native.NativeZoneAllocator
            ctx.add_taskpool(gemm_taskpool(A, B, C))
            ctx.wait(timeout=120)
    finally:
        params.unset("device_mem_mb")
    np.testing.assert_allclose(C.to_array().numpy(), a @ b,
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# build hardening: where the artifacts go, stale-source rebuild, and a
# missing compiler that raises
# ---------------------------------------------------------------------------

_MINI_C = r"""
#define PY_SSIZE_T_CLEAN
#include <Python.h>
static PyObject *answer(PyObject *s, PyObject *a) {
    (void)s; (void)a; return PyLong_FromLong(%d);
}
static PyMethodDef m[] = {{"answer", answer, METH_NOARGS, ""},
                          {NULL, NULL, 0, NULL}};
static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT,
                                 "parsec_tpu_torch_miniext",
                                 NULL, -1, m, NULL, NULL, NULL, NULL};
PyMODINIT_FUNC PyInit_parsec_tpu_torch_miniext(void) {
    return PyModule_Create(&mod);
}
"""


def test_artifacts_build_into_the_build_directory():
    import os
    build = os.path.join(os.path.dirname(native._HERE), "_build")
    assert native._BUILD == build
    assert os.path.isfile(os.path.join(build, "libparsec_tpu_torch.so"))
    assert os.path.isfile(
        os.path.join(build, "parsec_tpu_torch_schedext.so"))
    assert se.__name__ == "parsec_tpu_torch_schedext"
    assert not [f for f in os.listdir(native._HERE) if f.endswith(".so")]


def test_stale_so_triggers_rebuild(tmp_path, monkeypatch):
    """An edited .c next to an older .so must rebuild, not load the
    stale artifact (the mtime check of native._stale/_load_cext)."""
    import os
    import time as _time
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cexts", {})
    src = tmp_path / "miniext.c"
    src.write_text(_MINI_C % 1)
    mod = native._load_cext("miniext")
    assert mod.answer() == 1
    so = tmp_path / "build" / "parsec_tpu_torch_miniext.so"
    built_at = so.stat().st_mtime_ns
    _time.sleep(0.02)
    src.write_text(_MINI_C % 2)
    os.utime(src)
    native._cexts.pop("miniext")        # fresh-process semantics
    assert native._stale(str(so), str(src))
    assert native._load_cext("miniext") is not None
    assert so.stat().st_mtime_ns > built_at, "stale .so not rebuilt"
    assert not native._stale(str(so), str(src))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """A failing toolchain raises NativeBuildError — once per build
    attempt, and the cached failure raises again on every later load —
    where the JAX package falls back to Python with one warning."""
    import subprocess as sp

    calls = []

    def no_compiler(*a, **k):
        calls.append(a)
        raise FileNotFoundError("g++: not found")

    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cexts", {})
    monkeypatch.setattr(sp, "run", no_compiler)
    (tmp_path / "extone.c").write_text(_MINI_C % 1)
    (tmp_path / "exttwo.c").write_text(_MINI_C % 1)
    for name in ("extone", "exttwo"):
        with pytest.raises(native.NativeBuildError, match="g\\+\\+"):
            native._load_cext(name)
    assert len(calls) == 2              # both attempted a build
    with pytest.raises(native.NativeBuildError):
        native._load_cext("extone")     # cached failure: no new build
    assert len(calls) == 2


def test_compile_error_raises_with_the_compiler_stderr(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cexts", {})
    (tmp_path / "broken.c").write_text("this is not C;\n")
    with pytest.raises(native.NativeBuildError, match="broken.c"):
        native._load_cext("broken")


def test_default_scheduler_raises_when_schedext_does_not_build(
        tmp_path, monkeypatch):
    """sched_native=1 with no schedext: the default scheduler does not
    come up on the Python ladder; sched_native=0 does."""
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.sched import create
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_cexts", {})
    with pytest.raises(native.NativeBuildError, match="schedext"):
        create()
    params.set("sched_native", 0)
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            assert ctx.scheduler.name == "lfq"
    finally:
        params.unset("sched_native")


# ---------------------------------------------------------------------------
# schedext ReadyQueue / DepTable (twins of tests/test_sched_native.py)
# ---------------------------------------------------------------------------

class _T:
    __slots__ = ("priority", "status", "ready_at")

    def __init__(self, prio=0):
        self.priority = prio
        self.status = 0
        self.ready_at = None


def _rq():
    from parsec_tpu_torch.core.task import TaskStatus
    return se.ReadyQueue(TaskStatus.READY), TaskStatus.READY


def test_ready_queue_priority_and_fifo_order():
    q, READY = _rq()
    ts = [_T(1), _T(5), _T(5), _T(0)]
    q.push_batch(ts, 0)
    assert len(q) == 4
    # highest priority first, FIFO among equals, then the rest
    assert q.pop() is ts[1]
    assert q.pop() is ts[2]
    assert q.pop() is ts[0]
    assert q.pop() is ts[3]
    assert q.pop() is None
    for t in ts:
        assert t.status is READY


def test_ready_queue_stamp_gates_ready_at():
    q, _ = _rq()
    a, b = _T(), _T()
    q.push_batch([a], 0)
    assert a.ready_at is None          # telemetry off: no stamp
    q.push_batch([b], 1)
    assert isinstance(b.ready_at, float) and b.ready_at > 0


def test_ready_queue_to_back_fairness():
    """distance-rescheduled tasks go behind EVERYTHING, priority
    notwithstanding (the sched/__init__.py fairness contract)."""
    q, _ = _rq()
    again = _T(100)
    normal = _T(0)
    q.push_batch([again], 0, 1)        # to_back
    q.push_batch([normal], 0)
    assert q.pop() is normal
    assert q.pop() is again


def test_ready_queue_stats():
    q, _ = _rq()
    q.push_batch([_T(), _T(), _T()], 0)
    q.pop()
    pushes, pops, max_len, pending = q.stats()
    assert (pushes, pops, max_len, pending) == (3, 1, 3, 2)


def test_ready_queue_threads_push_and_pop_under_the_gil():
    """Producers off the worker threads (the device module's manager and
    completer) and consumers at once: every task out exactly once."""
    q, _ = _rq()
    N, NPROD = 500, 4
    got, lock = [], threading.Lock()
    stop = threading.Event()

    def produce(k):
        for i in range(N):
            q.push_batch([_T(i % 7)], 0)

    def consume():
        while not (stop.is_set() and len(q) == 0):
            t = q.pop()
            if t is not None:
                with lock:
                    got.append(t)

    import sys
    cons = [threading.Thread(target=consume) for _ in range(2)]
    prods = [threading.Thread(target=produce, args=(k,))
             for k in range(NPROD)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)     # thread switches inside every window
    try:
        for t in cons + prods:
            t.start()
        for t in prods:
            t.join(timeout=60)
        stop.set()
        for t in cons:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in cons + prods)
    assert len(got) == len({id(t) for t in got}) == N * NPROD
    assert q.stats()[:2] == (N * NPROD, N * NPROD)


def test_dep_table_countdown_and_ready_payload():
    dt = se.DepTable()
    key = ("X", 1)
    assert dt.arrive(key, "a", None, None) is False   # miss
    dt.create(key, 2, {"i": 1})
    assert dt.arrive(key, "a", "COPY", ("tc", "k")) is None
    res = dt.arrive(key, "b", None, None)
    locals_, inputs, sources = res
    assert locals_ == {"i": 1}
    # EVERY arrival records its binding, None included (a CTL edge
    # must land flow->None in task.data)
    assert inputs == {"a": "COPY", "b": None}
    assert sources == {"a": ("tc", "k")}
    assert len(dt) == 0


def test_dep_table_create_keeps_existing_record():
    """Two workers racing the first arrivals both observe the miss;
    the second create must not wipe the first's recorded arrival."""
    dt = se.DepTable()
    key = ("Y", 0)
    dt.create(key, 2, {"j": 0})
    assert dt.arrive(key, "a", None, None) is None    # 1/2
    dt.create(key, 2, {"j": 0})                       # racing create
    assert dt.arrive(key, "b", None, None) is not None  # 2/2 ready


def test_dep_table_two_copies_on_data_flow_raises():
    dt = se.DepTable()
    dt.create(("Z",), 3, {})
    dt.arrive(("Z",), "d", "COPY1", None)
    with pytest.raises(RuntimeError, match="two copies"):
        dt.arrive(("Z",), "d", "COPY2", None)


def test_dep_table_none_does_not_clobber_copy():
    dt = se.DepTable()
    dt.create(("W",), 2, {})
    dt.arrive(("W",), "c", "REAL", None)
    _, inputs, _ = dt.arrive(("W",), "c", None, None)
    assert inputs == {"c": "REAL"}


def test_scheduler_selection_knob():
    """No explicit component + sched_native on -> the native queue;
    off -> the Python ladder (lfq by priority)."""
    from parsec_tpu_torch.sched import create
    params.set("sched_native", 1)
    try:
        assert create().name == "native"
        assert create("lfq").name == "lfq"   # explicit always wins
        params.set("sched_native", 0)
        assert create().name == "lfq"
    finally:
        params.unset("sched_native")


def test_the_default_is_the_native_path():
    """With no knob set a Context runs the C scheduler: its ready queue,
    a DepTable per pool, TaskVT-built tasks and run_quantum workers."""
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.dsl.ptg import PTG, Range
    seen = []
    p = PTG("dflt", N=8)
    p.task("E", i=Range(0, 7)).flow("x", "CTL") \
        .body(lambda task: seen.append(type(task)))
    tp = p.build()
    assert type(tp._native_deps) is se.DepTable
    b0 = dict(se.bailout_stats())
    with Context(nb_cores=2, device="cpu") as ctx:
        assert ctx.scheduler.name == "native"
        assert ctx.scheduler.NATIVE_BATCH
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
        pushes, pops, _, pending = ctx.scheduler._q.stats()
    assert seen == [se.TaskCore] * 8
    assert (pushes, pops, pending) == (8, 8, 0)
    assert se.bailout_stats() == b0      # all 8 ran on the C chain


def test_scheduler_stats_count_every_task():
    """The native queue's counters (the JAX package scrapes them into
    its metrics family, which the port does not carry)."""
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.dsl.ptg import PTG, Range
    p = PTG("stats", N=32)
    p.task("E", i=Range(0, 31)).flow("x", "CTL").body(lambda: None)
    with Context(nb_cores=1, device="cpu") as ctx:
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
        st = ctx.scheduler.stats()
        text = ctx.scheduler.display_stats(ctx.streams[0])
    assert st["pops"] >= 32 and st["pushes"] >= 32 and st["pending"] == 0
    assert text.startswith("native: pushes=")


def test_again_task_does_not_livelock_native():
    """An AGAIN-returning body rides the to_back path and the work it
    waits on still runs (the fairness contract, end to end)."""
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.core.task import HookReturn
    from parsec_tpu_torch.dsl.ptg import PTG, Range

    state = {"done": False, "again": 0}

    def waiter():
        if not state["done"]:
            state["again"] += 1
            if state["again"] > 10000:
                raise RuntimeError("livelock: AGAIN starved the work")
            return HookReturn.AGAIN
        return None

    def worker():
        state["done"] = True

    p = PTG("fair", N=1)
    p.task("W", i=Range(0, 0)).flow("x", "CTL").body(waiter)
    p.task("D", i=Range(0, 0)).flow("x", "CTL").body(worker)
    params.set("sched_native", 1)
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            assert ctx.scheduler.name == "native"
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=60)
    finally:
        params.unset("sched_native")
    assert state["done"]


# ---------------------------------------------------------------------------
# the slices on both scheduler paths: bit-identical outputs (the deps fix
# every accumulation order)
# ---------------------------------------------------------------------------

def _mat(mb, n, arr, name):
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    return TwoDimBlockCyclic(mb, mb, n, n, name=name).from_array(
        torch.from_numpy(arr.copy()))


def _slice_run(app, native_flag):
    from parsec_tpu_torch.core.context import Context
    rng = np.random.default_rng(21)
    params.set("sched_native", native_flag)
    try:
        b0 = dict(se.bailout_stats())
        with Context(nb_cores=3, device="cpu") as ctx:
            assert (ctx.scheduler.name == "native") == bool(native_flag)
            if app == "gemm":
                from parsec_tpu_torch.apps.gemm import gemm_taskpool
                n, mb = 48, 16
                mats = [_mat(mb, n, rng.standard_normal((n, n)).astype(
                    np.float32), nm) for nm in "ABC"]
                tp = gemm_taskpool(*mats)
                out = mats[2]
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
            assert (tp._native_deps is not None) == bool(native_flag)
            ctx.add_taskpool(tp)
            ctx.wait(timeout=120)
        b1 = se.bailout_stats()
        return out.to_array().clone(), {k: b1[k] - b0[k] for k in b1
                                        if b1[k] != b0[k]}
    finally:
        params.unset("sched_native")


@pytest.mark.parametrize("app", ["gemm", "qr", "potrf"])
def test_slice_is_bit_identical_on_both_scheduler_paths(app):
    nat, bail_nat = _slice_run(app, 1)
    lad, bail_lad = _slice_run(app, 0)
    assert torch.equal(nat, lad)
    assert bool(torch.isfinite(nat).all())
    # every device task pops back to Python from the C chain (a "cuda"
    # incarnation is no single cpu incarnation); the ladder never
    # touches the C counters
    assert set(bail_nat) == {"non_trivial"} and bail_nat["non_trivial"] > 0
    assert bail_lad == {}
