"""The port's DTD front-end (insert_task) against the JAX package's.

Twins of tests/test_dsl_dtd.py: each case builds its insert stream once
for both packages, from the same seeded numpy inputs, with bodies written
once (numpy on the JAX side, CPU tensors on the port's, which runs with
``device="cpu"``).  The two runs must agree on the values, on the tasks
executed per class (``complete_exec``) and on the pool's termdet counters
(``nb_tasks``, ``nb_pending_actions``).  The device GEMM runs K1's body
(``gemm_tile``, its plain version on the CPU-backed device module) against
the JAX package's ``device="tpu"`` XLA body on JAX's CPU.
"""

import collections
import threading

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.dtd as jax_dtd
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.dtd as port_dtd
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.utils.mca import params as port_params

#: side -> (context module, matrix module, dtd module, Context kwargs,
#: the package's device incarnation name)
SIDES = {
    "jax": (jax_context, jax_matrix, jax_dtd, {}, "tpu"),
    "port": (port_context, port_matrix, port_dtd, {"device": "cpu"},
             "cuda"),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def _tile(M, *idx):
    return _np(M.data_of(*idx).pull_to_host().payload)


def _fill(M, idx, value):
    M.data_of(*idx).copy_on(0).payload[:] = value


class _Run:
    """One package's run of a case: the context, a per-class completion
    counter, and the pools it made (for their termdet counters)."""

    def __init__(self, side, nb_cores=2):
        self.side = side
        self.ctx_mod, self.mat, self.dtd, self.kw, self.dev = SIDES[side]
        self.nb_cores = nb_cores
        self.done = collections.Counter()
        self.pools = []
        self._lock = threading.Lock()

    def __enter__(self):
        self.ctx = self.ctx_mod.Context(nb_cores=self.nb_cores,
                                        **self.kw).__enter__()

        def count(es, event, task):
            with self._lock:
                self.done[task.task_class.name] += 1
        self.ctx.pins_register("complete_exec", count)
        return self

    def __exit__(self, *exc):
        return self.ctx.__exit__(*exc)

    def pool(self, name="dtd"):
        tp = self.dtd.DTDTaskpool(name)
        self.ctx.add_taskpool(tp)
        self.ctx.start()
        self.pools.append(tp)
        return tp

    def counts(self):
        return dict(self.done), [(tp.nb_tasks, tp.nb_pending_actions)
                                 for tp in self.pools]


def _both(case, **kw):
    """(jax result, port result) of ``case(run, **kw)``; each result is
    (values, per-class completions, termdet counters per pool)."""
    out = []
    for side in ("jax", "port"):
        with _Run(side) as run:
            vals = case(run, **kw)
        out.append((vals,) + run.counts())
    return out


def _same(j, p, exact=True, tol=0.0):
    assert j[0].keys() == p[0].keys()
    for k in j[0]:
        if exact:
            np.testing.assert_array_equal(p[0][k], j[0][k], err_msg=k)
        else:
            np.testing.assert_allclose(p[0][k], j[0][k], rtol=tol,
                                       atol=tol, err_msg=k)
    assert p[1] == j[1]                  # executed tasks per class
    assert p[2] == j[2]                  # termdet counters per pool
    assert all(c == (0, 0) for c in p[2])


# -- the twins of tests/test_dsl_dtd.py ---------------------------------------

def _chain(run):
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 0.0)
    tp = run.pool()
    t = tp.tile_of(A, 0, 0)
    for _ in range(25):
        tp.insert_task(lambda T: T + 1.0, (t, run.dtd.INOUT))
    tp.wait()
    return {"A": _tile(A, 0, 0)}


def test_chain_of_increments():
    j, p = _both(_chain)
    _same(j, p)
    np.testing.assert_allclose(p[0]["A"], 25.0)
    assert sum(p[1].values()) == 25


def _war_waw(run):
    d = run.dtd
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4, name="A")
    B = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4, name="B")
    _fill(A, (0, 0), 5.0)
    _fill(B, (0, 0), 0.0)
    seen = []
    tp = run.pool()
    ta = tp.tile_of(A, 0, 0)
    tb = tp.tile_of(B, 0, 0)
    for i in range(4):
        def reader(src, dst, i=i):
            seen.append(float(np.asarray(src)[0, 0]))
            out = np.asarray(dst).copy()
            out[0, i] = np.asarray(src)[0, 0]
            return {"dst": out}
        tp.insert_task(reader, (ta, d.INPUT), (tb, d.INOUT))
    tp.insert_task(lambda T: T * 0.0 + 9.0, (ta, d.INOUT))

    def late(src, dst):
        out = np.asarray(dst).copy()
        out[3, 3] = np.asarray(src)[0, 0]
        return {"dst": out}
    tp.insert_task(late, (ta, d.INPUT), (tb, d.INOUT))
    tp.wait()
    return {"seen": np.array(seen), "B": _tile(B, 0, 0)}


def test_war_waw_hazards():
    j, p = _both(_war_waw)
    _same(j, p)
    assert list(p[0]["seen"]) == [5.0] * 4
    assert p[0]["B"][3, 3] == 9.0


def _value_scratch(run):
    d = run.dtd
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 1.0)
    tp = run.pool()
    t = tp.tile_of(A, 0, 0)

    def axpy(T, alpha, tmp):
        tmp[:] = T * alpha
        return {"T": tmp}
    tp.insert_task(axpy, (t, d.INOUT), (3.0, d.VALUE), ((4, 4), d.SCRATCH))
    tp.wait()
    return {"A": _tile(A, 0, 0)}


def test_value_and_scratch_args():
    j, p = _both(_value_scratch)
    _same(j, p)
    np.testing.assert_allclose(p[0]["A"], 3.0)


def test_windowing_throttles_and_completes():
    for prm in (jax_params, port_params):
        prm.set("dtd_window_size", 8)
        prm.set("dtd_threshold_size", 4)
    try:
        def case(run):
            A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
            _fill(A, (0, 0), 0.0)
            tp = run.pool()
            assert (tp.window_size, tp.threshold) == (8, 4)
            t = tp.tile_of(A, 0, 0)
            for _ in range(200):
                tp.insert_task(lambda T: T + 1.0, (t, run.dtd.INOUT))
            tp.wait()
            return {"A": _tile(A, 0, 0)}
        j, p = _both(case)
    finally:
        for prm in (jax_params, port_params):
            prm.unset("dtd_window_size")
            prm.unset("dtd_threshold_size")
    _same(j, p)
    np.testing.assert_allclose(p[0]["A"], 200.0)


def _tile_new(run):
    tp = run.pool()
    t = tp.tile_new((8, 8))
    tp.insert_task(lambda T: T + 2.5, (t, run.dtd.INOUT), device=run.dev)
    tp.wait()
    tp.data_flush_all()
    return {"T": _np(t.data.copy_on(0).payload)}


def test_tile_new_and_flush():
    j, p = _both(_tile_new)
    _same(j, p)
    np.testing.assert_allclose(p[0]["T"], 2.5)


def _device_gemm(run, a, b, c, mb, mt):
    d = run.dtd
    if run.side == "port":
        from parsec_tpu_torch.apps.gemm import _tile_kernel
        gemm = _tile_kernel(1.0)       # K1's body: gemm_tile, grouped
        conv = torch.from_numpy
    else:
        def fn(Ai, Bi, Ci):            # named as K1's body is
            return {"Ci": Ci + Ai @ Bi}
        gemm = fn
        conv = np.array
    A = run.mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=mt * mb, ln=mt * mb,
                                  name="A").from_array(conv(a.copy()))
    B = run.mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=mt * mb, ln=mt * mb,
                                  name="B").from_array(conv(b.copy()))
    C = run.mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=mt * mb, ln=mt * mb,
                                  name="C").from_array(conv(c.copy()))
    tp = run.pool()
    for m in range(mt):
        for n in range(mt):
            for k in range(mt):
                tp.insert_task(gemm, (A(m, k), d.INPUT), (B(k, n), d.INPUT),
                               (C(m, n), d.INOUT), device=run.dev)
    tp.wait()
    out = {"C": _np(C.to_array())}
    if run.side == "port":
        st = run.ctx.device_registry.devices[-1].stats
        out["device"] = np.array([st.executed_tasks, st.donated_tasks,
                                  st.faults])
    return out


def test_dtd_gemm_device_matches_numpy():
    """The reference's headline DTD test (dtd_test_simple_gemm.c): tiled
    GEMM through insert_task with device bodies."""
    mt, mb = 2, 16
    rng = np.random.default_rng(21)
    a, b, c = (rng.standard_normal((mt * mb, mt * mb)).astype(np.float32)
               for _ in range(3))
    j, p = _both(_device_gemm, a=a, b=b, c=c, mb=mb, mt=mt)
    dev = p[0].pop("device")
    assert list(dev) == [mt ** 3, mt ** 3, 0]   # every task on the module
    _same(j, p, exact=False, tol=1e-3)
    np.testing.assert_allclose(p[0]["C"], c + a @ b, rtol=1e-3, atol=1e-3)


def _failed(run):
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 0.0)

    def boom(T):
        raise ValueError("kaboom")
    tp = run.pool()
    t = tp.tile_of(A, 0, 0)
    tp.insert_task(boom, (t, run.dtd.INOUT))
    tp.insert_task(lambda T: T + 1.0, (t, run.dtd.INOUT))
    with pytest.raises(RuntimeError) as exc:
        tp.wait(timeout=10)
    return {"cause": np.array([isinstance(exc.value.__cause__,
                                          ValueError)])}


def test_failed_task_raises_instead_of_hanging():
    for side in ("jax", "port"):
        with _Run(side) as run:
            got = _failed(run)
        assert got["cause"][0]


def _affinity(run):
    d = run.dtd
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 1.0)
    tp = run.pool()
    t = tp.tile_of(A, 0, 0)
    task = tp.insert_task(lambda T: T + 1.0, (t, d.INOUT), (0, d.AFFINITY))
    tp.wait()
    return {"A": _tile(A, 0, 0), "aff": np.array([task.dtd.affinity])}


def test_affinity_marker_accepted():
    j, p = _both(_affinity)
    _same(j, p)
    np.testing.assert_allclose(p[0]["A"], 2.0)
    assert p[0]["aff"][0] == 0


def _scratch_single(run):
    d = run.dtd
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 2.0)
    tp = run.pool()
    t = tp.tile_of(A, 0, 0)
    tp.insert_task(lambda T, tmp: T * 2.0, (t, d.INOUT),
                   ((4, 4), d.SCRATCH))
    tp.wait()
    return {"A": _tile(A, 0, 0)}


def test_scratch_with_single_value_return():
    j, p = _both(_scratch_single)
    _same(j, p)
    np.testing.assert_allclose(p[0]["A"], 4.0)


def _closure_free(run):
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 0.0)
    tp = run.pool()
    t = tp.tile_of(A, 0, 0)
    for _ in range(20):
        tp.insert_task(lambda T: T + 1.0, (t, run.dtd.INOUT))
    tp.wait()
    return {"A": _tile(A, 0, 0), "classes": np.array([len(tp.task_classes)])}


def test_closure_free_lambdas_share_task_class():
    j, p = _both(_closure_free)
    _same(j, p)
    assert p[0]["classes"][0] == 1
    np.testing.assert_allclose(p[0]["A"], 20.0)


def _two_pools(run):
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 0.0)
    tp1 = run.pool("p1")
    tp1.insert_task(lambda T: T + 1.0, (tp1.tile_of(A, 0, 0), run.dtd.INOUT))
    tp1.wait()
    tp2 = run.pool("p2")
    tp2.insert_task(lambda T: T * 3.0, (tp2.tile_of(A, 0, 0), run.dtd.INOUT))
    tp2.wait()
    return {"A": _tile(A, 0, 0)}


def test_mixed_dtd_then_second_pool():
    j, p = _both(_two_pools)
    _same(j, p)
    np.testing.assert_allclose(p[0]["A"], 3.0)


def _regions(run, slices):
    d = run.dtd
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 0.0)
    RU = d.Region("upper", slices=(slice(0, 1),) if slices else None)
    RL = d.Region("lower", slices=(slice(3, 4),) if slices else None)
    tp = run.pool()
    t = tp.tile_of(A, 0, 0)

    def wr_u(T):
        T[0, :] = T[0, :] + 1.0

    def wr_l(T):
        T[3, :] = T[3, :] + 2.0
    tp.insert_task(wr_u, (t, d.INOUT | RU))
    t2 = tp.insert_task(wr_l, (t, d.INOUT | RL))
    rem2 = t2.dtd.remaining          # disjoint regions: no pending deps
    t3 = tp.insert_task(lambda T: None, (t, d.INPUT))
    rem3 = t3.dtd.remaining          # orders against both lanes
    tp.insert_task(lambda T: T * 2.0, (t, d.INOUT))
    tp.wait()
    return {"A": _tile(A, 0, 0), "rem": np.array([rem2, rem3 in (1, 2)])}


@pytest.mark.parametrize("slices", [True, False],
                         ids=["region_masks", "ordering_only"])
def test_region_lanes(slices):
    """Twins of test_region_masks_disjoint_writers_run_unordered (lanes
    with an extent) and test_ordering_only_region_accepted_shared_memory
    (extent-less lanes): disjoint lanes take no edge, a whole-tile access
    orders against every lane."""
    j, p = _both(_regions, slices=slices)
    _same(j, p)
    assert list(p[0]["rem"]) == [0, 1]
    out = p[0]["A"]
    np.testing.assert_allclose(out[0, :], 2.0)
    np.testing.assert_allclose(out[3, :], 4.0)
    np.testing.assert_allclose(out[1:3, :], 0.0)


def _pushout(run):
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 1.0)
    tp = run.pool()
    t = tp.tile_of(A, 0, 0)
    tp.insert_task(lambda T: T + 41.0, (t, run.dtd.INOUT | run.dtd.PUSHOUT))
    tp.wait()
    datum = A.data_of(0, 0)
    newest = max(c.version for c in datum.copies().values()
                 if c.payload is not None)
    hc = datum.copy_on(0)
    return {"home": _np(hc.payload),
            "current": np.array([hc.version == newest])}


def test_pushout_forces_result_home():
    j, p = _both(_pushout)
    _same(j, p)
    assert p[0]["current"][0]
    np.testing.assert_allclose(p[0]["home"], 42.0)


def _task_class(run):
    d = run.dtd
    A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    _fill(A, (0, 0), 3.0)
    ran = {"cpu": 0}
    tp = run.pool()
    cls = tp.create_task_class("axpy", ["T", "s"], [d.INOUT, d.VALUE])
    cls.add_chore(run.dev, lambda T, s: T * s)

    def cpu_axpy(T, s):
        ran["cpu"] += 1
        return T * s
    cls.add_chore("cpu", cpu_axpy)
    t = tp.tile_of(A, 0, 0)
    tp.insert_task(cls, (t, d.INOUT), (2.0, d.VALUE))
    tp.insert_task(cls, (t, d.INOUT), (5.0, d.VALUE))
    with pytest.raises(TypeError, match="do not match"):
        tp.insert_task(cls, (t, d.INPUT), (1.0, d.VALUE))
    tp.wait()
    return {"A": _tile(A, 0, 0), "cpu": np.array([ran["cpu"]])}


def test_create_task_class_add_chore():
    """Explicit task classes with per-device chores: the device chore
    (declared first) runs on both packages' device modules."""
    j, p = _both(_task_class)
    _same(j, p)
    np.testing.assert_allclose(p[0]["A"], 30.0)
    assert p[0]["cpu"][0] == 0


# -- the port's own ----------------------------------------------------------

def test_jax_device_names_raise():
    """``"tpu"``/``"xla"`` name the JAX package's module: the port raises
    instead of remapping them; ``"cuda"``/``"gpu"`` build a CudaKernel."""
    with _Run("port") as run:
        A = run.mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
        tp = run.pool()
        t = tp.tile_of(A, 0, 0)
        for dev in ("tpu", "xla"):
            with pytest.raises(ValueError, match="cuda"):
                tp.insert_task(lambda T: T + 1.0, (t, run.dtd.INOUT),
                               device=dev)
            with pytest.raises(ValueError, match="cuda"):
                tp.create_task_class("c", ["T"], [run.dtd.INOUT]) \
                    .add_chore(dev, lambda T: T)
        tp.insert_task(lambda T: T + 1.0, (t, run.dtd.INOUT), device="gpu")
        tp.wait()
        tc = next(iter(tp.task_classes.values()))
        assert [d for d, _ in tc.incarnations] == ["gpu", "cpu"]


def test_dtd_gemm_fuses_donates_and_matches_ptg():
    """apps/gemm.gemm_dtd_insert: one class for every insert (closure
    keyed by identity), waves fused onto gemm_tile_grouped, every C
    write donated, and C bit-identical to the PTG GEMM's (the same K1
    chain over k)."""
    from parsec_tpu_torch.apps.gemm import gemm_dtd_insert, gemm_taskpool
    n, mb = 96, 16
    g = torch.Generator().manual_seed(5)
    a, b = torch.randn(n, n, generator=g), torch.randn(n, n, generator=g)
    out = {}
    for kind in ("dtd", "ptg"):
        mats = [port_matrix.TwoDimBlockCyclic(mb, mb, n, n, name=nm)
                .from_array(x.clone())
                for nm, x in (("A", a), ("B", b), ("C", torch.zeros(n, n)))]
        with port_context.Context(nb_cores=2, device="cpu") as ctx:
            if kind == "dtd":
                tp = port_dtd.DTDTaskpool("g")
                ctx.add_taskpool(tp)
                ctx.start()
                assert gemm_dtd_insert(tp, *mats) == 216
                tp.wait()
                assert len(tp.task_classes) == 1
            else:
                ctx.add_taskpool(gemm_taskpool(*mats, device="cuda"))
                ctx.wait()
            st = ctx.device_registry.devices[-1].stats
            out[kind] = (mats[2].to_array(), st.executed_tasks,
                         st.donated_tasks, st.fused_tasks > 0)
    assert torch.equal(out["dtd"][0], out["ptg"][0])
    assert out["dtd"][1:] == out["ptg"][1:] == (216, 216, True)
    torch.testing.assert_close(out["dtd"][0], a @ b, rtol=1e-4, atol=1e-4)
