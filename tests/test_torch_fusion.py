"""The port's device module at its defaults against the JAX package's.

Wave fusion, chain fusion, buffer donation and degraded mode of
``parsec_tpu_torch/devices/cuda.py``, each held against the same DAG run
by ``parsec_tpu/devices/xla.py`` at the JAX package's own defaults on its
8-device CPU mesh (the wave test, like its twin in tests/test_devices.py,
queues the JAX wave on one device).  The port runs on its CPU-backed
device module, which fuses, chains and donates as the card does.  Both
packages' results must agree (f32 arithmetic, the same operations:
1e-5 relative, the factorizations 1e-4 as tests/test_devices.py holds
them), and each feature's counters must show that it ran — or, at its
off-switch, that it did not.
"""

import threading
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
from parsec_tpu.apps import potrf as jax_potrf
from parsec_tpu.apps import qr as jax_qr
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.apps import potrf as port_potrf
from parsec_tpu_torch.apps import qr as port_qr
from parsec_tpu_torch.utils.mca import params as port_params

#: side -> (context module, matrix module, PTG module, MCA params, the
#: device name a device body registers under, Context keywords)
SIDES = {
    "jax": (jax_context, jax_matrix, jax_ptg, jax_params, "tpu", {}),
    "port": (port_context, port_matrix, port_ptg, port_params, "cuda",
             {"device": "cpu"}),
}


def _matrix(side, mb, lm, ln, arr, name="A"):
    mod = SIDES[side][1]
    m = mod.TwoDimBlockCyclic(mb, mb, lm, ln, name=name)
    return m.from_array(arr.copy() if side == "jax"
                        else torch.from_numpy(arr.copy()))


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(side, build, knobs=()):
    """Build one DAG on one package and run it with ``knobs`` set; return
    (collections as numpy, each accelerator's counters, the third thing
    ``build`` returned)."""
    ctx_mod, _mat, ptg, params, dev, kw = SIDES[side]
    for knob, value in knobs:
        params.set(knob, value)
    try:
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            tp, mats, extra = build(side, ptg, dev)
            ctx.add_taskpool(tp)
            ctx.wait(timeout=120)
            # every attached device, disabled ones (degraded mode) too
            stats = [d.stats.as_dict()
                     for d in ctx.device_registry.devices[1:]]
    finally:
        for knob, _ in knobs:
            params.unset(knob)
    arrays = {k: _as_numpy(m.to_array()).astype(np.float32)
              for k, m in mats.items()}
    return arrays, stats, extra


def _total(stats, key):
    return sum(s[key] for s in stats)


def _rel(got, ref):
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


# -- wave fusion ----------------------------------------------------------------

MT, MB = 16, 8


def _wave(grouped: bool):
    """MUL(n) doubles tile A(0, n): MT independent same-class tasks.  The
    device body's first call stalls (on the JAX side: its trace, once per
    compile), so the rest of the wave queues behind it and fuses."""
    a = np.random.default_rng(3).standard_normal((MB, MT * MB)).astype(
        np.float32)

    def build(side, ptg, dev):
        A = _matrix(side, MB, MB, MT * MB, a)
        first = threading.Event()
        waves = []

        def mul(T):
            if not first.is_set():
                first.set()
                time.sleep(0.05)
            return T * 2.0

        if grouped and side == "port":
            def mul_wave(calls):
                waves.append(len(calls))
                return [mul(T) for (T,) in calls]
            mul.grouped = mul_wave
        p = ptg.PTG("wave", MT=MT)
        tb = p.task("MUL", n=ptg.Range(0, MT - 1)) \
            .affinity(lambda n, A=A: A(0, n)) \
            .flow("T", "RW",
                  ptg.IN(ptg.DATA(lambda n, A=A: A(0, n))),
                  ptg.OUT(ptg.DATA(lambda n, A=A: A(0, n))))
        tb.body(mul, device=dev)
        tb.body(lambda T: T * 2.0)
        return p.build(), {"A": A}, waves
    return a, build


@pytest.mark.parametrize("form", ["looped", "grouped"])
def test_wave_of_a_slow_first_launch_class_fuses(form):
    """The twin of tests/test_devices.py's wavefront test: the wave behind
    the slow first launch fuses on both sides.  ``grouped``: the port's
    kernel carries a grouped form, called once per fused wave."""
    a, build = _wave(form == "grouped")
    ref, ref_stats, _ = _run("jax", build, knobs=(("device_max", 1),))
    got, stats, waves = _run("port", build)
    np.testing.assert_allclose(got["A"], 2.0 * a, rtol=1e-6)
    np.testing.assert_array_equal(got["A"], ref["A"])
    for st in (stats, ref_stats):
        assert _total(st, "executed_tasks") == MT
        assert _total(st, "fused_launches") >= 1
        assert _total(st, "fused_tasks") >= 2
    if form == "grouped":
        assert waves and sum(waves) == _total(stats, "fused_tasks")
        assert len(waves) == _total(stats, "fused_launches")


# -- chain fusion ---------------------------------------------------------------

def _spd(n, seed):
    b = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    return (b @ b.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("fuse_panel", [1, 0])
def test_potrf_chain_fuses_and_not_at_fuse_panel_zero(fuse_panel):
    """The twin of tests/test_devices.py's cross-panel test: POTRF(k) is
    held and runs in its TRSM wave's launch step on both sides, and
    ``device_fuse_panel=0`` runs the per-kernel panel path with no chained
    launch.  L L^T against A within 1e-4 on both sides, and the two
    factors within 1e-5 of each other."""
    mb, nt = 16, 5
    n = mb * nt
    spd = _spd(n, 21)

    def build(side, ptg, dev):
        A = _matrix(side, mb, n, n, spd)
        mod = jax_potrf if side == "jax" else port_potrf
        return mod.potrf_taskpool(A, device=dev), {"A": A}, None

    knobs = (("device_fuse_panel", fuse_panel),)
    ref, ref_stats, _ = _run("jax", build, knobs)
    got, stats, _ = _run("port", build, knobs)
    for out in (got, ref):
        L = np.tril(out["A"]).astype(np.float64)
        assert np.abs(L @ L.T - spd).max() / np.abs(spd).max() < 1e-4
    assert _rel(np.tril(got["A"]), np.tril(ref["A"])) < 1e-5
    for st in (stats, ref_stats):
        launches = _total(st, "chained_launches")
        tasks = _total(st, "chained_tasks")
        if fuse_panel:
            assert launches > 0 and tasks > launches   # chains really ran
        else:
            assert launches == 0 and tasks == 0
    # every task ran on the port's device, held ones included
    assert _total(stats, "executed_tasks") == nt * (nt + 1) * (nt + 2) // 6


def test_qr_column_chain_stays_exact():
    """The twin of tests/test_devices.py's QR column test: successive
    TSQRT holds stack their placeholders on the same RW copy; the waves
    that consume them run the column, and the factorization stays exact
    (R's lower tiles zero, R^T R = A^T A to 1e-4) and equal to the JAX
    package's to 1e-4."""
    mb, nt = 8, 5
    n = mb * nt
    a = np.random.default_rng(22).standard_normal((n, n)).astype(np.float32)

    def build(side, ptg, dev):
        A = _matrix(side, mb, n, n, a)
        mod = jax_qr if side == "jax" else port_qr
        return mod.qr_taskpool(A, device=dev), {"A": A}, None

    ref, ref_stats, _ = _run("jax", build)
    got, stats, _ = _run("port", build)
    ata = a.astype(np.float64).T @ a
    for out in (got, ref):
        R = np.triu(out["A"]).astype(np.float64)
        assert np.abs(np.tril(out["A"], -1)).max() < 1e-4
        assert np.abs(R.T @ R - ata).max() / np.abs(ata).max() < 1e-4
    assert _rel(np.triu(got["A"]), np.triu(ref["A"])) < 1e-4
    assert _total(stats, "chained_launches") > 0
    assert _total(ref_stats, "chained_launches") > 0


@pytest.mark.parametrize("app", ["potrf", "qr"])
def test_run_chains_are_freed_by_reference_counting(app):
    """Once a held chain has run and its entry is finalized, nothing keeps
    its holds and placeholders alive: with the cyclic collector off, none
    is left after the run.  A hold reaches its task and every tile version
    the task read or wrote, so one left to a later cyclic collection keeps
    a pass's superseded tiles on the card into the next pass."""
    import gc
    from parsec_tpu_torch.devices.cuda import Deferred, _Hold
    mb, nt = 8, 5
    n = mb * nt
    arr = _spd(n, 23) if app == "potrf" else \
        np.random.default_rng(24).standard_normal((n, n)).astype(np.float32)

    def build(side, ptg, dev):
        A = _matrix(side, mb, n, n, arr)
        tp = port_potrf.potrf_taskpool(A, device=dev) if app == "potrf" \
            else port_qr.qr_taskpool(A, device=dev)
        return tp, {"A": A}, None

    gc.collect()
    gc.disable()
    try:
        _, stats, _ = _run("port", build)
        left = [o for o in gc.get_objects()
                if isinstance(o, (_Hold, Deferred))]
    finally:
        gc.enable()
    assert _total(stats, "chained_tasks") > 0
    assert not left, f"{len(left)} holds and placeholders left to the " \
        f"cyclic collector"


# -- buffer donation ------------------------------------------------------------

def test_donated_chain_keeps_its_storage():
    """An RW chain of NB device tasks on one tile: each step is handed its
    input tile as output storage, so the tile's device storage never
    changes, and the result is the JAX package's."""
    NB = 6
    a = np.arange(16, dtype=np.float32).reshape(4, 4)

    def build(side, ptg, dev):
        A = _matrix(side, 4, 4, 4, a)
        ptrs = []
        if side == "port":
            def step(T, k, *, donate=False):
                ptrs.append(T.data_ptr())
                return torch.add(T, k + 1, out=T if donate else None)
        else:
            def step(T, k):
                return T + (k + 1)
        p = ptg.PTG("chain", NB=NB)
        p.task("Step", k=ptg.Range(0, NB - 1)) \
            .affinity(lambda k, A=A: A(0, 0)) \
            .flow("T", "RW",
                  ptg.IN(ptg.DATA(lambda A=A: A(0, 0)),
                         when=lambda k: k == 0),
                  ptg.IN(ptg.TASK("Step", "T", lambda k: dict(k=k - 1)),
                         when=lambda k: k > 0),
                  ptg.OUT(ptg.TASK("Step", "T", lambda k: dict(k=k + 1)),
                          when=lambda k, NB=NB: k < NB - 1),
                  ptg.OUT(ptg.DATA(lambda A=A: A(0, 0)),
                          when=lambda k, NB=NB: k == NB - 1)) \
            .body(step, device=dev)
        return p.build(), {"A": A}, ptrs

    ref, _, _ = _run("jax", build)
    got, stats, ptrs = _run("port", build)
    np.testing.assert_array_equal(got["A"], ref["A"])
    np.testing.assert_array_equal(got["A"], a + NB * (NB + 1) / 2)
    assert len(ptrs) == NB and len(set(ptrs)) == 1
    assert _total(stats, "donated_tasks") == NB
    assert _total(stats, "donations_refused") == 0


def test_reader_of_the_old_version_refuses_donation():
    """SRC(k) doubles A(k, 0) and hands it to NJ readers RD(k, j), which
    accumulate it into C(k, j), and to one writer WR(k), which triples it
    into B(k, 0) and is enqueued first (higher priority).  The writer's
    copy is a copy-on-write alias of the readers' input: its launch must
    not donate, or a reader enqueued after it would read the tripled
    value.  Every other launch donates.  Results equal the JAX
    package's."""
    KT, NJ, mb = 3, 4, 8
    rng = np.random.default_rng(7)
    a = rng.standard_normal((KT * mb, mb)).astype(np.float32)
    c = rng.standard_normal((KT * mb, NJ * mb)).astype(np.float32)
    b = np.zeros((KT * mb, mb), np.float32)

    def build(side, ptg, dev):
        A = _matrix(side, mb, KT * mb, mb, a, "A")
        B = _matrix(side, mb, KT * mb, mb, b, "B")
        C = _matrix(side, mb, KT * mb, NJ * mb, c, "C")
        if side == "port":
            # device bodies that write their first argument in place when
            # the port donates it
            def src(T, *, donate=False):
                return torch.mul(T, 2, out=T if donate else None)

            def wr(T, *, donate=False):
                return torch.mul(T, 3, out=T if donate else None)

            def rd(X, T, j, *, donate=False):
                return torch.add(X, T * (j + 1), out=X if donate else None)
        else:
            def src(T):
                return 2 * T

            def wr(T):
                return 3 * T

            def rd(X, T, j):
                return X + T * (j + 1)

        g = ptg.PTG("fanout", KT=KT, NJ=NJ)
        g.task("SRC", k=ptg.Range(0, KT - 1)) \
            .affinity(lambda k: A(k, 0)) \
            .flow("T", "RW",
                  ptg.IN(ptg.DATA(lambda k: A(k, 0))),
                  ptg.OUT(ptg.TASK("RD", "T",
                                   lambda k, NJ=NJ: [dict(k=k, j=j)
                                                     for j in range(NJ)])),
                  ptg.OUT(ptg.TASK("WR", "T", lambda k: dict(k=k)))) \
            .body(src, device=dev)
        g.task("WR", k=ptg.Range(0, KT - 1)) \
            .affinity(lambda k: B(k, 0)) \
            .priority(lambda k: 10) \
            .flow("T", "RW",
                  ptg.IN(ptg.TASK("SRC", "T", lambda k: dict(k=k))),
                  ptg.OUT(ptg.DATA(lambda k: B(k, 0)))) \
            .body(wr, device=dev)
        g.task("RD", k=ptg.Range(0, KT - 1), j=ptg.Range(0, NJ - 1)) \
            .affinity(lambda k, j: C(k, j)) \
            .priority(lambda k: 0) \
            .flow("T", "READ",
                  ptg.IN(ptg.TASK("SRC", "T", lambda k: dict(k=k)))) \
            .flow("X", "RW",
                  ptg.IN(ptg.DATA(lambda k, j: C(k, j))),
                  ptg.OUT(ptg.DATA(lambda k, j: C(k, j)))) \
            .body(rd, device=dev)
        return g.build(), {"A": A, "B": B, "C": C}, None

    ref, _, _ = _run("jax", build)
    got, stats, _ = _run("port", build)
    for k in ("A", "B", "C"):
        assert _rel(got[k], ref[k]) < 1e-5, k
    np.testing.assert_allclose(got["B"], 6.0 * a, rtol=1e-6)
    want_c = c + np.concatenate([2.0 * a * (j + 1) for j in range(NJ)], 1)
    np.testing.assert_allclose(got["C"], want_c, rtol=1e-5, atol=1e-5)
    assert _total(stats, "donations_refused") >= 1     # WR's launches
    assert _total(stats, "donated_tasks") == KT * (NJ + 1)


# -- degraded mode --------------------------------------------------------------

def test_degraded_mode_reruns_a_failing_kernel_on_the_cpu_body():
    """``device_max_faults=1``: the first launch failure disables the
    device, and the failing task and everything queued behind it run
    their CPU bodies instead (the reference's HOOK_RETURN_DISABLE); the
    context does not fail, and the result is the JAX package's."""
    NT, mb = 6, 4
    a = np.ones((mb, NT * mb), np.float32)

    def build(side, ptg, dev):
        A = _matrix(side, mb, mb, NT * mb, a)

        def bad_kernel(X):
            raise RuntimeError("injected device fault")
        p = ptg.PTG("faulty", NT=NT)
        tb = p.task("T", k=ptg.Range(0, NT - 1)) \
            .affinity(lambda k, A=A: A(0, k)) \
            .flow("X", "RW",
                  ptg.IN(ptg.DATA(lambda k, A=A: A(0, k))),
                  ptg.OUT(ptg.DATA(lambda k, A=A: A(0, k))))
        tb.body(bad_kernel, device=dev)
        tb.body(lambda X: X + 1.0)          # the CPU incarnation
        return p.build(), {"A": A}, None

    knobs = (("device_max_faults", 1),)
    ref, ref_stats, _ = _run("jax", build, knobs)
    got, stats, _ = _run("port", build, knobs)
    np.testing.assert_array_equal(got["A"], ref["A"])
    np.testing.assert_array_equal(got["A"], 2.0)
    assert _total(stats, "faults") >= 1 and _total(ref_stats, "faults") >= 1
    assert _total(stats, "executed_tasks") == 0


def test_degraded_mode_is_off_by_default():
    """At the default ``device_max_faults=0`` a launch failure fails the
    context, as an unguarded run does."""
    def build(side, ptg, dev):
        A = _matrix(side, 4, 4, 4, np.ones((4, 4), np.float32))

        def bad_kernel(X):
            raise RuntimeError("injected device fault")
        p = ptg.PTG("faulty")
        tb = p.task("T", k=ptg.Range(0, 0)) \
            .flow("X", "RW", ptg.IN(ptg.DATA(lambda A=A: A(0, 0))),
                  ptg.OUT(ptg.DATA(lambda A=A: A(0, 0))))
        tb.body(bad_kernel, device=dev)
        tb.body(lambda X: X + 1.0)
        return p.build(), {"A": A}, None

    assert int(port_params.get("device_max_faults")) == 0
    with pytest.raises(RuntimeError, match="failed"):
        _run("port", build)


# -- concurrency ----------------------------------------------------------------

@pytest.mark.parametrize("app", ["potrf", "qr"])
def test_chains_under_a_tight_runahead_and_fast_thread_switches(app):
    """Held chains are run by whichever thread needs them first — the
    manager's consumer wave, the completer's run-ahead valve (here at one
    unfinished launch, so it blocks on nearly every entry and runs chains
    still held), a host reader — and claimed all-or-nothing.  Eight
    workers and a 10 us interpreter switch interval interleave them; the
    factor must stay exact and every task run once on the device."""
    import sys
    mb, nt = 8, 6
    n = mb * nt
    spd = _spd(n, 31)
    a = np.random.default_rng(32).standard_normal((n, n)).astype(np.float32)
    ntasks = nt * (nt + 1) * (nt + 2) // 6 if app == "potrf" else \
        nt + nt * (nt - 1) + sum((nt - 1 - k) ** 2 for k in range(nt))
    knobs = (("device_inflight_depth", 1), ("device_runahead", 1))
    for knob, value in knobs:
        port_params.set(knob, value)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(3):
            A = _matrix("port", mb, n, n, spd if app == "potrf" else a)
            with port_context.Context(nb_cores=8, device="cpu") as ctx:
                tp = port_potrf.potrf_taskpool(A) if app == "potrf" \
                    else port_qr.qr_taskpool(A)
                ctx.add_taskpool(tp)
                ctx.wait(timeout=60)
                st = ctx.device_registry.accelerators[0].stats
                assert st.chained_launches > 0 and st.faults == 0
                assert st.executed_tasks == ntasks
            out = _as_numpy(A.to_array()).astype(np.float64)
            if app == "potrf":
                L = np.tril(out)
                assert np.abs(L @ L.T - spd).max() / np.abs(spd).max() < 1e-4
            else:
                R = np.triu(out)
                ata = a.astype(np.float64).T @ a
                assert np.abs(np.tril(out, -1)).max() < 1e-4
                assert np.abs(R.T @ R - ata).max() / np.abs(ata).max() < 1e-4
    finally:
        sys.setswitchinterval(old)
        for knob, _ in knobs:
            port_params.unset(knob)
