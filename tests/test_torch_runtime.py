"""The port's runtime core against the JAX package's, on the same PTG DAGs.

Each DAG is built by one function from either package's PTG front-end and
collections, with CPU bodies written once for both (numpy on the JAX
side, CPU tensors on the port's).  The two runs must agree on the results,
on the number of executed tasks (per task class, as the ``complete_exec``
instrumentation point counts them, and per worker stream), and on the
termdet's final counters.  The port runs with ``device="cpu"``.
"""

import collections
import threading

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg as jax_ptg
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg as port_ptg
from parsec_tpu_torch.utils.mca import params as port_params

SIDES = {
    "jax": (jax_context, jax_matrix, jax_ptg, {}),
    "port": (port_context, port_matrix, port_ptg, {"device": "cpu"}),
}


def _matrix(side, mod, lm, ln, mb, name, arr):
    m = mod.TwoDimBlockCyclic(mb, mb, lm, ln, name=name)
    return m.from_array(arr.copy() if side == "jax"
                        else torch.from_numpy(arr.copy()))


def _as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(side, build):
    """Build and run one DAG on one package; return (collections as
    numpy, per-class completions, tasks done per the streams, termdet
    counters)."""
    ctx_mod, mat_mod, ptg, kw = SIDES[side]
    g, mats, extra = build(side, mat_mod, ptg)
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1

    with ctx_mod.Context(nb_cores=2, **kw) as ctx:
        ctx.pins_register("complete_exec", count)
        tp = g.build()
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        streams = sum(es.nb_tasks_done for es in ctx.streams)
    arrays = {k: _as_numpy(m.to_array()) for k, m in mats.items()}
    return arrays, dict(done), streams, (tp.nb_tasks,
                                         tp.nb_pending_actions), extra


def _rw_chain(side, mat_mod, ptg):
    """NB tasks pass one 4x4 tile along an RW chain, each adding k+1."""
    NB = 6
    a = np.arange(16, dtype=np.float32).reshape(4, 4)
    A = _matrix(side, mat_mod, 4, 4, 4, "A", a)
    g = ptg.PTG("chain", NB=NB)
    g.task("Step", k=ptg.Range(0, NB - 1)) \
        .affinity(lambda k: A(0, 0)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda k: A(0, 0)), when=lambda k: k == 0),
              ptg.IN(ptg.TASK("Step", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              ptg.OUT(ptg.TASK("Step", "T", lambda k: dict(k=k + 1)),
                      when=lambda k, NB=NB: k < NB - 1),
              ptg.OUT(ptg.DATA(lambda k: A(0, 0)),
                      when=lambda k, NB=NB: k == NB - 1)) \
        .body(lambda T, k: T + (k + 1))
    return g, {"A": A}, None


def _fan_out(side, mat_mod, ptg):
    """Each SRC(k) doubles A(k, 0) and broadcasts it READ-only to NJ
    readers, which accumulate it into their own C(k, j) tiles."""
    KT, NJ, mb = 3, 4, 8
    rng = np.random.default_rng(7)
    a = rng.standard_normal((KT * mb, mb)).astype(np.float32)
    c = rng.standard_normal((KT * mb, NJ * mb)).astype(np.float32)
    A = _matrix(side, mat_mod, KT * mb, mb, mb, "A", a)
    C = _matrix(side, mat_mod, KT * mb, NJ * mb, mb, "C", c)
    g = ptg.PTG("fanout", KT=KT, NJ=NJ)
    g.task("SRC", k=ptg.Range(0, KT - 1)) \
        .affinity(lambda k: A(k, 0)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda k: A(k, 0))),
              ptg.OUT(ptg.TASK("RD", "T",
                               lambda k, NJ=NJ: [dict(k=k, j=j)
                                                 for j in range(NJ)]))) \
        .body(lambda T: 2 * T)
    g.task("RD", k=ptg.Range(0, KT - 1), j=ptg.Range(0, NJ - 1)) \
        .affinity(lambda k, j: C(k, j)) \
        .flow("T", "READ",
              ptg.IN(ptg.TASK("SRC", "T", lambda k: dict(k=k)))) \
        .flow("X", "RW",
              ptg.IN(ptg.DATA(lambda k, j: C(k, j))),
              ptg.OUT(ptg.DATA(lambda k, j: C(k, j)))) \
        .body(lambda T, X, j: X + T * (j + 1))
    return g, {"A": A, "C": C}, None


def _ctl_only(side, mat_mod, ptg):
    """NF independent First tasks gather through CTL edges into one Last
    task, which must run after every First."""
    NF = 5
    order = []
    g = ptg.PTG("ctl", NF=NF)
    g.task("First", i=ptg.Range(0, NF - 1)) \
        .flow("X", "CTL",
              ptg.OUT(ptg.TASK("Last", "X", lambda i: dict(z=0)))) \
        .body(lambda i: order.append(("first", i)))
    g.task("Last", z=ptg.Range(0, 0)) \
        .flow("X", "CTL",
              ptg.IN(ptg.TASK("First", "X",
                              lambda z, NF=NF: [dict(i=i)
                                                for i in range(NF)]))) \
        .body(lambda: order.append(("last", 0)))
    return g, {}, order


@pytest.mark.parametrize("build", [_rw_chain, _fan_out, _ctl_only],
                         ids=["rw_chain", "fan_out", "ctl_only"])
def test_same_dag_same_results(build):
    ref = _run("jax", build)
    got = _run("port", build)
    assert got[0].keys() == ref[0].keys()
    for name in ref[0]:
        # the same f32 operations in the same order: equal results
        np.testing.assert_array_equal(got[0][name], ref[0][name])
    assert got[1] == ref[1]                       # completions per class
    assert got[2] == ref[2] == sum(ref[1].values())
    assert got[3] == ref[3] == (0, 0)             # termdet drained
    if build is _ctl_only:
        for order in (ref[4], got[4]):
            assert order[-1] == ("last", 0) and len(order) == 6


def test_context_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_context.Context(nb_cores=1)


def test_device_cpu_param_attaches_the_cpu_backed_module():
    port_params.set("device", "cpu")
    try:
        with port_context.Context(nb_cores=1) as ctx:
            (dev,) = ctx.device_registry.accelerators
            assert dev.kind == "cuda" and dev.tdev.type == "cpu"
    finally:
        port_params.unset("device")


@pytest.mark.parametrize("knob", ["device_dispatchers"])
def test_unported_plane_knob_raises(knob):
    # device_dispatchers: one manager thread per device by design, so any
    # count but 1 stays unported
    port_params.set(knob, 2)
    try:
        with pytest.raises(NotImplementedError, match="not ported"):
            port_context.Context(nb_cores=1, device="cpu")
    finally:
        port_params.unset(knob)


@pytest.mark.parametrize("value", [1, 0])
def test_ici_knob_is_registered_and_read(value):
    """``comm_ici_enabled`` is registered at the JAX package's default (1)
    and no longer refused: set, a Context over two or more modules
    attaches the ICI engine; at 0 it attaches none."""
    from parsec_tpu.utils.mca import params as jax_params
    import parsec_tpu.comm.ici  # noqa: F401  (registers the knob)
    import parsec_tpu_torch.comm.ici  # noqa: F401
    assert port_params._params["comm_ici_enabled"].default == \
        jax_params._params["comm_ici_enabled"].default == 1
    port_params.set("comm_ici_enabled", value)
    try:
        with port_context.Context(nb_cores=1, device="cpu:2") as ctx:
            assert (ctx.ici is not None) == bool(value)
            if value:
                assert ctx.ici.ndev == 2
    finally:
        port_params.unset("comm_ici_enabled")


@pytest.mark.parametrize("knob", ["comm_epoch", "recovery_rejoin",
                                  "recovery_dtd_skip"])
def test_recovery_knob_is_registered_and_read(knob):
    """The knobs of the elastic rejoin and the DTD skip agreement are
    registered at the JAX package's defaults, and a set value reaches
    its reader: the comm engine's incarnation epoch, the transport's
    rejoin gate, the recovery plane's skip switch."""
    from parsec_tpu.utils.mca import params as jax_params
    import parsec_tpu.comm.engine  # noqa: F401  (registers comm_epoch)
    import parsec_tpu.core.recovery  # noqa: F401
    import parsec_tpu_torch.comm.engine as port_engine
    import parsec_tpu_torch.core.recovery  # noqa: F401
    assert port_params._params[knob].default == \
        jax_params._params[knob].default
    value = {"comm_epoch": 3, "recovery_rejoin": 0,
             "recovery_dtd_skip": 0}[knob]
    assert value != port_params._params[knob].default
    port_params.set(knob, value)
    port_params.set("recovery_enable", 1)
    try:
        with port_context.Context(nb_cores=1, device="cpu") as ctx:
            if knob == "comm_epoch":
                assert port_engine.CommEngine(0, 1).epoch == 3
            elif knob == "recovery_rejoin":
                import types
                ce = types.SimpleNamespace(rejoin_allowed=False,
                                           on_rejoin=None, on_recover=None)
                ctx.recovery.attach_comm(types.SimpleNamespace(ce=ce))
                assert ce.rejoin_allowed is False and ce.on_rejoin is None
            else:
                assert ctx.recovery.dtd_skip_on is False
    finally:
        port_params.unset(knob)
        port_params.unset("recovery_enable")


@pytest.mark.parametrize("knob", ["journal_enabled", "metrics_enabled"])
@pytest.mark.parametrize("value", [1, 0])
def test_ported_plane_knob_installs_or_leaves_none(knob, value):
    """The control-plane journal and the metrics registry are ported and
    on by default: at 1 the knob installs its plane; at 0 it leaves
    ``ctx.journal`` / ``ctx.metrics`` None, and (metrics) registers no
    PINS callback and stamps no ready time."""
    from parsec_tpu_torch.prof.journal import Journal
    from parsec_tpu_torch.prof.metrics import RuntimeMetrics
    port_params.set(knob, value)
    try:
        with port_context.Context(nb_cores=1, device="cpu") as ctx:
            plane = ctx.journal if knob == "journal_enabled" \
                else ctx.metrics
            cbs = {ev: list(v) for ev, v in ctx._pins.items() if v}
            stamp = ctx._ready_stamp
    finally:
        port_params.unset(knob)
    if value:
        assert isinstance(plane, Journal if knob == "journal_enabled"
                          else RuntimeMetrics)
    else:
        assert plane is None
    if knob == "metrics_enabled":
        # the registry is the one default PINS subscriber
        assert bool(cbs) == bool(value)
        assert stamp == bool(value)
        if value:
            assert set(cbs) == {"complete_exec", "task_discard",
                                "job_done"}
    else:
        assert "complete_exec" in cbs   # the metrics registry, still on


_RECLAIM = """
import gc, weakref, torch
from parsec_tpu_torch.apps.gemm import gemm_taskpool
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

def run():
    with Context(nb_cores=2, device="cpu") as ctx:
        dev = ctx.device_registry.accelerators[0]
        mats = [TwoDimBlockCyclic(8, 8, 16, 16, name=n) for n in "ABC"]
        for M in mats:
            for (m, n) in M.local_tiles():
                M.place_on_device(m, n, dev, torch.ones(8, 8))
        ctx.add_taskpool(gemm_taskpool(*mats))
        ctx.wait(timeout=60)
        return [weakref.ref(x) for x in (ctx, dev, *mats)]

refs = run() + run()
gc.collect()
alive = [r() for r in refs if r() is not None]
assert not alive, alive
"""


@pytest.mark.parametrize("process", ["fresh", "this"])
def test_an_ended_context_and_its_tiles_are_reclaimed(process):
    """Once a Context has ended and nothing of the caller holds it, the
    cyclic collector frees it with its device module, its taskpools and
    their matrices (tiles born on the device included).  "fresh": the
    first Context of a process, made when the import graph is frozen out
    of the collector; both cases: the finalizers of device copies, which
    sit in a process-wide registry."""
    if process == "this":
        exec(compile(_RECLAIM, "<reclaim>", "exec"), {})
        return
    import subprocess
    import sys
    subprocess.run([sys.executable, "-c", _RECLAIM], check=True,
                   timeout=240)
