"""The port's PTG -> DTD bridge against the JAX package's.

Twins of tests/test_ptg_to_dtd.py: the same PTG (built with each
package's front-end, bodies written once for numpy and CPU tensors) is
replayed through each package's ``run_ptg_as_dtd`` into a DTD pool, and
the two runs must agree on the values, the tasks executed per class and
the DTD pool's termdet counters.  The port runs with ``device="cpu"``.
"""

import collections
import threading

import numpy as np
import pytest
import torch

import parsec_tpu.apps.gemm as jax_gemm
import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.dtd as jax_dtd
import parsec_tpu.dsl.dtd.bridge as jax_bridge
import parsec_tpu.dsl.ptg.api as jax_api
import parsec_tpu_torch.apps.gemm as port_gemm
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.dtd as port_dtd
import parsec_tpu_torch.dsl.dtd.bridge as port_bridge
import parsec_tpu_torch.dsl.ptg.api as port_api

SIDES = {
    "jax": (jax_context, jax_matrix, jax_dtd, jax_bridge, jax_api, {}),
    "port": (port_context, port_matrix, port_dtd, port_bridge, port_api,
             {"device": "cpu"}),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def _bridge_run(side, build, timeout=60):
    """Build the PTG with ``side``'s modules, replay it through the
    bridge; return (values, per-class completions, termdet counters)."""
    ctx_mod, mat, dtd, bridge, api, kw = SIDES[side]
    p, values = build(side, mat, api)
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1
    with ctx_mod.Context(nb_cores=2, **kw) as ctx:
        ctx.pins_register("complete_exec", count)
        tp = dtd.DTDTaskpool("bridged")
        ctx.add_taskpool(tp)
        ctx.start()
        bridge.run_ptg_as_dtd(p.build(), tp)
        tp.wait(timeout=timeout)
        ctx.wait(timeout=timeout)
    return values(), dict(done), (tp.nb_tasks, tp.nb_pending_actions)


def _both(build):
    j, p = (_bridge_run(side, build) for side in ("jax", "port"))
    assert p[0].keys() == j[0].keys()
    for k in j[0]:
        np.testing.assert_array_equal(p[0][k], j[0][k], err_msg=k)
    assert p[1] == j[1]                  # executed tasks per class
    assert p[2] == j[2] == (0, 0)        # termdet drained
    return p


def _chain(side, mat, api, NT=10):
    V = mat.VectorTwoDimCyclic(mb=2, lm=2 * NT)
    for m, _ in V.local_tiles():
        V.data_of(m).copy_on(0).payload[:] = 0.0
    p = api.PTG("chain", NT=NT)
    p.task("S", k=api.Range(0, NT - 1)) \
        .affinity(lambda k, V=V: V(k)) \
        .flow("T", "RW",
              api.IN(api.DATA(lambda k, V=V: V(0)), when=lambda k: k == 0),
              api.IN(api.TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              api.OUT(api.TASK("S", "T", lambda k: dict(k=k + 1)),
                      when=lambda k, NT=NT: k < NT - 1),
              api.OUT(api.DATA(lambda k, V=V: V(0)),
                      when=lambda k, NT=NT: k == NT - 1)) \
        .body(lambda T: T + 1.0)
    return p, lambda: {"V0": _np(V.data_of(0).pull_to_host().payload)}


def test_bridge_chain():
    """Ex02-style chain: task-fed RW edges through DTD versioning."""
    got = _both(_chain)
    np.testing.assert_allclose(got[0]["V0"], 10.0)
    assert got[1] == {"ptg2dtd_S": 10}


def _gemm(side, mat, api, n=64, mb=16):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    conv = (lambda x: x) if side == "jax" else torch.from_numpy
    gemm = (jax_gemm if side == "jax" else port_gemm).gemm_taskpool
    A = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n,
                              name="A").from_array(conv(a))
    B = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n,
                              name="B").from_array(conv(b))
    C = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n,
                              name="C").from_array(
                                  conv(np.zeros((n, n), np.float32)))

    class _Built:
        # gemm_taskpool builds a taskpool, not a PTG: hand it over as is
        def build(self):
            return gemm(A, B, C, device="cpu")
    return _Built(), lambda: {"C": _np(C.to_array()), "want": a @ b}


def test_bridge_gemm():
    """Tiled GEMM through the bridge: both packages' DTD engines
    reproduce the PTG's RAW chains and fan-outs (the port's CPU body is
    K1's plain version)."""
    j, p = (_bridge_run(side, _gemm, timeout=120) for side in ("jax",
                                                               "port"))
    np.testing.assert_allclose(p[0]["C"], j[0]["C"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(p[0]["C"], p[0]["want"], rtol=1e-4,
                               atol=1e-4)
    assert p[1] == j[1] and sum(p[1].values()) == 64
    assert p[2] == j[2] == (0, 0)


def _ctl(side, mat, api, NT=4):
    V = mat.VectorTwoDimCyclic(mb=2, lm=2)
    V.data_of(0).copy_on(0).payload[:] = 5.0
    reads = []
    p = api.PTG("ctl", NT=NT)
    p.task("READER", i=api.Range(0, NT - 1)) \
        .affinity(lambda i, V=V: V(0)) \
        .flow("X", "READ", api.IN(api.DATA(lambda i, V=V: V(0)))) \
        .flow("C", "CTL",
              api.OUT(api.TASK("UPD", "C", lambda i: dict()))) \
        .body(lambda X: reads.append(float(np.asarray(X)[0])))
    p.task("UPD") \
        .affinity(lambda V=V: V(0)) \
        .flow("T", "RW",
              api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.DATA(lambda V=V: V(0)))) \
        .flow("C", "CTL",
              *[api.IN(api.TASK("READER", "C", lambda i=i: dict(i=i)))
                for i in range(NT)]) \
        .body(lambda T: T * 100.0)
    return p, lambda: {"reads": np.array(reads),
                       "V0": _np(V.data_of(0).pull_to_host().payload)}


def test_bridge_ctl_ordering():
    """Ex07-style CTL: the update gated behind reads by pure control
    edges keeps its order through synthetic CTL tiles."""
    got = _both(_ctl)
    assert list(got[0]["reads"]) == [5.0] * 4
    np.testing.assert_allclose(got[0]["V0"], 500.0)


def _new_flow(side, mat, api):
    V = mat.VectorTwoDimCyclic(mb=4, lm=4)
    V.data_of(0).copy_on(0).payload[:] = 0.0
    p = api.PTG("newflow")
    p.arena("tmp", (4,))
    p.task("MAKE") \
        .affinity(lambda V=V: V(0)) \
        .flow("W", "WRITE",
              api.IN(api.NEW("tmp")),
              api.OUT(api.TASK("USE", "W", lambda: dict()))) \
        .body(lambda W: W + 3.0)
    p.task("USE") \
        .affinity(lambda V=V: V(0)) \
        .flow("W", "READ", api.IN(api.TASK("MAKE", "W", lambda: dict()))) \
        .flow("T", "RW",
              api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.DATA(lambda V=V: V(0)))) \
        .body(lambda W, T: {"T": T + W})
    return p, lambda: {"V0": _np(V.data_of(0).pull_to_host().payload)}


def test_bridge_new_flow():
    """NEW temporaries become synthetic DTD tiles shaped by the arena."""
    got = _both(_new_flow)
    np.testing.assert_allclose(got[0]["V0"], 3.0)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_bridge_rejects_magic_args(side):
    ctx_mod, mat, dtd, bridge, api, kw = SIDES[side]
    V = mat.VectorTwoDimCyclic(mb=2, lm=2)
    p = api.PTG("magic")
    p.task("T") \
        .affinity(lambda V=V: V(0)) \
        .flow("X", "RW", api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.DATA(lambda V=V: V(0)))) \
        .body(lambda X, task: X)
    with ctx_mod.Context(nb_cores=1, **kw) as ctx:
        tp = dtd.DTDTaskpool("rej")
        ctx.add_taskpool(tp)
        ctx.start()
        with pytest.raises(TypeError, match="magic"):
            bridge.run_ptg_as_dtd(p.build(), tp)
        tp.wait(timeout=30)
