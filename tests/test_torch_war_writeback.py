"""The port's versioned-snapshot writeback against the JAX package's:
same-wavefront read + ``-> DATA`` writeback of the same collection tile.

Twins of tests/test_war_writeback.py (the stencil Gauss–Seidel
contamination regression; reference: repo refcounts + versioned copies,
datarepo.h:50-58, parsec.c:1783).  A producer fans one tile out to a READ
consumer and a WRITE consumer whose ``-> A(i)`` writeback is ordered
before the reader stages its input; the reader must see the
pre-writeback value, and the writeback must land home.  Each case runs
the same pool through both packages: the device case on the JAX
package's device module against the port's CPU-backed device modules
(``device="cpu:2"``, device bodies ``cuda``), the CPU case with CPU
bodies on both.
"""

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg.api as jax_ptg
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg.api as port_ptg

PKGS = {"jax": (jax_context, jax_matrix, jax_ptg, "tpu"),
        "port": (port_context, port_matrix, port_ptg, "cuda")}
DEVICE = pytest.mark.parametrize("device", ["accel", "cpu"])


def _ctx(pkg, device, nb_cores):
    ctx_mod = PKGS[pkg][0]
    if pkg == "jax":
        return ctx_mod.Context(nb_cores=nb_cores)
    return ctx_mod.Context(nb_cores=nb_cores,
                           device="cpu:2" if device == "accel" else "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _war_pool(pkg, V, seen, device):
    _c, _m, ptg, accel = PKGS[pkg]
    NT = V.mt
    p = ptg.PTG("war", NT=NT)
    # P(i) reads the tile once and fans it out to one reader + one writer
    p.task("P", i=ptg.Range(0, NT - 1)) \
        .flow("X", "READ",
              ptg.IN(ptg.DATA(lambda i, V=V: V(i))),
              ptg.OUT(ptg.TASK("R", "X", lambda i: dict(i=i))),
              ptg.OUT(ptg.TASK("W", "X", lambda i: dict(i=i)))) \
        .body(lambda: None)
    # W(i) negates and writes back home; its CTL output orders R after it
    wb = p.task("W", i=ptg.Range(0, NT - 1)) \
        .flow("X", "RW",
              ptg.IN(ptg.TASK("P", "X", lambda i: dict(i=i))),
              ptg.OUT(ptg.DATA(lambda i, V=V: V(i)))) \
        .flow("c", "CTL",
              ptg.OUT(ptg.TASK("R", "c", lambda i: dict(i=i))))
    if device == "accel":
        wb.body(lambda X: -X, device=accel)
    wb.body(lambda X: -X if pkg == "port" else -np.asarray(X))

    # R(i) runs strictly after W(i)'s writeback yet must see P's value
    def record(X, i):
        seen[i] = float(_f32(X)[0])
    p.task("R", i=ptg.Range(0, NT - 1)) \
        .flow("X", "READ", ptg.IN(ptg.TASK("P", "X", lambda i: dict(i=i)))) \
        .flow("c", "CTL", ptg.IN(ptg.TASK("W", "c", lambda i: dict(i=i)))) \
        .body(record)
    return p.build()


@DEVICE
def test_reader_sees_prewriteback_snapshot(device):
    NT, mb = 3, 4
    base = np.arange(1.0, NT * mb + 1, dtype=np.float32)
    out = {}
    for pkg in PKGS:
        V = PKGS[pkg][1].VectorTwoDimCyclic(mb=mb, lm=NT * mb).from_array(
            base.copy())
        seen = {}
        with _ctx(pkg, device, 4) as ctx:
            ctx.add_taskpool(_war_pool(pkg, V, seen, device))
            ctx.wait(timeout=30)
        out[pkg] = (seen, _f32(V.to_array()).tolist())
    # readers saw the pre-writeback value of their tile, and the
    # writeback landed in the user-visible array
    assert out["jax"] == out["port"]
    assert out["port"][0] == {i: float(base[i * mb]) for i in range(NT)}
    np.testing.assert_allclose(out["port"][1], -base, rtol=1e-6)


@DEVICE
def test_detached_snapshot_writeback_not_lost(device):
    """A writer bound to A(i) via FromDesc whose host copy an earlier
    writeback detached still lands its own ``-> A(i)`` update."""
    NT, mb = 2, 4
    base = np.arange(1.0, NT * mb + 1, dtype=np.float32)
    out = {}
    for pkg in PKGS:
        _c, matrix, ptg, accel = PKGS[pkg]
        V = matrix.VectorTwoDimCyclic(mb=mb, lm=NT * mb).from_array(
            base.copy())
        p = ptg.PTG("waw", NT=NT)
        # W1(i): negate the tile, write home, then unleash W2
        w1 = p.task("W1", i=ptg.Range(0, NT - 1)) \
            .flow("X", "RW",
                  ptg.IN(ptg.DATA(lambda i, V=V: V(i))),
                  ptg.OUT(ptg.DATA(lambda i, V=V: V(i)))) \
            .flow("c", "CTL", ptg.OUT(ptg.TASK("W2", "c",
                                               lambda i: dict(i=i))))
        # W2(i): reads A(i) via FromDesc, multiplies by 10, writes home;
        # CTL orders it after W1, so the final value is -10x
        w2 = p.task("W2", i=ptg.Range(0, NT - 1)) \
            .flow("X", "RW",
                  ptg.IN(ptg.DATA(lambda i, V=V: V(i))),
                  ptg.OUT(ptg.DATA(lambda i, V=V: V(i)))) \
            .flow("c", "CTL", ptg.IN(ptg.TASK("W1", "c",
                                              lambda i: dict(i=i))))
        if device == "accel":
            w1.body(lambda X: -X, device=accel)
            w2.body(lambda X: 10.0 * X, device=accel)
        w1.body(lambda X: -X if pkg == "port" else -np.asarray(X))
        w2.body(lambda X: 10.0 * (X if pkg == "port" else np.asarray(X)))
        with _ctx(pkg, device, 2) as ctx:
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=30)
        out[pkg] = _f32(V.to_array()).tolist()
    assert out["jax"] == out["port"]
    np.testing.assert_allclose(out["port"], -10.0 * base, rtol=1e-6)


@DEVICE
def test_backing_array_reflects_writeback_after_wait(device):
    """The replace-not-mutate writeback leaves the user's original array
    updated once the pool quiesces (Ex07 contract)."""
    NT, mb = 2, 4
    base = np.arange(1.0, NT * mb + 1, dtype=np.float32)
    for pkg in PKGS:
        a = base.copy()
        V = PKGS[pkg][1].VectorTwoDimCyclic(mb=mb, lm=NT * mb).from_array(a)
        with _ctx(pkg, device, 2) as ctx:
            ctx.add_taskpool(_war_pool(pkg, V, {}, device))
            ctx.wait(timeout=30)
        # reading through the collection AND through the user's own array
        np.testing.assert_allclose(_f32(V.to_array()), -base, rtol=1e-6)
        np.testing.assert_allclose(a, -base, rtol=1e-6)
