"""The port's recursive device against the JAX package's.

Twins of tests/test_recursive.py (reference: parsec/recursive.h
``parsec_recursivecall``): one tile factored by an inner tiled-Cholesky
pool spawned from the outer task's body, recursion two levels deep, and
an inner failure failing the context.  Both packages run the same DAG on
the same seeded operand; results agree within the reference test's
tolerance, and the CHECK successor sees the committed factor.  Past the
twins: the inner pool on the device module (``device="cpu:1"``, the
CPU-backed module), whose newest inner tiles stay on the device until
``SubtileMatrix.commit`` pulls them into the parent.
"""

import numpy as np
import pytest
import torch

import parsec_tpu.apps.potrf as jax_potrf
import parsec_tpu.core.context as jax_context
import parsec_tpu.core.recursive as jax_recursive
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.data.subtile as jax_subtile
import parsec_tpu.dsl.ptg.api as jax_ptg
import parsec_tpu_torch.apps.potrf as port_potrf
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.core.recursive as port_recursive
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.data.subtile as port_subtile
import parsec_tpu_torch.dsl.ptg.api as port_ptg

PKGS = {
    "jax": (jax_context, jax_recursive, jax_matrix, jax_subtile, jax_ptg,
            jax_potrf, {}),
    "port": (port_context, port_recursive, port_matrix, port_subtile,
             port_ptg, port_potrf, {"device": "cpu"}),
}


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return a @ a.T + n * np.eye(n, dtype=np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _host(pkg, a):
    return a.copy() if pkg == "jax" else torch.from_numpy(a.copy())


def _recursive_potrf(pkg, n, inner_mb, inner_device="cpu", ctx_kw=None):
    """FACT factors A(0, 0) by an inner potrf pool on ``inner_device``;
    CHECK reads the tile after FACT.  Returns (lower A, CHECK's lower
    tile, the port's device-module tasks or None, numpy's factor)."""
    ctx_mod, rec, mat, sub_mod, ptg, potrf, kw = PKGS[pkg]
    a = _spd(n)
    A = mat.TwoDimBlockCyclic(mb=n, nb=n, lm=n, ln=n, name="A") \
        .from_array(_host(pkg, a))
    after = []

    def body(T, es, task):
        sub = sub_mod.SubtileMatrix(task.data["T"].data, mb=inner_mb,
                                    nb=inner_mb)
        inner = potrf.potrf_taskpool(sub, device=inner_device)
        return rec.recursive_call(es, task, inner,
                                  callback=lambda _t: sub.commit())

    p = ptg.PTG("rec")
    p.task("FACT") \
        .affinity(lambda A=A: A(0, 0)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda A=A: A(0, 0))),
              ptg.OUT(ptg.TASK("CHECK", "T", lambda: dict())),
              ptg.OUT(ptg.DATA(lambda A=A: A(0, 0)))) \
        .body(body)
    # a successor proves the outer task's deps release only after the
    # inner pool committed (ordering evidence, not just results)
    p.task("CHECK") \
        .affinity(lambda A=A: A(0, 0)) \
        .flow("T", "READ", ptg.IN(ptg.TASK("FACT", "T", lambda: dict()))) \
        .body(lambda T: after.append(_np(T).copy()))
    with ctx_mod.Context(nb_cores=2, **(ctx_kw or kw)) as ctx:
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=120)
        ran = sum(d.stats.executed_tasks
                  for d in ctx.device_registry.accelerators) \
            if pkg == "port" else None
    got = np.tril(_np(A.to_array()))
    assert len(after) == 1
    return got, np.tril(after[0]), ran, np.linalg.cholesky(a)


def test_recursive_potrf_single_tile():
    """The reference's flagship recursive pattern: one big tile factored
    by an INNER tiled-Cholesky taskpool spawned from the outer task's
    body; the outer task completes when the inner pool does and the
    parent tile sees the committed result."""
    ref = _recursive_potrf("jax", 64, 16)
    got = _recursive_potrf("port", 64, 16)
    expect = got[3]
    for a in (ref[0], ref[1], got[0], got[1]):
        np.testing.assert_allclose(a, expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-4)
    assert got[2] == 0          # CPU bodies: nothing ran on the module


@pytest.mark.parametrize("ctx_device", ["cpu", "cpu:1"])
def test_recursive_potrf_inner_pool_on_the_device_module(ctx_device):
    """The inner pool's 20 tasks (NT=4) run on the device module, whose
    newest inner tiles stay there at the inner pool's end; ``commit``
    pulls them into the parent before the version bump, so CHECK reads
    the factor.  The JAX package's commit bumps the version alone: its
    CHECK would read the unfactored tile under a device inner pool, so
    the twin holds the port to the JAX package's CPU run."""
    ref = _recursive_potrf("jax", 64, 16)
    got = _recursive_potrf("port", 64, 16, inner_device="cuda",
                           ctx_kw={"device": ctx_device})
    assert got[2] == 20
    for a in (got[0], got[1]):
        np.testing.assert_allclose(a, got[3], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a, ref[0], rtol=1e-4, atol=1e-4)


def _nested(pkg):
    ctx_mod, rec, mat, sub_mod, ptg, _potrf, kw = PKGS[pkg]
    N = 16
    V = mat.TwoDimBlockCyclic(mb=N, nb=N, lm=N, ln=N, name="V") \
        .from_array(_host(pkg, np.ones((N, N), np.float32)))
    levels = []

    def leaf_pool(sub):
        q = ptg.PTG("leaf", MT=sub.mt, NT=sub.nt)
        q.task("ADD", m=ptg.Range(0, sub.mt - 1), n=ptg.Range(0, sub.nt - 1)) \
            .affinity(lambda m, n, S=sub: S(m, n)) \
            .flow("X", "RW",
                  ptg.IN(ptg.DATA(lambda m, n, S=sub: S(m, n))),
                  ptg.OUT(ptg.DATA(lambda m, n, S=sub: S(m, n)))) \
            .body(lambda X: X + 1.0)
        return q.build()

    def mid_body(T, es, task):
        sub = sub_mod.SubtileMatrix(task.data["T"].data, mb=N // 2,
                                    nb=N // 2)
        inner = ptg.PTG("mid", MT=sub.mt, NT=sub.nt)

        def inner_body(X, es, task):
            s2 = sub_mod.SubtileMatrix(task.data["X"].data, mb=N // 4,
                                       nb=N // 4, name="s2")
            levels.append((s2.mt, s2.nt))
            return rec.recursive_call(es, task, leaf_pool(s2),
                                      callback=lambda _t: s2.commit())

        inner.task("REC", m=ptg.Range(0, sub.mt - 1),
                   n=ptg.Range(0, sub.nt - 1)) \
            .affinity(lambda m, n, S=sub: S(m, n)) \
            .flow("X", "RW",
                  ptg.IN(ptg.DATA(lambda m, n, S=sub: S(m, n))),
                  ptg.OUT(ptg.DATA(lambda m, n, S=sub: S(m, n)))) \
            .body(inner_body)
        return rec.recursive_call(es, task, inner.build(),
                                  callback=lambda _t: sub.commit())

    p = ptg.PTG("outer")
    p.task("GO") \
        .affinity(lambda V=V: V(0, 0)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda V=V: V(0, 0))),
              ptg.OUT(ptg.DATA(lambda V=V: V(0, 0)))) \
        .body(mid_body)
    with ctx_mod.Context(nb_cores=2, **kw) as ctx:
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=120)
    return _np(V.to_array()), sorted(levels)


def test_recursive_nests_two_levels():
    """Recursion composes: the inner pool's task itself recurses."""
    ref, got = _nested("jax"), _nested("port")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[0], 2.0)
    assert got[1] == ref[1] == [(2, 2)] * 4


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_recursive_inner_failure_fails_outer(pkg):
    """An inner-pool task error must fail the context, not hang it."""
    ctx_mod, rec, mat, _sub, ptg, _potrf, kw = PKGS[pkg]
    V = mat.TwoDimBlockCyclic(mb=8, nb=8, lm=8, ln=8, name="V") \
        .from_array(_host(pkg, np.ones((8, 8), np.float32)))

    def body(T, es, task):
        inner = ptg.PTG("bad")
        inner.task("BOOM") \
            .affinity(lambda V=V: V(0, 0)) \
            .body(lambda: (_ for _ in ()).throw(RuntimeError("inner boom")))
        return rec.recursive_call(es, task, inner.build())

    p = ptg.PTG("outer")
    p.task("GO") \
        .affinity(lambda V=V: V(0, 0)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda V=V: V(0, 0))),
              ptg.OUT(ptg.DATA(lambda V=V: V(0, 0)))) \
        .body(body)
    with ctx_mod.Context(nb_cores=2, **kw) as ctx:
        ctx.add_taskpool(p.build())
        with pytest.raises(RuntimeError, match="BOOM"):
            ctx.wait(timeout=60)
