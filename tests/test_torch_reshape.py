"""The port's reshape engine (data/reshape.py) against the JAX package's:
dtt-driven conversion on dependency edges.

Twins of tests/test_reshape.py (reference: parsec_reshape.c and the
reshape test matrix tests/collections/reshape/): the unit cases on both
packages' ``needs_reshape``/``convert``/``ReshapeCache``, and each PTG
case built the same way through both packages (the port on
``device="cpu"``), holding what the consumers see (dtype by name, values)
and what lands home, and the conversions counted, to the reference
test's expectations and to each other.  The port's bf16 is
``torch.bfloat16`` where the JAX package's is ml_dtypes'.  The remote
pre-send reshape case's twin is
tests/test_torch_comm_distributed.py::test_remote_presend_reshape.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.data as jax_data
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.data.reshape as jax_reshape
import parsec_tpu.dsl.ptg.api as jax_ptg
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.data as port_data
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.data.reshape as port_reshape
import parsec_tpu_torch.dsl.ptg.api as port_ptg

PKGS = {"jax": (jax_context, jax_data, jax_matrix, jax_reshape, jax_ptg, {},
                np.dtype(ml_dtypes.bfloat16), np.float32),
        "port": (port_context, port_data, port_matrix, port_reshape,
                 port_ptg, {"device": "cpu"}, torch.bfloat16,
                 torch.float32)}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


class _P:
    def __init__(self, pkg):
        (ctx_mod, self.data, self.matrix, self.reshape, ptg, self.ctx_kw,
         self.bf16, self.f32) = PKGS[pkg]
        self.port = pkg == "port"
        self.Context = ctx_mod.Context
        self.Dtt = self.reshape.Dtt
        for name in ("DATA", "IN", "NEW", "OUT", "PTG", "Range", "TASK"):
            setattr(self, name, getattr(ptg, name))

    def ctx(self):
        return self.Context(nb_cores=2, **self.ctx_kw)

    def array(self, a):
        """``a`` (numpy f32) as this package's payload."""
        return torch.from_numpy(a.copy()) if self.port else a.copy()

    def cast(self, x, dtype):
        return x.to(dtype) if self.port else np.asarray(x).astype(dtype)


def _name(x):
    """A payload's dtype by name, in either package."""
    return str(x.dtype).replace("torch.", "")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _both(run):
    return run(_P("jax")), run(_P("port"))


@BOTH
def test_needs_reshape_and_convert_unit(pkg):
    P = _P(pkg)
    d = P.data.Data(nb_elts=16)
    c = d.create_copy(0, payload=P.array(np.ones((2, 2), np.float32)),
                      coherency=P.data.Coherency.SHARED, version=1)
    assert not P.reshape.needs_reshape(c, None)
    assert not P.reshape.needs_reshape(c, P.Dtt(dtype=P.f32))
    assert P.reshape.needs_reshape(c, P.Dtt(dtype=P.bf16))
    t = P.Dtt(transform=lambda a: a.T, inverse=lambda a: a.T, name="T")
    assert P.reshape.needs_reshape(c, t)
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(_f32(P.reshape.convert(P.array(a), t)),
                                  a.T)
    np.testing.assert_array_equal(
        _f32(P.reshape.convert(P.array(a), t, inverse=True)), a.T)
    assert _name(P.reshape.convert(P.array(a), P.Dtt(dtype=P.bf16))) == \
        "bfloat16"


@BOTH
def test_shared_promise_converts_once(pkg):
    P = _P(pkg)
    cache = P.reshape.ReshapeCache()
    d = P.data.Data(nb_elts=16)
    c = d.create_copy(0, payload=P.array(np.ones((2, 2), np.float32)),
                      coherency=P.data.Coherency.SHARED, version=1)
    t = P.Dtt(dtype=P.bf16)
    r1 = cache.get_copy(c, t)
    r2 = cache.get_copy(c, t)
    assert r1 is r2 and cache.conversions == 1
    assert _name(r1.payload) == "bfloat16"


def test_task_edge_reshape_f32_to_bf16():
    """f32 collection, bf16 task-fed edges: consumers see bf16 payloads,
    the writeback lands f32 at home (the mixed-precision staging
    edge)."""
    NT, mb = 2, 4
    base = np.arange(1.0, NT * mb + 1, dtype=np.float32)

    def run(P):
        V = P.matrix.VectorTwoDimCyclic(mb=mb, lm=NT * mb).from_array(
            base.copy())
        seen = {}
        p = P.PTG("mix", NT=NT)
        p.task("P", i=P.Range(0, NT - 1)) \
            .flow("X", "READ",
                  P.IN(P.DATA(lambda i, V=V: V(i))),
                  P.OUT(P.TASK("Q", "X", lambda i: dict(i=i)))) \
            .body(lambda: None)

        def q_body(X, i):
            seen[i] = _name(X)
            return P.cast(2.0 * X, P.f32)
        p.task("Q", i=P.Range(0, NT - 1)) \
            .flow("X", "RW",
                  P.IN(P.TASK("P", "X", lambda i: dict(i=i)),
                       dtt=P.Dtt(dtype=P.bf16)),
                  P.OUT(P.DATA(lambda i, V=V: V(i)))) \
            .body(q_body)
        tp = p.build()
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        out = V.to_array()
        return seen, _name(out), _f32(out).tolist(), tp.reshape.conversions
    j, p = _both(run)
    assert j == p
    assert p[0] == {0: "bfloat16", 1: "bfloat16"} and p[1] == "float32"
    np.testing.assert_allclose(p[2], 2.0 * base, rtol=1e-2)  # bf16 rounding
    assert p[3] == NT


def test_desc_read_reshape():
    """IN(DATA(...), dtt=...): a converting read straight from the
    collection (reference: parsec_get_copy_reshape_from_desc); the
    collection itself is never converted."""
    NT, mb = 2, 4
    base = np.arange(1.0, NT * mb + 1, dtype=np.float32)

    def run(P):
        V = P.matrix.VectorTwoDimCyclic(mb=mb, lm=NT * mb).from_array(
            base.copy())
        seen = {}

        def body(X, i):
            seen[i] = _name(X)
        p = P.PTG("dread", NT=NT)
        p.task("R", i=P.Range(0, NT - 1)) \
            .flow("X", "READ",
                  P.IN(P.DATA(lambda i, V=V: V(i)), dtt=P.Dtt(dtype=P.bf16))) \
            .body(body)
        with P.ctx() as ctx:
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=30)
        return seen, _name(V.to_array())
    j, p = _both(run)
    assert j == p == ({0: "bfloat16", 1: "bfloat16"}, "float32")


def test_writeback_inverse_transform():
    """OUT(DATA(...), dtt with transform): the edge layout is undone on
    the way home (reference: reverse reshape on writeback)."""
    base = np.arange(12, dtype=np.float32).reshape(4, 3)

    def run(P):
        M = P.matrix.TwoDimBlockCyclic(mb=4, nb=3, lm=4, ln=3).from_array(
            base.copy())
        tr = P.Dtt(transform=lambda a: a.T, inverse=lambda a: a.T, name="T")
        p = P.PTG("tposed")
        # P produces the tile in TRANSPOSED edge layout; the dtt's inverse
        # restores home layout on writeback
        p.task("P") \
            .flow("X", "RW",
                  P.IN(P.DATA(lambda M=M: M(0, 0))),
                  P.OUT(P.DATA(lambda M=M: M(0, 0)), dtt=tr)) \
            .body(lambda X: (2.0 * X).T)
        with P.ctx() as ctx:
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=30)
        return _f32(M.to_array())
    j, p = _both(run)
    np.testing.assert_array_equal(j, p)
    np.testing.assert_allclose(p, 2.0 * base, rtol=1e-6)


def test_fanout_shared_reshape_single_conversion():
    """Two readers demanding the same dtt share ONE converted copy (the
    datacopy-future promise semantics)."""
    mb = 4

    def run(P):
        V = P.matrix.VectorTwoDimCyclic(mb=mb, lm=mb).from_array(
            np.arange(1.0, mb + 1, dtype=np.float32))
        seen = []
        p = P.PTG("share")
        p.task("P") \
            .flow("X", "READ",
                  P.IN(P.DATA(lambda V=V: V(0))),
                  P.OUT(P.TASK("R1", "X", lambda: dict())),
                  P.OUT(P.TASK("R2", "X", lambda: dict()))) \
            .body(lambda: None)
        for rn in ("R1", "R2"):
            p.task(rn) \
                .flow("X", "READ",
                      P.IN(P.TASK("P", "X", lambda: dict()),
                           dtt=P.Dtt(dtype=P.bf16))) \
                .body(lambda X: seen.append(_name(X)))
        tp = p.build()
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return seen, tp.reshape.conversions
    j, p = _both(run)
    assert j == p == (["bfloat16", "bfloat16"], 1)


def test_out_dtt_dtype_only_lands_in_collection():
    """A dtype-only OUT dtt: the body's bf16 result is cast home to the
    f32 collection (reference: the writeback reshape paths of
    parsec_reshape.c)."""
    def run(P):
        V = P.matrix.VectorTwoDimCyclic(mb=4, lm=4)
        V.data_of(0).copy_on(0).payload[:] = 2.0
        p = P.PTG("outdtt")
        p.task("T") \
            .affinity(lambda V=V: V(0)) \
            .flow("X", "RW",
                  P.IN(P.DATA(lambda V=V: V(0))),
                  P.OUT(P.DATA(lambda V=V: V(0)), dtt=P.Dtt(dtype=P.bf16))) \
            .body(lambda X: P.cast(X * 3.0, P.bf16))
        with P.ctx() as ctx:
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=60)
        got = V.data_of(0).pull_to_host().payload
        return _name(got), _f32(got).tolist()
    j, p = _both(run)
    assert j == p == ("float32", [6.0] * 4)


def test_edge_both_sides_dtt_consumer_wins():
    """Producer OUT dtt AND consumer IN dtt on ONE edge: the consumer's IN
    dtt governs what it is handed (reference: receiver-side datatype
    resolution, remote_dep_get_datatypes)."""
    mb = 4

    def run(P):
        V = P.matrix.VectorTwoDimCyclic(mb=mb, lm=mb).from_array(
            np.arange(1.0, mb + 1, dtype=np.float32))
        seen = {}
        p = P.PTG("both")
        p.task("P") \
            .flow("X", "READ",
                  P.IN(P.DATA(lambda V=V: V(0))),
                  P.OUT(P.TASK("Q", "X", lambda: dict()),
                        dtt=P.Dtt(dtype=P.bf16))) \
            .body(lambda: None)
        p.task("Q") \
            .flow("X", "READ",
                  P.IN(P.TASK("P", "X", lambda: dict()),
                       dtt=P.Dtt(transform=lambda a: a * 2.0,
                                 inverse=lambda a: a / 2.0, name="x2"))) \
            .body(lambda X: seen.update(dtype=_name(X), val=float(X[0])))
        tp = p.build()
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return seen, tp.reshape.conversions
    j, p = _both(run)
    # the consumer saw ITS dtt's form (transform applied to the f32
    # source), not the producer's bf16 edge type
    assert j == p == ({"dtype": "float32", "val": 2.0}, 1)


def test_avoidable_reshape_ships_zero_conversions():
    """Reference corpus avoidable_reshape.jdf: an edge dtt that already
    matches the payload's type is a no-op — zero conversions."""
    mb = 4

    def run(P):
        V = P.matrix.VectorTwoDimCyclic(mb=mb, lm=mb).from_array(
            np.arange(1.0, mb + 1, dtype=np.float32))
        f32 = P.Dtt(dtype=P.f32)
        seen = {}
        p = P.PTG("avoid")
        p.task("P") \
            .flow("X", "READ",
                  P.IN(P.DATA(lambda V=V: V(0)), dtt=f32),
                  P.OUT(P.TASK("C", "X", lambda: dict()), dtt=f32)) \
            .body(lambda: None)
        p.task("C") \
            .flow("X", "READ",
                  P.IN(P.TASK("P", "X", lambda: dict()), dtt=f32)) \
            .body(lambda X: seen.update(dtype=_name(X), val=float(X[0])))
        tp = p.build()
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return seen, tp.reshape.conversions
    j, p = _both(run)
    assert j == p == ({"dtype": "float32", "val": 1.0}, 0)


def test_local_new_flow_edge_reshape():
    """A NEW-flow arena temporary rides a dtt edge to its consumer (the
    reference's reshape-into-NEW case, locally)."""
    def run(P):
        p = P.PTG("newr")
        p.arena("scratch", (4,), P.f32)
        out = {}

        def produce(X):
            X[:] = P.array(np.arange(4, dtype=np.float32) + 1.0)

        def consume(X):
            out.update(dtype=_name(X), vals=_f32(X).tolist())
        p.task("P") \
            .flow("X", "RW",
                  P.IN(P.NEW("scratch")),
                  P.OUT(P.TASK("C", "X", lambda: dict()))) \
            .body(produce)
        p.task("C") \
            .flow("X", "READ",
                  P.IN(P.TASK("P", "X", lambda: dict()),
                       dtt=P.Dtt(dtype=P.bf16))) \
            .body(consume)
        with P.ctx() as ctx:
            ctx.add_taskpool(p.build())
            ctx.wait(timeout=30)
        return out
    j, p = _both(run)
    assert j == p == {"dtype": "bfloat16", "vals": [1.0, 2.0, 3.0, 4.0]}
