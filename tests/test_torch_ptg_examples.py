"""The reference examples Ex00-Ex07 on the port's PTG front-end against
the JAX package's.

Twins of tests/test_ptg_examples.py (reference: examples/Ex00_StartStop.c
.. Ex07_RAW_CTL.jdf): each case builds the same PTG through both
packages' front-ends (the port on ``device="cpu"``), runs it, and holds
what each observes — order, values written home, placement — to the
reference test's expectations and to each other.
"""

import threading

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.data.operators as jax_operators
import parsec_tpu.dsl.ptg as jax_ptg
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.data.operators as port_operators
import parsec_tpu_torch.dsl.ptg as port_ptg

PKGS = {"jax": (jax_context, jax_matrix, jax_operators, jax_ptg, {}),
        "port": (port_context, port_matrix, port_operators, port_ptg,
                 {"device": "cpu"})}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


class _P:
    def __init__(self, pkg):
        ctx_mod, self.matrix, self.operators, self.ptg, kw = PKGS[pkg]
        self.Context, self.ctx_kw = ctx_mod.Context, kw
        self.TwoDimBlockCyclic = self.matrix.TwoDimBlockCyclic
        self.VectorTwoDimCyclic = self.matrix.VectorTwoDimCyclic
        for name in ("DATA", "IN", "OUT", "PTG", "Range", "TASK"):
            setattr(self, name, getattr(self.ptg, name))

    def ctx(self, **kw):
        kw.setdefault("nb_cores", 2)
        return self.Context(**kw, **self.ctx_kw)


def _both(run):
    return run(_P("jax")), run(_P("port"))


def _fill(a, value):
    if isinstance(a, torch.Tensor):
        a.fill_(value)
    else:
        a.fill(value)


def _home(V, n):
    """The tiles' values written home, as floats."""
    return [float(V.data_of(i).copy_on(0).payload[0]) for i in range(n)]


def test_ex00_start_stop():
    """Ex00_StartStop.c: init / start / wait / fini cycles, no tasks."""
    def run(P):
        out = []
        for _ in range(3):
            with P.ctx() as ctx:
                ctx.start()
                out.append(bool(ctx.test()))
        return out
    assert _both(run) == ([True] * 3, [True] * 3)


def test_ex01_hello_world():
    """Ex01_HelloWorld.jdf: one task, no data."""
    def run(P):
        said = []
        g = P.PTG("hello")
        g.task("HelloWorld").flow("X", "CTL").body(lambda: said.append("hi"))
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return said
    assert _both(run) == (["hi"], ["hi"])


def test_ex02_chain():
    """Ex02_Chain.jdf: NB tasks ordered by a CTL-less RW chain on one
    tile."""
    NB = 8

    def run(P):
        A = P.VectorTwoDimCyclic(1, 1).from_array(np.zeros(1, np.float32))
        order = []
        g = P.PTG("chain", NB=NB)
        g.task("Task", k=P.Range(0, NB - 1)) \
         .affinity(lambda k: A(0)) \
         .flow("T", "RW",
               P.IN(P.DATA(lambda k: A(0)), when=lambda k: k == 0),
               P.IN(P.TASK("Task", "T", lambda k: dict(k=k - 1)),
                    when=lambda k: k > 0),
               P.OUT(P.TASK("Task", "T", lambda k: dict(k=k + 1)),
                     when=lambda k, NB=NB: k < NB - 1)) \
         .body(lambda k: order.append(k))
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return order
    assert _both(run) == (list(range(NB)), list(range(NB)))


def test_ex03_chain_distributed_placement():
    """Ex03_ChainMPI.jdf: owner-computes placement — the rank-0 context
    executes exactly the rank-0 chain of two per-rank chains."""
    def run(P):
        ran = []
        V = P.VectorTwoDimCyclic(1, 2, nodes=2, myrank=0)
        g = P.PTG("chainmpi", NB=4)
        g.task("Task", r=P.Range(0, 1), k=P.Range(0, 3)) \
         .affinity(lambda r: V(r)) \
         .flow("T", "RW",
               P.IN(P.DATA(lambda r: V(r)), when=lambda k: k == 0),
               P.IN(P.TASK("Task", "T", lambda r, k: dict(r=r, k=k - 1)),
                    when=lambda k: k > 0),
               P.OUT(P.TASK("Task", "T", lambda r, k: dict(r=r, k=k + 1)),
                     when=lambda k: k < 3)) \
         .body(lambda r, k: ran.append((r, k)))
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return ran
    j, p = _both(run)
    assert j == p == [(0, k) for k in range(4)]


def test_ex04_chain_data():
    """Ex04_ChainData.jdf: a value flows down the chain and back home."""
    NB = 6

    def run(P):
        V = P.VectorTwoDimCyclic(1, 1).from_array(np.zeros(1, np.float32))
        g = P.PTG("chaindata", NB=NB)
        g.task("Task", k=P.Range(0, NB - 1)) \
         .affinity(lambda k: V(0)) \
         .flow("T", "RW",
               P.IN(P.DATA(lambda k: V(0)), when=lambda k: k == 0),
               P.IN(P.TASK("Task", "T", lambda k: dict(k=k - 1)),
                    when=lambda k: k > 0),
               P.OUT(P.TASK("Task", "T", lambda k: dict(k=k + 1)),
                     when=lambda k, NB=NB: k < NB - 1),
               P.OUT(P.DATA(lambda k: V(0)),
                     when=lambda k, NB=NB: k == NB - 1)) \
         .body(lambda T, k: T.__iadd__(k))
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return _home(V, 1)
    assert _both(run) == ([float(sum(range(NB)))],) * 2


def test_ex05_broadcast_range_dep():
    """Ex05_Broadcast.jdf: one task broadcasts to a range of receivers
    through a single range dep (-> A TaskRecv(1 .. WORLD-1))."""
    WORLD = 7

    def run(P):
        V = P.VectorTwoDimCyclic(1, 1).from_array(
            np.full(1, 3.0, np.float32))
        got = []
        lock = threading.Lock()

        def recv(A, k):
            with lock:
                got.append((k, float(A[0])))

        g = P.PTG("bcast", WORLD=WORLD)
        g.task("TaskBcast") \
         .affinity(lambda: V(0)) \
         .flow("A", "RW",
               P.IN(P.DATA(lambda: V(0))),
               P.OUT(P.TASK("TaskRecv", "A",
                            lambda WORLD=WORLD: [dict(k=k)
                                                 for k in range(1, WORLD)]))) \
         .body(lambda A: A.__imul__(2))
        g.task("TaskRecv", k=P.Range(1, WORLD - 1)) \
         .affinity(lambda k: V(0)) \
         .flow("A", "READ", P.IN(P.TASK("TaskBcast", "A",
                                        lambda k: dict()))) \
         .body(recv)
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return sorted(got)
    j, p = _both(run)
    assert j == p == [(k, 6.0) for k in range(1, WORLD)]


def _raw_pools(P, with_ctl: bool, NB: int = 6):
    """Ex06_RAW / Ex07_RAW_CTL: TaskBcast(k) sends A to NB/2+1 TaskRecv
    readers and one TaskUpdate writer; without CTL the update may race
    the readers, with CTL it is ordered after all of them."""
    events = []
    lock = threading.Lock()
    K = 2
    V = P.VectorTwoDimCyclic(1, K).from_array(np.zeros(K, np.float32))
    recv_range = list(range(0, NB + 1, 2))

    g = P.PTG("raw_ctl" if with_ctl else "raw", NB=NB, K=K)
    g.task("TaskBcast", k=P.Range(0, K - 1)) \
     .affinity(lambda k: V(k)) \
     .flow("A", "RW",
           P.IN(P.DATA(lambda k: V(k))),
           P.OUT(P.TASK("TaskUpdate", "A", lambda k: dict(k=k))),
           P.OUT(P.TASK("TaskRecv", "A",
                        lambda k: [dict(k=k, n=n) for n in recv_range]))) \
     .body(lambda A, k: _fill(A, k + 1))

    def recv_body(A, k, n):
        with lock:
            events.append(("recv", k, n, float(A[0])))

    g.task("TaskRecv", k=P.Range(0, K - 1), n=P.Range(0, NB, 2)) \
     .affinity(lambda k: V(k)) \
     .flow("A", "READ", P.IN(P.TASK("TaskBcast", "A", lambda k: dict(k=k)))) \
     .flow("ctl", "CTL",
           *([P.OUT(P.TASK("TaskUpdate", "ctl", lambda k: dict(k=k)))]
             if with_ctl else [])) \
     .body(recv_body)

    def update_body(A, k):
        with lock:
            events.append(("update", k))
        _fill(A, -(k + 1))

    g.task("TaskUpdate", k=P.Range(0, K - 1)) \
     .affinity(lambda k: V(k)) \
     .flow("A", "RW",
           P.IN(P.TASK("TaskBcast", "A", lambda k: dict(k=k))),
           P.OUT(P.DATA(lambda k: V(k)))) \
     .flow("ctl", "CTL",
           *([P.IN(P.TASK("TaskRecv", "ctl",
                          lambda k: [dict(k=k, n=n) for n in recv_range]))]
             if with_ctl else [])) \
     .body(update_body)
    return g, events, V, recv_range


def test_ex07_raw_ctl_orders_update_after_reads():
    """Ex07_RAW_CTL.jdf: the CTL gather guarantees every reader saw the
    broadcast value before the anti-dependent update overwrote it."""
    def run(P):
        g, events, V, recv_range = _raw_pools(P, with_ctl=True)
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        for k in (0, 1):
            upd = events.index(("update", k))
            recvs = [i for i, e in enumerate(events)
                     if e[0] == "recv" and e[1] == k]
            assert len(recvs) == len(recv_range)
            assert all(i < upd for i in recvs)      # CTL ordering held
        return (sorted(e for e in events if e[0] == "recv"),
                _home(V, 2))
    j, p = _both(run)
    # every reader saw the pre-update value; the updates wrote home
    assert j == p
    assert all(e[3] == e[1] + 1 for e in p[0]) and p[1] == [-1.0, -2.0]


def test_ex06_raw_runs_all_tasks():
    """Ex06_RAW.jdf (no CTL): all tasks still execute; read values may
    race the update by design."""
    def run(P):
        g, events, V, recv_range = _raw_pools(P, with_ctl=False)
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return (sum(1 for e in events if e[0] == "recv"),
                sum(1 for e in events if e[0] == "update"), _home(V, 2))
    j, p = _both(run)
    assert j == p == (8, 2, [-1.0, -2.0])


def test_range_with_step_and_derived_bounds():
    def run(P):
        hits = []
        g = P.PTG("steps", N=10)
        g.task("S", i=P.Range(0, lambda N: N - 1, 3),
               j=P.Range(lambda i: i, lambda i, N: min(i + 1, N - 1))) \
         .flow("X", "CTL") \
         .body(lambda i, j: hits.append((i, j)))
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return sorted(hits)
    expect = sorted((i, j) for i in range(0, 10, 3)
                    for j in range(i, min(i + 1, 9) + 1))
    assert _both(run) == (expect, expect)


def test_body_magic_names_and_globals():
    def run(P):
        seen = {}
        V = P.VectorTwoDimCyclic(1, 1).from_array(np.ones(1, np.float32))
        g = P.PTG("magic", ANSWER=42)

        def body(es, task, X, ANSWER):
            seen["es"] = es is not None
            seen["task"] = str(task)
            seen["X"] = float(X[0])
            seen["ANSWER"] = ANSWER

        g.task("M").affinity(lambda: V(0)) \
         .flow("X", "READ", P.IN(P.DATA(lambda: V(0)))) \
         .body(body)
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return seen
    j, p = _both(run)
    assert j == p == {"es": True, "task": "M()", "X": 1.0, "ANSWER": 42}


def test_ctl_two_guarded_deps_count_as_two_edges():
    """A 2x2 wavefront: W(1,1) has TWO simultaneously-applying CTL input
    deps (from W(0,1) and W(1,0)) and runs exactly once, after both."""
    def run(P):
        order = []
        V = P.VectorTwoDimCyclic(1, 1).from_array(np.zeros(1, np.float32))
        g = P.PTG("wave")
        g.task("W", m=P.Range(0, 1), n=P.Range(0, 1)) \
         .affinity(lambda: V(0)) \
         .flow("c", "CTL",
               P.IN(P.TASK("W", "c", lambda m, n: dict(m=m - 1, n=n)),
                    when=lambda m: m > 0),
               P.IN(P.TASK("W", "c", lambda m, n: dict(m=m, n=n - 1)),
                    when=lambda n: n > 0),
               P.OUT(P.TASK("W", "c", lambda m, n: dict(m=m + 1, n=n)),
                     when=lambda m: m < 1),
               P.OUT(P.TASK("W", "c", lambda m, n: dict(m=m, n=n + 1)),
                     when=lambda n: n < 1)) \
         .body(lambda m, n: order.append((m, n)))
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return sorted(order), order[0], order[-1]
    j, p = _both(run)
    assert j == p == ([(0, 0), (0, 1), (1, 0), (1, 1)], (0, 0), (1, 1))


def test_empty_range_gather_is_no_dep():
    """Boundary instances with an empty range gather run immediately."""
    def run(P):
        ran = []
        g = P.PTG("empty_range", N=3)
        g.task("Leaf", k=P.Range(0, 2)) \
         .flow("c", "CTL",
               P.IN(P.TASK("Leaf", "c",
                           lambda k: [dict(k=j) for j in range(k + 1, 0)])),
               P.OUT(P.TASK("Leaf", "c", lambda k: []))) \
         .body(lambda k: ran.append(k))
        with P.ctx() as ctx:
            ctx.add_taskpool(g.build())
            ctx.wait(timeout=10)
        return sorted(ran)
    assert _both(run) == ([0, 1, 2], [0, 1, 2])


def test_apply_with_int_returning_op_terminates():
    def run(P):
        A = P.TwoDimBlockCyclic(2, 2, 2, 2).from_array(
            np.zeros((2, 2), np.float32))
        with P.ctx() as ctx:
            ctx.add_taskpool(P.operators.apply_op(A, lambda T, m, n: 1))
            ctx.wait(timeout=10)
            return bool(ctx.test())
    assert _both(run) == (True, True)


@BOTH
def test_data_gather_rejected(pkg):
    """Two data-carrying arrivals on one flow fail loudly, not drop."""
    P = _P(pkg)
    V = P.VectorTwoDimCyclic(1, 2).from_array(np.zeros(2, np.float32))
    g = P.PTG("badgather")
    g.task("P", i=P.Range(0, 1)) \
     .affinity(lambda i: V(i)) \
     .flow("T", "RW", P.IN(P.DATA(lambda i: V(i))),
           P.OUT(P.TASK("C", "X", lambda i: dict()))) \
     .body(lambda T: None)
    g.task("C").affinity(lambda: V(0)) \
     .flow("X", "READ",
           P.IN(P.TASK("P", "T", lambda: [dict(i=0), dict(i=1)]))) \
     .body(lambda X: None)
    with P.ctx() as ctx:
        ctx.add_taskpool(g.build())
        with pytest.raises(RuntimeError):
            ctx.wait(timeout=10)
