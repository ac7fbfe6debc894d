"""The port's runtime core against the JAX package's: hand-built task
classes through the full lifecycle.

Twins of tests/test_core_runtime.py (reference analogs: examples/Ex02_Chain,
Ex04_ChainData, Ex05_Broadcast, tests/runtime/multichain): each case runs
the same DAG on the same inputs through both packages (the port on
``device="cpu"``) and holds what each observes — execution order, the
values written back, retries, incarnations tried — to the reference
test's expectations and to each other.  The port's device incarnation is
``cuda`` where the JAX package's is ``tpu`` (on the CPU-backed device
module, the port's Context runs it on the CPU).
"""

import threading

import numpy as np
import pytest
import torch

import parsec_tpu as jax_pkg
import parsec_tpu.core.task as jax_task
import parsec_tpu.data.arena as jax_arena
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu_torch as port_pkg
import parsec_tpu_torch.core.task as port_task
import parsec_tpu_torch.data.arena as port_arena
import parsec_tpu_torch.data.matrix as port_matrix

PKGS = {"jax": (jax_pkg, jax_task, jax_arena, jax_matrix, {}, "tpu"),
        "port": (port_pkg, port_task, port_arena, port_matrix,
                 {"device": "cpu"}, "cuda")}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


class _P:
    """One package's names, as the reference test imports them."""

    def __init__(self, pkg):
        (self.pkg, task, arena, matrix, self.ctx_kw,
         self.accel) = PKGS[pkg]
        for name in ("Context", "ParameterizedTaskpool", "TaskClass", "Dep",
                     "RW", "READ", "WRITE", "CTL", "FromDesc", "FromTask",
                     "ToDesc", "ToTask", "New", "compose"):
            setattr(self, name, getattr(self.pkg, name))
        self.HookReturn = task.HookReturn
        self.Arena = arena.Arena
        self.TwoDimBlockCyclic = matrix.TwoDimBlockCyclic

    def ctx(self, **kw):
        kw.setdefault("nb_cores", 2)
        return self.Context(**kw, **self.ctx_kw)

    def tile(self, a):
        return self.TwoDimBlockCyclic(*a.shape, *a.shape).from_array(a)


def _fill(payload, value):
    if isinstance(payload, torch.Tensor):
        payload.fill_(value)
    else:
        payload.fill(value)


def chain_taskpool(P, A, NT, body):
    """Ex02/Ex04-style linear chain on tile A(0,0): Step(0..NT-1), T
    flows through the chain and back to A."""
    tp = P.ParameterizedTaskpool("chain", globals_={"NT": NT})
    tc = P.TaskClass(
        "Step",
        params=[("k", lambda g, l: range(g["NT"]))],
        affinity=lambda l: A(0, 0),
        flows=[P.RW("T",
                    inputs=[P.Dep(P.FromDesc(lambda l: A(0, 0)),
                                  guard=lambda l: l["k"] == 0),
                            P.Dep(P.FromTask("Step", "T",
                                             lambda l: {"k": l["k"] - 1}),
                                  guard=lambda l: l["k"] > 0)],
                    outputs=[P.Dep(P.ToTask("Step", "T",
                                            lambda l: {"k": l["k"] + 1}),
                                   guard=lambda l: l["k"] < NT - 1),
                             P.Dep(P.ToDesc(lambda l: A(0, 0)),
                                   guard=lambda l: l["k"] == NT - 1)])],
        body=body)
    tp.add_task_class(tc)
    return tp


def _both(run):
    """``run(P)`` through both packages: (JAX package's, port's)."""
    return run(_P("jax")), run(_P("port"))


def test_chain_sequences_and_writes_back():
    def run(P):
        a = np.zeros((4, 4), np.float32)
        A = P.tile(a)
        seen = []

        def body(es, task):
            seen.append(task.locals["k"])
            task.data["T"].payload += 1

        with P.ctx() as ctx:
            ctx.add_taskpool(chain_taskpool(P, A, 10, body))
            ctx.wait(timeout=30)
        return seen, float(A.data_of(0, 0).copy_on(0).payload[0, 0])
    j, p = _both(run)
    assert j == p == (list(range(10)), 10.0)   # strict order, all landed


@pytest.mark.parametrize("sched", ["gd", "ip", "ap", "spq", "rnd", "ll",
                                   "lfq", "pbq", "ltq", "lhq", "llp"])
def test_all_schedulers_run_chain(sched):
    def run(P):
        A = P.tile(np.zeros((2, 2), np.float32))

        def body(es, task):
            task.data["T"].payload += 1

        with P.ctx(scheduler=sched) as ctx:
            ctx.add_taskpool(chain_taskpool(P, A, 6, body))
            ctx.wait(timeout=30)
        return float(A.data_of(0, 0).copy_on(0).payload[0, 0])
    assert _both(run) == (6.0, 6.0)


def test_broadcast_fanout():
    """Ex05-style: one Root output fans out to N Reader tasks."""
    N = 8

    def run(P):
        A = P.tile(np.full((2, 2), 7.0, np.float32))
        got = []
        lock = threading.Lock()
        tp = P.ParameterizedTaskpool("bcast")

        def root_body(es, task):
            task.data["T"].payload *= 2

        def reader_body(es, task):
            with lock:
                got.append((task.locals["i"],
                            float(task.data["X"].payload[0, 0])))

        root = P.TaskClass(
            "Root", params=[], affinity=lambda l: A(0, 0),
            flows=[P.RW("T",
                        inputs=[P.Dep(P.FromDesc(lambda l: A(0, 0)))],
                        outputs=[P.Dep(P.ToTask("Reader", "X",
                                                lambda l, i=i: {"i": i}))
                                 for i in range(N)]
                        + [P.Dep(P.ToDesc(lambda l: A(0, 0)))])],
            body=root_body)
        reader = P.TaskClass(
            "Reader", params=[("i", lambda g, l: range(N))],
            affinity=lambda l: A(0, 0),
            flows=[P.READ("X", inputs=[P.Dep(P.FromTask("Root", "T",
                                                        lambda l: {}))])],
            body=reader_body)
        tp.add_task_class(root)
        tp.add_task_class(reader)
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return sorted(got), float(A.data_of(0, 0).copy_on(0).payload[0, 0])
    j, p = _both(run)
    assert j == p == ([(i, 14.0) for i in range(N)], 14.0)


def test_diamond_join_counts_two_inputs():
    """Fork -> (Left, Right) -> Join: join waits for both arrivals, and the
    arena copies are retired after join consumed them."""
    def run(P):
        A = P.tile(np.ones((2, 2), np.float32))
        order = []
        lock = threading.Lock()

        def mk_body(name, delta):
            def body(es, task):
                with lock:
                    order.append(name)
                for c in task.data.values():
                    if c is not None and \
                            task.task_class.flows[0].access & 0x2:
                        c.payload += delta
            return body

        tp = P.ParameterizedTaskpool("diamond")
        arena = P.Arena((2, 2), np.float32 if P.pkg is jax_pkg
                        else torch.float32)
        tp.add_arena("default", arena)
        fork = P.TaskClass(
            "Fork", params=[], affinity=lambda l: A(0, 0),
            flows=[P.RW("T", inputs=[P.Dep(P.FromDesc(lambda l: A(0, 0)))],
                        outputs=[P.Dep(P.ToTask("Left", "L", lambda l: {})),
                                 P.Dep(P.ToTask("Right", "R",
                                                lambda l: {}))])],
            body=mk_body("fork", 1))
        left = P.TaskClass(
            "Left", params=[], affinity=lambda l: A(0, 0),
            flows=[P.READ("L", inputs=[P.Dep(P.FromTask("Fork", "T",
                                                        lambda l: {}))]),
                   P.WRITE("O", inputs=[P.Dep(P.New("default"))],
                           outputs=[P.Dep(P.ToTask("Join", "A",
                                                   lambda l: {}))])],
            body=lambda es, task: _fill(task.data["O"].payload,
                                        float(task.data["L"].payload[0, 0])
                                        + 10))
        right = P.TaskClass(
            "Right", params=[], affinity=lambda l: A(0, 0),
            flows=[P.READ("R", inputs=[P.Dep(P.FromTask("Fork", "T",
                                                        lambda l: {}))]),
                   P.WRITE("O", inputs=[P.Dep(P.New("default"))],
                           outputs=[P.Dep(P.ToTask("Join", "B",
                                                   lambda l: {}))])],
            body=lambda es, task: _fill(task.data["O"].payload,
                                        float(task.data["R"].payload[0, 0])
                                        + 20))
        out = {}

        def join_body(es, task):
            out["sum"] = float(task.data["A"].payload[0, 0]
                               + task.data["B"].payload[0, 0])

        join = P.TaskClass(
            "Join", params=[], affinity=lambda l: A(0, 0),
            flows=[P.READ("A", inputs=[P.Dep(P.FromTask("Left", "O",
                                                        lambda l: {}))]),
                   P.READ("B", inputs=[P.Dep(P.FromTask("Right", "O",
                                                        lambda l: {}))])],
            body=join_body)
        for tc in (fork, left, right, join):
            tp.add_task_class(tc)
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return order[0], out["sum"], arena.released == arena.allocated
    j, p = _both(run)
    # fork ran first; join saw both arena outputs (2+10) + (2+20)
    assert j == p == ("fork", 34.0, True)


def test_ctl_flow_ordering():
    """CTL edges order tasks with no data payload (reference: examples
    Ex07 CTL); the gather "<- CTL First(0..3)" is one dep of
    multiplicity 4."""
    def run(P):
        order = []
        lock = threading.Lock()
        A = P.tile(np.zeros((2, 2), np.float32))
        tp = P.ParameterizedTaskpool("ctl", globals_={"N": 4})

        def first_body(es, task):
            with lock:
                order.append(("first", task.locals["i"]))

        def second_body(es, task):
            with lock:
                order.append(("second", 0))

        first = P.TaskClass(
            "First", params=[("i", lambda g, l: range(4))],
            affinity=lambda l: A(0, 0),
            flows=[P.CTL("C", outputs=[P.Dep(P.ToTask("Second", "C",
                                                      lambda l: {}))])],
            body=first_body)
        second = P.TaskClass(
            "Second", params=[], affinity=lambda l: A(0, 0),
            flows=[P.CTL("C", inputs=[P.Dep(P.FromTask("First", "C",
                                                       lambda l: {}),
                                            count=lambda l: 4)])],
            body=second_body)
        tp.add_task_class(first)
        tp.add_task_class(second)
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return order[-1], len(order), sorted(order[:-1])
    j, p = _both(run)
    assert j == p == (("second", 0), 5, [("first", i) for i in range(4)])


def test_compound_sequencing():
    def run(P):
        A = P.tile(np.zeros((2, 2), np.float32))
        marks = []

        def mk(mark):
            def body(es, task):
                marks.append(mark)
                task.data["T"].payload += 1
            return body

        with P.ctx() as ctx:
            ctx.add_taskpool(P.compose(chain_taskpool(P, A, 3, mk("a")),
                                       chain_taskpool(P, A, 3, mk("b"))))
            ctx.wait(timeout=30)
        return marks, float(A.data_of(0, 0).copy_on(0).payload[0, 0])
    j, p = _both(run)
    assert j == p == (["a"] * 3 + ["b"] * 3, 6.0)


@BOTH
def test_body_error_propagates(pkg):
    P = _P(pkg)
    A = P.tile(np.zeros((2, 2), np.float32))

    def body(es, task):
        raise ValueError("kaboom")

    with P.ctx() as ctx:
        ctx.add_taskpool(chain_taskpool(P, A, 2, body))
        with pytest.raises(RuntimeError, match="failed"):
            ctx.wait(timeout=30)


def test_again_reschedules():
    def run(P):
        A = P.tile(np.zeros((2, 2), np.float32))
        tries = {"n": 0}

        def body(es, task):
            tries["n"] += 1
            if tries["n"] < 3:
                return P.HookReturn.AGAIN
            return P.HookReturn.DONE

        tp = P.ParameterizedTaskpool("again")
        tp.add_task_class(P.TaskClass(
            "T", params=[], affinity=lambda l: A(0, 0),
            flows=[P.READ("X", inputs=[P.Dep(P.FromDesc(lambda l:
                                                        A(0, 0)))])],
            body=body))
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return tries["n"]
    assert _both(run) == (3, 3)


def test_priority_order_with_ap():
    """Higher-priority startup tasks run first under the ap scheduler
    with a single worker."""
    def run(P):
        A = P.tile(np.zeros((2, 2), np.float32))
        ran = []
        tp = P.ParameterizedTaskpool("prio", globals_={"N": 6})
        tp.add_task_class(P.TaskClass(
            "P", params=[("i", lambda g, l: range(6))],
            affinity=lambda l: A(0, 0),
            priority=lambda l: l["i"],
            flows=[P.READ("X", inputs=[P.Dep(P.FromDesc(lambda l:
                                                        A(0, 0)))])],
            body=lambda es, task: ran.append(task.locals["i"])))
        with P.ctx(nb_cores=1, scheduler="ap") as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return ran
    j, p = _both(run)
    assert j == p == sorted(p, reverse=True)


def test_context_test_and_empty_pool():
    def run(P):
        with P.ctx() as ctx:
            tp = P.ParameterizedTaskpool("empty")
            ctx.add_taskpool(tp)
            ctx.wait(timeout=10)
            return bool(ctx.test()), bool(tp.completed)
    assert _both(run) == ((True, True), (True, True))


def test_disable_falls_through_to_next_incarnation():
    """DISABLE disables the class-wide incarnation WITHOUT skipping the
    next chore (reference: PARSEC_HOOK_RETURN_DISABLE semantics): the
    first task tries the device incarnation then the CPU body; later
    tasks skip the device incarnation."""
    def run(P):
        A = P.tile(np.zeros((2, 2), np.float32))
        hits = []
        tc = P.TaskClass(
            "D", params=[("i", lambda g, l: range(3))],
            affinity=lambda l: A(0, 0),
            incarnations=[(P.accel, lambda es, t: hits.append("accel")
                           or P.HookReturn.DISABLE)],
            flows=[P.READ("X", inputs=[P.Dep(P.FromDesc(lambda l:
                                                        A(0, 0)))])],
            body=lambda es, t: hits.append("cpu"))
        tp = P.ParameterizedTaskpool("dis")
        tp.add_task_class(tc)
        with P.ctx(nb_cores=1) as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return hits.count("accel"), hits.count("cpu")
    assert _both(run) == ((1, 3), (1, 3))


def test_body_returning_true_is_done_not_again():
    def run(P):
        A = P.tile(np.zeros((2, 2), np.float32))
        runs = []
        tp = P.ParameterizedTaskpool("boolret")
        tp.add_task_class(P.TaskClass(
            "B", params=[], affinity=lambda l: A(0, 0),
            flows=[P.READ("X", inputs=[P.Dep(P.FromDesc(lambda l:
                                                        A(0, 0)))])],
            body=lambda es, t: runs.append(1) or True))
        with P.ctx() as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=10)
        return runs
    assert _both(run) == ([1], [1])


@pytest.mark.parametrize("sched", ["ll", "ap", "ltq", "pbq", "lfq"])
def test_again_no_livelock_single_worker(sched):
    """Fairness contract: an AGAIN task waiting on a sibling must not
    starve it on a single stream (reference: sched.h:58-99 distance)."""
    def run(P):
        A = P.tile(np.zeros((2, 2), np.float32))
        state = {"sibling_ran": False, "spins": 0}

        def waiter(es, task):
            if not state["sibling_ran"]:
                state["spins"] += 1
                if state["spins"] > 1000:
                    raise RuntimeError("livelock")
                return P.HookReturn.AGAIN
            return P.HookReturn.DONE

        def sibling(es, task):
            state["sibling_ran"] = True

        tp = P.ParameterizedTaskpool("fair")
        for name, prio, body in (("Waiter", 100, waiter),
                                 ("Sibling", 0, sibling)):
            tp.add_task_class(P.TaskClass(
                name, params=[], affinity=lambda l: A(0, 0),
                priority=lambda l, prio=prio: prio,
                flows=[P.READ("X", inputs=[P.Dep(P.FromDesc(lambda l:
                                                            A(0, 0)))])],
                body=body))
        with P.ctx(nb_cores=1, scheduler=sched) as ctx:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        return state["sibling_ran"]
    assert _both(run) == (True, True)


def test_long_compound_of_empty_pools_no_recursion():
    def run(P):
        pools = [P.ParameterizedTaskpool(f"p{i}") for i in range(300)]
        with P.ctx() as ctx:
            ctx.add_taskpool(P.compose(*pools))
            ctx.wait(timeout=30)
        return all(p.completed for p in pools)
    assert _both(run) == (True, True)
