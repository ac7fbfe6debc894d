"""The port's DAG scheduling simulator (parallel/dagsim.py) against the
JAX package's: twins of tests/test_dagsim.py on the port's PTG pools, and
the same DAGs through both packages' simulators.

The port's copy is plain, so the parity property is exact: the same
taskpool shapes, built by each package's PTG front-end, expand to the
same nodes and edges and simulate to the same makespan, busy time and
efficiency."""

import time

import numpy as np
import pytest
import torch

import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg as jax_ptg
import parsec_tpu.parallel.dagsim as jax_dagsim
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg as port_ptg
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.ptg import PTG, Range
from parsec_tpu_torch.parallel.dagsim import build_dag, critical_path, \
    simulate


def _chain_pool(n, ptg=port_ptg):
    p = ptg.PTG("chain", N=n)
    p.task("T", i=ptg.Range(0, n - 1)) \
        .flow("x", "CTL",
              ptg.IN(ptg.TASK("T", "x", lambda i: dict(i=i - 1)),
                     when=lambda i: i > 0),
              ptg.OUT(ptg.TASK("T", "x", lambda i: dict(i=i + 1)),
                      when=lambda i, N=n: i < N - 1)) \
        .body(lambda: None)
    return p.build()


def _fanout_pool(width, ptg=port_ptg):
    p = ptg.PTG("fan", W=width)
    p.task("SRC") \
        .flow("x", "CTL",
              ptg.OUT(ptg.TASK("W", "x",
                               lambda W=width: [dict(i=i)
                                                for i in range(W)]))) \
        .body(lambda: None)
    p.task("W", i=ptg.Range(0, width - 1)) \
        .flow("x", "CTL", ptg.IN(ptg.TASK("SRC", "x", lambda i: dict()))) \
        .body(lambda: None)
    return p.build()


def test_chain_is_serial():
    tp = _chain_pool(10)
    dag = build_dag(tp, lambda tc, loc: 1.0)
    res = simulate(dag, n_chips=4)
    assert res["n_tasks"] == 10
    assert abs(res["makespan_s"] - 10.0) < 1e-9     # a chain cannot scale
    assert abs(res["efficiency"] - 10.0 / 40.0) < 1e-9
    assert abs(critical_path(dag) - 10.0) < 1e-9


def test_fanout_scales_with_chips():
    tp = _fanout_pool(8)

    def chips_rr(tc, loc):          # spread workers round-robin
        return loc.get("i", 0) % 4
    dag = build_dag(tp, lambda tc, loc: 1.0, chip_fn=chips_rr)
    res = simulate(dag, n_chips=4, alpha=0.0)
    # src(1s) then 8 workers over 4 chips (2s) = 3s makespan
    assert abs(res["makespan_s"] - 3.0) < 1e-9
    res1 = simulate(dag, n_chips=1, alpha=0.0)
    assert abs(res1["makespan_s"] - 9.0) < 1e-9


def test_comm_cost_charged_on_cross_chip_edges():
    tp = _chain_pool(2)

    def place(tc, loc):
        return loc["i"]             # the two tasks on different chips
    dag = build_dag(tp, lambda tc, loc: 1.0,
                    bytes_fn=lambda tc, fl: 10 ** 9, chip_fn=place)
    res = simulate(dag, n_chips=2, alpha=0.5, beta=1e9)
    # 1s + (0.5 latency + 1s transfer) + 1s
    assert abs(res["makespan_s"] - 3.5) < 1e-9


def test_priority_breaks_ties():
    p = PTG("prio", N=4)
    p.task("T", i=Range(0, 3)) \
        .priority(lambda i: i) \
        .flow("x", "CTL") \
        .body(lambda: None)
    tp = p.build()
    dag = build_dag(tp, lambda tc, loc: 1.0,
                    chip_fn=lambda tc, loc: 0)
    res = simulate(dag, n_chips=1)
    assert abs(res["makespan_s"] - 4.0) < 1e-9


def _potrf_dur(tc, loc):
    return {"POTRF": 1.0, "POTRFL": 0.3, "TRSM": 2.0, "SYRK": 2.0,
            "GEMM": 2.0}[tc]


def test_potrf_dag_expands_and_scales():
    """The real potrf taskpool, distributed 2D block-cyclic over 8
    chips: the DAG must expand to the textbook task counts and the
    simulated efficiency must rise with more parallelism-per-chip."""
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    NT, mb = 12, 64
    n = NT * mb
    A = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, nodes=8, P=2, Q=4)
    tp = potrf_taskpool(A, device="cpu")
    dag = build_dag(tp, _potrf_dur, bytes_fn=lambda tc, fl: mb * mb * 4)
    want = {
        "POTRF": NT - 1, "POTRFL": 1,
        "TRSM": NT * (NT - 1) // 2,
        "SYRK": NT * (NT - 1) // 2,
        "GEMM": NT * (NT - 1) * (NT - 2) // 6,
    }
    got = {}
    for node in dag.nodes.values():
        got[node["tc"]] = got.get(node["tc"], 0) + 1
    assert got == want
    r8 = simulate(dag, n_chips=8, alpha=2e-6, beta=4.5e10)
    r1 = simulate(dag, n_chips=1)
    assert r1["efficiency"] > 0.999          # serial = perfectly busy
    assert 0.0 < r8["efficiency"] <= 1.0
    # speedup is real but sub-linear on a small grid
    speedup = r1["makespan_s"] / r8["makespan_s"]
    assert 2.0 < speedup <= 8.0
    # the infinite-resource bound is respected
    assert r8["makespan_s"] >= critical_path(dag) - 1e-9


def test_efficiency_definition():
    tp = _fanout_pool(4)
    dag = build_dag(tp, lambda tc, loc: 2.0,
                    chip_fn=lambda tc, loc: loc.get("i", 0) % 2)
    res = simulate(dag, n_chips=2, overhead=0.5, alpha=0.0)
    # work = 5 tasks * 2.5s; makespan: src 2.5, then 2 waves of workers
    # per chip = 2.5 + 5.0
    assert abs(res["total_work_s"] - 12.5) < 1e-9
    assert abs(res["makespan_s"] - 7.5) < 1e-9
    assert abs(res["efficiency"] - 12.5 / 15.0) < 1e-9


def test_sim_vs_measured_single_processor():
    """The simulator's makespan tracks a measured runtime wall: on one
    worker the model is total work + per-task overhead, with per-class
    body times from the task profiler's intervals of the run whose wall
    is measured (the port's potrf on its CPU bodies, after a warm run).
    The band is the JAX package's (0.3-2x of the wall)."""
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.prof.pins import install_task_profiler
    from parsec_tpu_torch.prof.profiling import EV_END, EV_START, Profile

    mb, nt = 64, 6
    n = mb * nt
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, n)).astype(np.float32)
    spd = (B @ B.T + n * np.eye(n)).astype(np.float32)

    def run(prof=None):
        A = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n,
                              ln=n).from_array(torch.from_numpy(spd.copy()))
        with Context(nb_cores=1, device="cpu") as ctx:
            mod = install_task_profiler(ctx, prof) if prof else None
            t0 = time.perf_counter()
            ctx.add_taskpool(potrf_taskpool(A, device="cpu"))
            ctx.wait(timeout=120)
            wall = time.perf_counter() - t0
            if mod is not None:
                mod.uninstall(ctx)
        return wall

    run()                                       # warm
    prof = Profile()
    wall = run(prof)
    keys = {ec.key: name for name, ec in prof._dict.items()}
    sums, counts, open_ev = {}, {}, {}
    for sb in prof._streams.values():
        for key, flags, _tp, eid, _oid, ts, _info in sb.merged_events():
            if flags & EV_START:
                open_ev[eid] = (key, ts)
            elif flags & EV_END and eid in open_ev:
                k, t0 = open_ev.pop(eid)
                name = keys[k]
                sums[name] = sums.get(name, 0.0) + (ts - t0)
                counts[name] = counts.get(name, 0) + 1
    durs = {name: sums[name] / counts[name] for name in sums}
    assert set(durs) >= {"POTRF", "TRSM", "SYRK", "GEMM"}, durs

    A4 = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n)
    dag = build_dag(potrf_taskpool(A4, device="cpu"),
                    lambda tc, loc: durs[tc])
    pred = simulate(dag, 1, overhead=16e-6)["makespan_s"]
    assert 0.3 * wall < pred < 2.0 * wall, (pred, wall, durs)


# ---------------------------------------------------------------------------
# parity: the same DAGs through both packages' simulators
# ---------------------------------------------------------------------------

def _potrf_pool(side):
    NT, mb = 8, 16
    n = NT * mb
    if side == "jax":
        from parsec_tpu.apps.potrf import potrf_taskpool
        A = jax_matrix.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n,
                                         nodes=4, P=2, Q=2)
    else:
        from parsec_tpu_torch.apps.potrf import potrf_taskpool
        A = port_matrix.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n,
                                          nodes=4, P=2, Q=2)
    return potrf_taskpool(A, device="cpu")


@pytest.mark.parametrize("shape", ["chain", "fanout", "potrf"])
@pytest.mark.parametrize("n_chips", [1, 3, 4])
def test_same_dag_same_schedule_in_both_packages(shape, n_chips):
    """Seeded per-node durations (numpy), the same DAG shape from each
    package's front-end: equal node sets, edges, makespans, busy times
    and critical paths."""
    builders = {
        "chain": lambda side: _chain_pool(
            12, jax_ptg if side == "jax" else port_ptg),
        "fanout": lambda side: _fanout_pool(
            9, jax_ptg if side == "jax" else port_ptg),
        "potrf": _potrf_pool,
    }
    rng = np.random.default_rng(7)
    table = {}

    def dur(tc, loc):
        key = (tc, tuple(sorted(loc.items())))
        if key not in table:
            table[key] = float(rng.uniform(0.5, 2.0))
        return table[key]

    ref_dag = jax_dagsim.build_dag(builders[shape]("jax"), dur,
                                   bytes_fn=lambda tc, fl: 4096)
    got_dag = build_dag(builders[shape]("port"), dur,
                        bytes_fn=lambda tc, fl: 4096)
    assert got_dag.nodes == ref_dag.nodes
    assert {k: sorted(v) for k, v in got_dag.succs.items()} == \
        {k: sorted(v) for k, v in ref_dag.succs.items()}
    ref = jax_dagsim.simulate(ref_dag, n_chips, alpha=1e-3, beta=1e6,
                              overhead=0.01)
    got = simulate(got_dag, n_chips, alpha=1e-3, beta=1e6, overhead=0.01)
    assert got == ref
    assert critical_path(got_dag, 0.01) == \
        jax_dagsim.critical_path(ref_dag, 0.01)
