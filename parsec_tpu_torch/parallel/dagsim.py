"""DAG scheduling-efficiency simulator.

The reference's headline scaling metric (DAG scheduling efficiency over
many devices; the GFLOPS-vs-scale harness pattern of reference
tests/dsl/dtd/dtd_test_simple_gemm.c:659-666) needs more devices than a
build host has.  The answer mirrors what the task-scheduling community
does (DPLASMA/StarPU simulate with
simgrid): drive the REAL parameterized task graph — the same TaskClass
/ Flow / Dep structures the runtime executes, enumerated by the same
``iter_space``, placed by the same owner-computes affinity — through a
discrete-event list-scheduling simulation with measured kernel
durations and an alpha-beta communication model.

What is simulated faithfully:
- the full dependency structure (guarded deps, range fan-outs, CTL
  edges) of the actual taskpool object;
- owner-computes placement from the collection's P x Q block-cyclic
  distribution (chip = the affinity datum's rank);
- priority-driven list scheduling per chip (highest task priority among
  ready tasks — the runtime's scheduler discipline);
- cross-chip edges charged alpha + bytes/beta, deduplicated per
  (producer, flow, destination chip) the way the runtime's collective
  bcast ships one payload per destination device.

What is abstracted: link contention (alpha-beta per edge, no shared-link
queueing) and memory capacity.  Durations and overheads are inputs —
a caller calibrates them on the real device.
"""

from __future__ import annotations

import heapq
import itertools
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from parsec_tpu_torch.core.task import FromTask, ToTask


class SimDag:
    """Static expansion of a ParameterizedTaskpool's DAG."""

    def __init__(self):
        self.nodes: Dict[Tuple, Dict[str, Any]] = {}
        #: src key -> list of (dst key, flow_name, bytes)
        self.succs: Dict[Tuple, List[Tuple[Tuple, str, int]]] = \
            defaultdict(list)
        self.preds_count: Dict[Tuple, int] = defaultdict(int)


def build_dag(tp, duration_fn: Callable[[str, Dict[str, int]], float],
              bytes_fn: Optional[Callable[[str, str], int]] = None,
              chip_fn: Optional[Callable] = None) -> SimDag:
    """Expand every task instance and task->task edge of ``tp``.

    ``duration_fn(class_name, locals) -> seconds``;
    ``bytes_fn(class_name, flow_name) -> payload bytes`` for the comm
    model (default 0); ``chip_fn(tc, locals) -> chip`` overrides the
    affinity rank (default: ``tc.rank_of``, i.e. the collection's own
    distribution — build the collection with nodes=n_chips).
    """
    dag = SimDag()
    for tc in tp.task_classes.values():
        for locals_ in tc.iter_space(tp.globals):
            key = tc.make_key(locals_)
            chip = (chip_fn(tc, locals_) if chip_fn is not None
                    else tc.rank_of(locals_))
            prio = tc.priority(locals_) if tc.priority else 0
            dag.nodes[key] = {
                "tc": tc.name, "locals": dict(locals_), "chip": int(chip),
                "prio": int(prio),
                "dur": float(duration_fn(tc.name, locals_)),
            }
    for tc in tp.task_classes.values():
        for locals_ in tc.iter_space(tp.globals):
            key = tc.make_key(locals_)
            for flow in tc.flows:
                nbytes = int(bytes_fn(tc.name, flow.name)) if bytes_fn \
                    else 0
                for dep in flow.active_outputs(locals_):
                    if not isinstance(dep.end, ToTask):
                        continue
                    dst_tc = tp.task_classes[dep.end.task_class]
                    for params in dep.end.instances(locals_):
                        # dep expressions carry free params only; fill
                        # derived locals before keying (JDF derived
                        # locals are single-valued TaskClass params)
                        params = dst_tc.complete_locals(params)
                        dkey = dst_tc.make_key(params)
                        if dkey in dag.nodes:
                            dag.succs[key].append((dkey, flow.name,
                                                   nbytes))
                            dag.preds_count[dkey] += 1
    return dag


def simulate(dag: SimDag, n_chips: int, alpha: float = 2e-6,
             beta: float = 4.5e10, overhead: float = 0.0) -> Dict[str, Any]:
    """Priority list-scheduling simulation of ``dag`` over ``n_chips``.

    ``alpha``/``beta``: per-message latency (s) and bandwidth (B/s) of a
    cross-chip edge (the JAX package's interconnect-class defaults); ``overhead``: per-task runtime
    cost charged to the owning chip around the body (the measured
    scheduling overhead).  Returns makespan, busy time, efficiency
    (sum(durations) / (n_chips * makespan)) and per-chip utilization.
    """
    # per-chip: tasks whose deps resolved but whose data may still be in
    # flight (notyet, keyed by arrival time) vs runnable now (avail, by
    # descending priority)
    notyet: List[List] = [[] for _ in range(n_chips)]
    avail: List[List] = [[] for _ in range(n_chips)]
    chip_free = [0.0] * n_chips
    chip_busy = [0.0] * n_chips
    data_ready: Dict[Tuple, float] = defaultdict(float)
    pending = dict(dag.preds_count)
    seq = itertools.count()
    finish_at: Dict[Tuple, float] = {}

    events: List[Tuple[float, int, int]] = []   # (time, seq, chip)

    def enqueue(key, t_ready):
        node = dag.nodes[key]
        c = node["chip"] % n_chips
        heapq.heappush(notyet[c], (t_ready, -node["prio"], next(seq), key))
        heapq.heappush(events, (max(t_ready, chip_free[c]), next(seq), c))

    for key, node in dag.nodes.items():
        if pending.get(key, 0) == 0:
            enqueue(key, 0.0)

    done = 0
    makespan = 0.0
    while events:
        now, _, c = heapq.heappop(events)
        if chip_free[c] > now + 1e-18:
            # chip still running: defer to its free time (each deferral
            # moves strictly later, so progress is monotonic)
            heapq.heappush(events, (chip_free[c], next(seq), c))
            continue
        # surface everything that has arrived by `now`
        while notyet[c] and notyet[c][0][0] <= now + 1e-18:
            t_ready, nprio, s, key = heapq.heappop(notyet[c])
            heapq.heappush(avail[c], (nprio, s, key))
        if not avail[c]:
            if notyet[c]:
                heapq.heappush(events,
                               (max(notyet[c][0][0], chip_free[c]),
                                next(seq), c))
            continue
        _, _, key = heapq.heappop(avail[c])
        node = dag.nodes[key]
        start = max(now, chip_free[c])
        fin = start + overhead + node["dur"]
        chip_free[c] = fin
        chip_busy[c] += overhead + node["dur"]
        finish_at[key] = fin
        makespan = max(makespan, fin)
        done += 1
        # release successors; cross-chip edges pay alpha + bytes/beta
        # (no link-contention model — one bcast payload per dst chip and
        # per-edge latency coincide under that simplification)
        for dkey, flow_name, nbytes in dag.succs.get(key, ()):
            dst = dag.nodes[dkey]
            dc = dst["chip"] % n_chips
            if dc == node["chip"] % n_chips:
                arrival = fin
            else:
                arrival = fin + alpha + (nbytes / beta if beta else 0.0)
            data_ready[dkey] = max(data_ready[dkey], arrival)
            pending[dkey] -= 1
            if pending[dkey] == 0:
                enqueue(dkey, data_ready[dkey])
        if avail[c] or notyet[c]:
            heapq.heappush(events, (chip_free[c], next(seq), c))
    if done != len(dag.nodes):
        stuck = len(dag.nodes) - done
        raise RuntimeError(f"simulation deadlock: {stuck} tasks never ran "
                           "(cyclic or dangling deps)")
    total_work = sum(n["dur"] for n in dag.nodes.values()) \
        + overhead * len(dag.nodes)
    eff = total_work / (n_chips * makespan) if makespan > 0 else 1.0
    return {
        "n_chips": n_chips,
        "n_tasks": len(dag.nodes),
        "makespan_s": makespan,
        "total_work_s": total_work,
        "efficiency": eff,
        "chip_util": [b / makespan if makespan else 0.0
                      for b in chip_busy],
    }


def critical_path(dag: SimDag, overhead: float = 0.0) -> float:
    """Longest duration-weighted path (infinite-chip lower bound)."""
    memo: Dict[Tuple, float] = {}
    order: List[Tuple] = []
    pending = dict(dag.preds_count)
    stack = [k for k in dag.nodes if pending.get(k, 0) == 0]
    while stack:
        k = stack.pop()
        order.append(k)
        for dkey, _f, _b in dag.succs.get(k, ()):
            pending[dkey] -= 1
            if pending[dkey] == 0:
                stack.append(dkey)
    for k in reversed(order):
        best = 0.0
        for dkey, _f, _b in dag.succs.get(k, ()):
            best = max(best, memo.get(dkey, 0.0))
        memo[k] = dag.nodes[k]["dur"] + overhead + best
    return max(memo.values()) if memo else 0.0
