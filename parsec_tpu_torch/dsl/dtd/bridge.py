"""PTG -> DTD bridge: replay a parameterized task graph through dynamic
task discovery.

Rebuild of the reference's ptg_to_dtd converter (reference:
mca/pins/ptg_to_dtd/pins_ptg_to_dtd_module.c — a PINS module that turns a
PTG taskpool into runtime ``insert_task`` calls so the DTD engine can be
validated against PTG-defined graphs).  The bridge enumerates the PTG's
instances, linearizes them in topological dep order, and inserts one DTD
task per instance:

- collection endpoints (``<- A(m, n)`` / ``-> A(m, n)``) become DTD tile
  accesses with the flow's access mode, so DTD's last-writer inference
  reproduces the PTG's RAW/WAR/WAW structure (fan-outs with a writing
  consumer serialize by WAR ordering where PTG hands out COW copies —
  same values, legal schedule);
- task-fed edges (``-> A TASK(...)``) ride the producer instance's tile
  for that flow — pure dataflow through DTD versioning;
- CTL edges become 1-element synthetic tiles written by the producer and
  read by the consumer (gathers read one per incoming edge), preserving
  control ordering;
- NEW flows allocate a synthetic tile shaped by the arena.

Limitations (enforced with clear errors): functional CPU bodies only, no
``es``/``task`` magic args, and NULL-forwarding flows are not preserved.

The port's copy of the JAX package's dsl/dtd/bridge.py: it never touches
a payload, so only its imports differ.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Tuple

from parsec_tpu_torch.core.task import (FromDesc, FromTask, New, Null,
                                        TaskClass, ToTask,
                                        normalize_body_outputs)
from parsec_tpu_torch.data.data import ACCESS_NONE, ACCESS_READ, \
    ACCESS_WRITE
from parsec_tpu_torch.dsl.dtd.insert import (DTDTaskpool, INOUT, INPUT,
                                             OUTPUT, VALUE)


def _raw_body(tc: TaskClass):
    for dev, hook in tc.incarnations:
        fn = getattr(hook, "__ptg_fn__", None)
        if fn is not None and dev == "cpu":
            return fn
    raise TypeError(
        f"{tc.name}: the PTG->DTD bridge needs a functional CPU body "
        "(declared via TaskBuilder.body)")


def _instances(tp) -> List[Tuple[TaskClass, Dict[str, int]]]:
    return [(tc, dict(locals_))
            for tc in tp.task_classes.values()
            for locals_ in tc.iter_space(tp.globals)]


def _succ_locals(end: ToTask, loc, stc: TaskClass):
    # fill derived single-valued params: dep expressions name peers by
    # their free params only (mirrors engine.release_deps)
    return [stc.complete_locals(s) for s in end.instances(loc)]


def _src_locals(end: FromTask, loc,
                stc: TaskClass) -> List[Dict[str, int]]:
    return [stc.complete_locals(s) for s in end.instances(loc)]


def _topo_order(tp, instances):
    """Kahn topological sort over task-fed dep edges."""
    idx = {tc.make_key(loc): i for i, (tc, loc) in enumerate(instances)}
    preds = [0] * len(instances)
    succs: List[List[int]] = [[] for _ in instances]
    for i, (tc, loc) in enumerate(instances):
        for flow in tc.flows:
            for dep in flow.active_outputs(loc):
                end = dep.end
                if not isinstance(end, ToTask):
                    continue
                stc = tp.task_classes[end.task_class]
                for sloc in _succ_locals(end, loc, stc):
                    j = idx.get(stc.make_key(sloc))
                    if j is not None:
                        succs[i].append(j)
                        preds[j] += 1
    order: List[int] = []
    queue = [i for i, p in enumerate(preds) if p == 0]
    while queue:
        i = queue.pop()
        order.append(i)
        for j in succs[i]:
            preds[j] -= 1
            if preds[j] == 0:
                queue.append(j)
    if len(order) != len(instances):
        raise ValueError("PTG graph has a task-fed dependency cycle")
    return [instances[i] for i in order]


def _make_body(tc: TaskClass, data_names: List[str], n_ctl: int,
               param_names: List[str], writable: List[str]):
    """Generate a DTD body with a REAL named signature (insert_task
    binds task.data by the function's parameter names) that forwards to
    the raw PTG body and re-emits written flows as a dict."""
    fn = _raw_body(tc)
    sig = [p.name for p in inspect.signature(fn).parameters.values()]
    if "es" in sig or "task" in sig:
        raise TypeError(
            f"{tc.name}: bodies using es/task magic args cannot be "
            "bridged to DTD")
    args = (list(data_names) + [f"_ctl{i}" for i in range(n_ctl)]
            + list(param_names))
    ns: Dict[str, Any] = {"_fn": fn, "_sig": sig, "_wr": writable,
                          "_norm": normalize_body_outputs}
    src = (f"def _bridge_body({', '.join(args)}):\n"
           f"    _bound = dict({', '.join(f'{a}={a}' for a in args)})\n"
           "    _ret = _fn(**{n: _bound[n] for n in _sig if n in _bound})\n"
           "    if _ret is None or not _wr:\n"
           "        return None\n"
           "    return {k: v for k, v in _norm(_ret, _wr).items()}\n")
    exec(src, ns)
    body = ns["_bridge_body"]
    body.__name__ = f"ptg2dtd_{tc.name}"
    return body


def run_ptg_as_dtd(src_tp, dtd_tp: DTDTaskpool) -> None:
    """Insert every instance of ``src_tp`` (a built ParameterizedTaskpool)
    into ``dtd_tp`` in topological order; call ``dtd_tp.wait()`` after
    (reference: the ptg_to_dtd PINS module's runtime conversion)."""
    out_tiles: Dict[Tuple, Any] = {}
    bodies: Dict[Tuple, Any] = {}

    for tc, loc in _topo_order(src_tp, _instances(src_tp)):
        key = tc.make_key(loc)
        data_args: List[Tuple[Any, Any]] = []
        data_names: List[str] = []
        ctl_args: List[Tuple[Any, Any]] = []
        writable: List[str] = []
        for flow in tc.flows:
            is_ctl = flow.access == ACCESS_NONE
            if is_ctl:
                # consumer side: one synthetic-tile read per incoming
                # edge — CTL gathers apply several deps at once
                for dep in flow.inputs:
                    if not dep.applies(loc):
                        continue
                    end = dep.end
                    if not isinstance(end, FromTask):
                        continue
                    stc = src_tp.task_classes[end.task_class]
                    for sloc in _src_locals(end, loc, stc):
                        t = out_tiles.get((stc.make_key(sloc), end.flow))
                        if t is not None:
                            ctl_args.append((t, INPUT))
                # producer side: a fresh 1-elt tile successors will read
                if any(isinstance(d.end, ToTask)
                       for d in flow.active_outputs(loc)):
                    t = dtd_tp.tile_new((1,), key=("ctl", key, flow.name))
                    ctl_args.append((t, OUTPUT))
                    out_tiles[(key, flow.name)] = t
                continue
            dep = flow.active_input(loc)
            end = dep.end if dep is not None else None
            if isinstance(end, FromDesc):
                ref = end.ref_fn(loc)
                tile = dtd_tp.tile_of(ref.dc, *ref.indices)
            elif isinstance(end, FromTask):
                tile = None
                stc = src_tp.task_classes[end.task_class]
                for sloc in _src_locals(end, loc, stc):
                    tile = out_tiles.get((stc.make_key(sloc), end.flow))
                    if tile is not None:
                        break
                if tile is None:
                    raise ValueError(
                        f"{tc.name}{loc}: task-fed flow {flow.name} has "
                        "no recorded producer tile (unsupported pattern)")
            elif isinstance(end, New):
                arena = src_tp.arenas.get(end.arena_name)
                if arena is None:
                    raise ValueError(
                        f"bridge: unknown arena {end.arena_name!r}")
                tile = dtd_tp.tile_new(tuple(arena.shape),
                                       key=("new", key, flow.name))
            elif isinstance(end, Null) or end is None:
                raise ValueError(
                    f"{tc.name}{loc}: NULL flows are not bridgeable")
            else:
                raise TypeError(f"unsupported input endpoint {end!r}")
            if flow.access & ACCESS_WRITE:
                mode = INOUT if flow.access & ACCESS_READ else OUTPUT
                writable.append(flow.name)
            else:
                mode = INPUT
            data_args.append((tile, mode))
            data_names.append(flow.name)
            if any(isinstance(d.end, ToTask)
                   for d in flow.active_outputs(loc)):
                out_tiles[(key, flow.name)] = tile
        value_args = [(loc[p], VALUE) for p, _ in tc.params]
        bkey = (id(tc), tuple(data_names), len(ctl_args))
        body = bodies.get(bkey)
        if body is None:
            body = bodies[bkey] = _make_body(
                tc, data_names, len(ctl_args),
                [p for p, _ in tc.params], writable)
        dtd_tp.insert_task(body, *(data_args + ctl_args + value_args))