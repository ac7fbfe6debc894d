"""Cross-rank causal DAG: trace merge, critical path, makespan buckets.

The merge-and-attribute half of the causal trace pipeline (the role the
reference fills with OTF2 + external analyzers; here the runtime's own
events — prof/causal.py — carry enough structure to answer "where did
the makespan go" directly):

1. :func:`merge_traces` loads one ``.ptt`` per rank, aligns every
   timestamp onto rank 0's clock using the per-peer offsets the
   TAG_CLOCK ping exchange recorded into each trace header, and tags
   rows with their rank.
2. :func:`build_dag` reconstructs the weighted cross-rank task DAG:
   nodes are task execution intervals (joined with their queue-wait
   spans by object id), intra-rank edges come from ``dep_edge`` events,
   and cross-rank edges from ``comm_send`` -> ``dep_deliver`` pairs
   matched on the frame correlation id (with the arrival timestamp as
   the edge's delivery time).
3. :func:`critical_path` walks backward from the last-finishing task,
   at each step following the *last-arriving input* — the predecessor
   whose completion (or whose frame's delivery) actually gated the
   task's start.
4. :func:`attribute` decomposes the makespan along that path into
   exec / queue / comm / idle buckets; by construction the buckets sum
   to the measured makespan (clamping only absorbs residual clock
   noise), which is the property the 2-rank acceptance test checks.

CLI::

    python -m parsec_tpu_torch.prof.critpath rank0.ptt rank1.ptt [--json]

Deliberate difference from the JAX package: it walks the pandas-free
reader's row dicts (prof/reader.py) where the JAX package walks
DataFrames; every step computes the same values.  A distributed run's
traces carry the comm layer's events and clock table (prof/causal.py),
which the cross-rank merge and flow matching read.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from parsec_tpu_torch.prof.causal import SPECIAL_CLASSES

#: event classes that are causal metadata, not task execution — ONE
#: source of truth (the tracer that writes them; the device module's
#: host stages ``mgr.*``/``fin.*`` among them)
_SPECIAL = set(SPECIAL_CLASSES)


def _is_exec_name(name: str) -> bool:
    """A task's execution span.  ``dev:<class>`` spans are not: they are
    the task's launch step on the card (CUDA timing events, shared by a
    fused wave's tasks), beside the task's own exec span, which for a
    device task runs from its submit to its eager completion."""
    return name not in _SPECIAL and not name.startswith("dev:")


def _rank_of(meta: dict) -> Optional[int]:
    try:
        return int(meta["info"]["rank"])
    except (KeyError, TypeError, ValueError):
        return None


def _offsets_of(meta: dict) -> Dict[int, float]:
    raw = meta.get("info", {}).get("clock_offsets")
    if not raw:
        return {}
    try:
        return {int(r): float(o) for r, o in json.loads(raw).items()}
    except (TypeError, ValueError):
        return {}


def merge_traces(paths: List[str]):
    """Load per-rank ``.ptt`` traces, align clocks, return
    ``(rows, metas)`` — one list of event rows, each with a ``rank``
    column, timestamps on the reference (lowest-rank) timeline.

    Alignment: for rank r, prefer r's own measured offset to the
    reference (``offset = clock_ref - clock_r`` -> ``ts + offset``);
    fall back to the reference's measurement of r (negated); traces
    from the same host share CLOCK_MONOTONIC, so a missing table
    degrades to zero shift, not garbage."""
    from parsec_tpu_torch.prof.reader import read_trace
    loaded = []
    for p in paths:
        meta, rows = read_trace(p)
        loaded.append([_rank_of(meta), meta, rows])
    # traces without a rank header (task-profiler-only dumps) or with
    # colliding rank claims still get DISTINCT rank ids: every profile
    # numbers event_ids from 1, so merging two files under one rank
    # would falsely pair START/END rows across them
    taken = {r for r, _m, _d in loaded if r is not None}
    spare = (r for r in range(len(loaded) + len(taken) + 1)
             if r not in taken)
    seen: set = set()
    for ent in loaded:
        if ent[0] is None or ent[0] in seen:
            ent[0] = next(spare)
        seen.add(ent[0])
    loaded.sort(key=lambda e: e[0])
    ref = loaded[0][0]
    ref_offsets = _offsets_of(loaded[0][1])
    merged: List[dict] = []
    metas = {}
    for rank, meta, rows in loaded:
        metas[rank] = meta
        shift = 0.0
        if rank != ref:
            own = _offsets_of(meta)
            if ref in own:
                shift = own[ref]
            elif rank in ref_offsets:
                shift = -ref_offsets[rank]
        for r in rows:
            r = dict(r)
            r["rank"] = rank
            if shift:
                r["ts"] = r["ts"] + shift
            merged.append(r)
    return merged, metas


def _named(rows: List[dict], name: str) -> List[dict]:
    return [r for r in rows if r["name"] == name]


def build_dag(rows: List[dict]):
    """Reconstruct the weighted cross-rank DAG from merged rows.

    Returns ``(tasks, preds, ready)``, all keyed by node identity
    (rank, taskpool_id, oid) — the taskpool matters: two pools' tasks
    legitimately share key hashes (a warmup pool rerunning the same
    task names), and colliding them would fabricate causal edges:

    - ``tasks``: node -> {name, rank, oid, start, end}
    - ``preds``: node -> list of (pred node, edge) where edge is None
      for a local dep or {"send", "arrive", "nbytes"} for a cross-rank
      flow edge
    - ``ready``: node -> queue-wait begin timestamp
    """
    from parsec_tpu_torch.prof.reader import intervals
    tasks: Dict[Tuple[int, int, int], dict] = {}
    ready: Dict[Tuple[int, int, int], float] = {}
    preds: Dict[Tuple[int, int, int], List] = {}
    for row in intervals(rows):
        node = (int(row["rank"]), int(row["taskpool_id"]),
                int(row["object_id"]))
        if row["name"] == "queue_wait":
            # several readiness episodes (AGAIN loops): keep the last
            ready[node] = max(ready.get(node, 0.0),
                              float(row["ts_begin"]))
        elif _is_exec_name(row["name"]):
            cur = tasks.get(node)
            if cur is None or row["ts_end"] > cur["end"]:
                tasks[node] = {"name": row["name"], "rank": node[0],
                               "tp": node[1], "oid": node[2],
                               "start": float(row["ts_begin"]),
                               "end": float(row["ts_end"])}
    # local dependency edges (producer and successor share the pool)
    for row in _named(rows, "dep_edge"):
        info = row["info"] or {}
        dst = info.get("dst")
        if dst is None:
            continue
        rank, tpid = int(row["rank"]), int(row["taskpool_id"])
        preds.setdefault((rank, tpid, int(dst)), []).append(
            ((rank, tpid, int(row["object_id"])), None))
    # cross-rank flow edges: comm_send matched to dep_deliver by corr
    sends: Dict[Tuple[int, int], Any] = {}
    for row in _named(rows, "comm_send"):
        info = row["info"] or {}
        corr = info.get("corr")
        if corr is not None:
            sends[tuple(corr)] = row
    for row in _named(rows, "dep_deliver"):
        info = row["info"] or {}
        corr = info.get("corr")
        snd = sends.get(tuple(corr)) if corr is not None else None
        if snd is None or not snd["object_id"]:
            continue
        sinfo = snd["info"] or {}
        edge = {"send": float(snd["ts"]), "arrive": float(row["ts"]),
                "nbytes": sinfo.get("nbytes", 0)}
        # a tree-forwarded frame is SENT by an intermediate rank but its
        # oid names the producer's task (whose exec interval lives in
        # the producer's trace, with the producer's per-process hash):
        # the edge's source is src_rank (the activation root) when the
        # frame carries one
        src_rank = sinfo.get("src_rank", int(snd["rank"]))
        preds.setdefault(
            (int(row["rank"]), int(row["taskpool_id"]),
             int(row["object_id"])), []).append(
            ((int(src_rank), int(snd["taskpool_id"]),
              int(snd["object_id"])), edge))
    return tasks, preds, ready


def matched_flows(rows: List[dict]) -> Tuple[int, int, int]:
    """(sends, recvs, matched-corr pairs) of comm frames in a merged
    trace — the 'every activation's send has its recv' check."""
    s = {tuple(r["info"]["corr"]) for r in _named(rows, "comm_send")
         if r["info"] and r["info"].get("corr")}
    r = {tuple(x["info"]["corr"]) for x in _named(rows, "comm_recv")
         if x["info"] and x["info"].get("corr")}
    return len(s), len(r), len(s & r)


def critical_path(tasks, preds):
    """The causal chain ending at the last-finishing task: step
    backward choosing, at each node, the predecessor whose completion
    (local) or frame delivery (remote) arrived LAST — the input that
    actually gated the start (queue-ready times enter at the
    attribution stage, not here).  Returns [(node_dict, in_edge), ...]
    in execution order; the first element's in_edge is None."""
    if not tasks:
        return []
    cur = max(tasks, key=lambda n: tasks[n]["end"])
    path = []
    seen = set()
    while cur is not None and cur not in seen:
        seen.add(cur)
        best, best_t, best_edge = None, None, None
        for pred, edge in preds.get(cur, ()):
            if pred not in tasks or pred in seen:
                continue
            t = edge["arrive"] if edge is not None else tasks[pred]["end"]
            if best_t is None or t > best_t:
                best, best_t, best_edge = pred, t, edge
        # each node pairs with its IN-edge — the input that gated it
        path.append((tasks[cur], best_edge if best is not None else None))
        cur = best
    path.reverse()
    return path


def attribute(path, tasks, ready) -> Dict[str, Any]:
    """Decompose the trace's makespan into exec / queue / comm / idle
    along the critical path.  Segments are clamped non-negative (clock
    noise); ``coverage`` reports sum(buckets)/makespan.

    ``overlap`` (not in the JAX package's result) is how far the path's
    steps overlap: for each step, the time its predecessor's exec span
    runs on past the step's ready time.  An async (device) task's exec
    span ends at its completion, after it has released its successors,
    so the buckets sum to the makespan plus exactly this overlap (the
    telescoping sum below)."""
    if not tasks:
        return {"makespan": 0.0, "buckets": {}, "path": [],
                "coverage": 0.0, "overlap": 0.0}
    t0 = min(t["start"] for t in tasks.values())
    tend = max(t["end"] for t in tasks.values())
    makespan = tend - t0
    buckets = {"exec": 0.0, "queue": 0.0, "comm": 0.0, "idle": 0.0}
    steps = []
    prev = None
    overlap = 0.0
    for node, edge in path:
        key = (node["rank"], node["tp"], node["oid"])
        rdy = ready.get(key, node["start"])
        rdy = min(max(rdy, t0), node["start"])
        if prev is None:
            base = t0
        else:
            base = min(prev["end"], rdy)
            overlap += max(0.0, prev["end"] - rdy)
        if edge is not None:
            arrive = min(max(edge["arrive"], base), rdy)
            buckets["comm"] += arrive - base
            buckets["idle"] += rdy - arrive
        else:
            buckets["idle"] += rdy - base
        buckets["queue"] += node["start"] - rdy
        buckets["exec"] += node["end"] - node["start"]
        steps.append({"task": node["name"], "rank": node["rank"],
                      "start": node["start"] - t0,
                      "end": node["end"] - t0,
                      "via": "comm" if edge is not None else "local"})
        prev = node
    total = sum(buckets.values())
    return {"makespan": makespan,
            "buckets": {k: round(v, 6) for k, v in buckets.items()},
            "coverage": round(total / makespan, 4) if makespan else 0.0,
            "overlap": round(overlap, 6),
            "ntasks": len(tasks),
            "path": steps}


def attribution(paths: List[str]) -> Dict[str, Any]:
    """One call from trace files to the attribution summary."""
    rows, metas = merge_traces(paths)
    tasks, preds, ready = build_dag(rows)
    path = critical_path(tasks, preds)
    out = attribute(path, tasks, ready)
    s, r, m = matched_flows(rows)
    out["flows"] = {"sends": s, "recvs": r, "matched": m}
    out["nranks"] = len(metas)
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="merge per-rank .ptt traces, extract the critical "
                    "path, attribute the makespan")
    ap.add_argument("traces", nargs="+", help="one .ptt per rank")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as one JSON object")
    args = ap.parse_args(argv)
    out = attribution(args.traces)
    if args.json:
        print(json.dumps(out))
        return 0
    b = out["buckets"]
    ms = out["makespan"]
    print(f"makespan: {ms * 1e3:.3f} ms over {out['nranks']} rank(s), "
          f"{out['ntasks']} tasks "
          f"(bucket coverage {out['coverage']:.1%})")
    for k in ("exec", "queue", "comm", "idle"):
        v = b.get(k, 0.0)
        share = v / ms if ms else 0.0
        print(f"  {k:>5}: {v * 1e3:9.3f} ms  ({share:6.1%})")
    f = out["flows"]
    print(f"flow edges: {f['matched']} matched of {f['sends']} sends / "
          f"{f['recvs']} recvs")
    print("critical path:")
    for s in out["path"]:
        print(f"  [{s['via']:>5}] rank {s['rank']} {s['task']:<24} "
              f"{s['start'] * 1e3:9.3f} -> {s['end'] * 1e3:9.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
