"""Convert binary traces (.ptt) to Chrome trace-event JSON.

The interoperable-trace-format role of the reference's OTF2 backend
(reference: parsec/profiling_otf2.c): chrome://tracing and Perfetto open
the output directly.  Usage:

    python -m parsec_tpu_torch.tools.trace2chrome run.ptt -o run.json
    python -m parsec_tpu_torch.tools.trace2chrome --merge rank0.ptt \
        rank1.ptt -o run.json

``--merge`` takes one trace per rank, aligns their clocks with the
TAG_CLOCK offsets recorded in each header (prof/critpath.merge_traces),
and emits ONE timeline (pid = rank, tid = stream) with Perfetto flow
arrows linking every matched cross-rank activation's send event to its
recv event, plus the critical-path attribution summary in ``otherData``.

The port of the JAX package's tools/trace2chrome.py; it walks the
pandas-free reader's row dicts (prof/reader.py) where the JAX package
walks DataFrames, and writes the same events.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, List, Tuple

from parsec_tpu_torch.prof import critpath
from parsec_tpu_torch.prof.reader import intervals, read_trace


def _interval_events(ivs: List[dict], t0: float,
                     pid_of: Callable[[dict], int]) -> List[dict]:
    return [{
        "name": iv["name"],
        "cat": "task",
        "ph": "X",                      # complete event
        "ts": (float(iv["ts_begin"]) - t0) * 1e6,
        "dur": float(iv["duration"]) * 1e6,
        "pid": pid_of(iv),
        "tid": int(iv["stream"]),
        "args": {"event_id": int(iv["event_id"]),
                 "info": repr(iv["info"]) if iv["info"] is not None
                 else ""},
    } for iv in ivs]


def _flow_events(rows: List[dict], t0: float) -> Tuple[List[dict], int]:
    """Matched comm_send/comm_recv pairs -> anchor slices + s/f flow
    arrows (Perfetto binds an arrow to the slice enclosing each end)."""
    ends = {"comm_send": {}, "comm_recv": {}}
    for r in rows:
        if r["name"] in ends and r["info"] \
                and r["info"].get("corr") is not None:
            ends[r["name"]][tuple(r["info"]["corr"])] = r
    sends, recvs = ends["comm_send"], ends["comm_recv"]
    events = []
    arrows = 0
    for corr in sorted(set(sends) & set(recvs)):
        s, r = sends[corr], recvs[corr]
        fid = f"{corr[0]}:{corr[1]}"
        s_ts = (float(s["ts"]) - t0) * 1e6
        r_ts = (float(r["ts"]) - t0) * 1e6
        for row, ts, nm in ((s, s_ts, "comm_send"), (r, r_ts, "comm_recv")):
            info = row["info"] or {}
            events.append({
                "name": nm, "cat": "comm", "ph": "X",
                "ts": ts, "dur": 1,
                "pid": int(row["rank"]), "tid": int(row["stream"]),
                "args": {"corr": fid, "tag": info.get("tag"),
                         "nbytes": info.get("nbytes")},
            })
        events.append({"name": "activation", "cat": "comm", "ph": "s",
                       "id": fid, "pid": int(s["rank"]),
                       "tid": int(s["stream"]), "ts": s_ts})
        events.append({"name": "activation", "cat": "comm", "ph": "f",
                       "bp": "e", "id": fid, "pid": int(r["rank"]),
                       "tid": int(r["stream"]), "ts": max(r_ts, s_ts + 1)})
        arrows += 1
    return events, arrows


def merged_doc(paths: List[str]) -> Tuple[dict, int]:
    """The ``--merge`` document of per-rank traces, and its arrows."""
    rows, metas = critpath.merge_traces(paths)
    ivs = intervals(rows)
    t0 = float(min(r["ts"] for r in rows)) if rows else 0.0
    events = _interval_events(ivs, t0, lambda iv: int(iv["rank"]))
    flow, arrows = _flow_events(rows, t0)
    events.extend(flow)
    other = {"ranks": sorted(metas), "flow_arrows": arrows}
    try:
        tasks, preds, ready = critpath.build_dag(rows)
        path = critpath.critical_path(tasks, preds)
        other["attribution"] = critpath.attribute(path, tasks, ready)
    except Exception as exc:     # the timeline must still export
        other["attribution_error"] = str(exc)[:200]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}, arrows


def single_doc(path: str) -> dict:
    """The document of one trace: its intervals, pid = taskpool id."""
    meta, rows = read_trace(path)
    ivs = intervals(rows)
    events = []
    if ivs:
        t0 = float(min(iv["ts_begin"] for iv in ivs))
        events = _interval_events(ivs, t0, lambda iv: int(iv["taskpool_id"]))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"hr_id": meta["hr_id"], **meta.get("info", {})}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traces", nargs="+", help=".ptt trace file(s)")
    ap.add_argument("--merge", action="store_true",
                    help="merge per-rank traces into one clock-aligned "
                         "timeline with cross-rank flow arrows")
    ap.add_argument("-o", "--out", default=None,
                    help="output JSON (default: <trace>.json)")
    args = ap.parse_args(argv)
    if len(args.traces) > 1 and not args.merge:
        ap.error("several traces need --merge")
    out = args.out or (os.path.splitext(args.traces[0])[0] + ".json")

    if args.merge:
        doc, arrows = merged_doc(args.traces)
    else:
        doc = single_doc(args.traces[0])
    with open(out, "w") as f:
        json.dump(doc, f)
    print(f"{out}: {len(doc['traceEvents'])} events"
          + (f", {arrows} flow arrows" if args.merge else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
