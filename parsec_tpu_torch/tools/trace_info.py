"""Summarize a binary trace (.ptt) — the dbpinfos analog.

Reference: tools/profiling/dbpreader.c + dbpinfos — dump a trace's
header, dictionary, per-stream event counts, and per-event-class timing
statistics.  Usage:

    python -m parsec_tpu_torch.tools.trace_info run.ptt [--events]
        [--stats] [--gaps]

The port of the JAX package's tools/trace_info.py.  Deliberate
difference: the JAX package groups pandas DataFrames; the port groups
the pandas-free reader's row dicts (prof/reader.py) in plain Python (the
card host has no pandas).  The headings and the occupancy lines are the
JAX package's, word for word; the tables hold the same columns.

A ``dev:<class>`` row is a task's launch step ON THE CARD (CUDA timing
events, prof/causal.py), where the JAX package's is host time from
dispatch to completion: the tasks of a fused wave share one interval, so
the class's ``sum`` counts the wave once per task (its device time is
the union of the spans).  The device module's host stages (``mgr.*``,
``fin.*``, a tracer's ``stages`` class) appear as classes of their own
and on streams of their own, and join no task's queue-wait.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence

from parsec_tpu_torch.prof.causal import STAGE_CLASSES
from parsec_tpu_torch.prof.reader import intervals, read_trace


def _table(index: str, cols: Sequence[str],
           groups: Dict[str, List[float]]) -> str:
    """One line per group (sorted by name, as a groupby sorts) with the
    ``count`` and the float aggregates ``cols`` of its durations."""
    agg = {"sum": sum, "mean": lambda d: sum(d) / len(d), "min": min,
           "max": max}
    width = max([len(index)] + [len(n) for n in groups])
    lines = [" " * width + f"{'count':>8}"
             + "".join(f"{c:>12}" for c in cols), index]
    for name in sorted(groups):
        d = groups[name]
        lines.append(f"{name:<{width}}{len(d):>8}"
                     + "".join(f"{agg[c](d):>12.6f}" for c in cols))
    return "\n".join(lines)


def _causal_stats(meta: dict, rows: List[dict], ivs: List[dict]) -> None:
    """The --stats causal columns: per-class queue-wait (the causal
    tracer's ready->select spans joined to exec intervals by task
    identity) and per-source comm delay (comm_recv arrival minus the
    sender's embedded clock stamp, corrected by this rank's measured
    offset to that peer when the header carries one)."""
    qw: Dict[tuple, List[float]] = {}
    for iv in ivs:
        if iv["name"] == "queue_wait":
            qw.setdefault((iv["taskpool_id"], iv["object_id"]),
                          []).append(iv["duration"])
    # task identity is (taskpool, key hash): a warmup pool reruns the
    # same task keys, and an object_id-only join would pair its spans
    # with the main pool's
    waits: Dict[str, List[float]] = {}
    for iv in ivs:
        if iv["name"] == "queue_wait" or iv["name"].startswith("dev:") \
                or iv["name"] in STAGE_CLASSES:
            continue
        for d in qw.get((iv["taskpool_id"], iv["object_id"]), ()):
            waits.setdefault(iv["name"], []).append(d)
    if waits:
        print("per-class queue-wait (seconds, ready -> selected):")
        print(_table("name", ("mean", "max"), waits))
    rx = [r for r in rows if r["name"] == "comm_recv"]
    if not rx:
        return
    try:
        offsets = {int(r): float(o) for r, o in json.loads(
            meta.get("info", {}).get("clock_offsets", "{}")).items()}
    except (TypeError, ValueError):
        offsets = {}
    delays: Dict[int, List[float]] = {}
    for row in rx:
        info = row["info"] or {}
        sent, src = info.get("sent_at"), info.get("src")
        if sent is None or src is None:
            continue
        # sent_at is on the SENDER's clock; offset = clock_src -
        # clock_mine, so the local-clock send time is sent - offset
        delays.setdefault(src, []).append(
            row["ts"] - (sent - offsets.get(src, 0.0)))
    if delays:
        print("comm delay by source rank (seconds, send -> recv"
              + ("" if offsets else "; UNCORRECTED clocks") + "):")
        for src in sorted(delays):
            d = delays[src]
            print(f"  from rank {src}: n={len(d)} "
                  f"mean={sum(d) / len(d):.6f} "
                  f"max={max(d):.6f}")


def _occupancy(ivs: List[dict]) -> None:
    by_stream: Dict[int, list] = {}
    for iv in ivs:
        by_stream.setdefault(iv["stream"], []).append(
            (iv["ts_begin"], iv["ts_end"]))
    print("per-stream occupancy:")
    for sid in sorted(by_stream):
        spans = sorted(by_stream[sid])
        span = max(e for _b, e in spans) - spans[0][0]
        busy = sum(e - b for b, e in spans)
        gaps, largest, cursor = 0.0, 0.0, spans[0][0]
        for b, e in spans:
            if b > cursor:
                gaps += b - cursor
                largest = max(largest, b - cursor)
            cursor = max(cursor, e)
        util = busy / span if span > 0 else 1.0
        print(f"  stream {sid}: {len(spans)} intervals, "
              f"busy {busy:.6f}s / span {span:.6f}s "
              f"(util {util:.1%}), idle {gaps:.6f}s "
              f"(largest gap {largest:.6f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help=".ptt trace file")
    ap.add_argument("--events", action="store_true",
                    help="dump every event row")
    ap.add_argument("--stats", action="store_true",
                    help="per-class interval timing statistics")
    ap.add_argument("--gaps", action="store_true",
                    help="per-stream occupancy: busy/span/utilization and "
                         "idle-gap statistics (dbpinfos' occupancy view)")
    args = ap.parse_args(argv)

    meta, rows = read_trace(args.trace)

    print(f"trace: {args.trace}")
    print(f"hr_id: {meta['hr_id']}")
    for k, v in sorted(meta.get("info", {}).items()):
        print(f"info : {k} = {v}")
    print(f"dictionary ({len(meta['dictionary'])} classes):")
    for entry in meta["dictionary"]:
        # tolerate entries with extra (future) fields beyond
        # (key, name, attrs)
        key, name = entry[0], entry[1]
        attrs = entry[2] if len(entry) > 2 else ""
        print(f"  [{key:3d}] {name}{'  ' + str(attrs) if attrs else ''}")
    print(f"streams ({len(meta['streams'])}):")
    for sid, name, nev in meta["streams"]:
        print(f"  [{sid:3d}] {name or '<unnamed>'}: {nev} events")
    print(f"total events: {len(rows)}")

    if args.events and rows:
        cols = list(rows[0])
        print("  ".join(cols))
        for r in rows:
            print("  ".join(str(r[c]) for c in cols))
    ivs = intervals(rows) if (args.stats or args.gaps) else []
    if args.stats and ivs:
        durs: Dict[str, List[float]] = {}
        for iv in ivs:
            durs.setdefault(iv["name"], []).append(iv["duration"])
        print("per-class interval stats (seconds):")
        print(_table("name", ("sum", "mean", "min", "max"), durs))
        _causal_stats(meta, rows, ivs)
    if args.gaps and ivs:
        _occupancy(ivs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
