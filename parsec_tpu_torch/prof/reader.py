"""Trace reader: .ptt files -> rows of events.

Rebuild of the reference's trace tooling (reference: tools/profiling/
dbpreader.c + python/pbt2ptt.pyx + parsec_trace_tables.py — binary trace
to tables with one row per event, interval events paired into
begin/end rows).  ``read_trace`` returns (meta, rows), one dict per event
with the columns stream, key, name, flags, taskpool_id, event_id,
object_id, ts, info; ``intervals`` pairs START/END rows into one row per
executed task with a duration.

Deliberate difference from the JAX package, whose reader builds
``pandas.DataFrame``s: the port's rows are plain dicts under the same
column names (the card host has no pandas, and the port needs none).
``intervals`` pairs the same events the DataFrame merge pairs.

The reader is FORWARD-TOLERANT: event classes it has never seen (new
tracer modules add them every round), dictionary entries carrying extra
fields, and point events interleaved with intervals all pass through —
an analysis tool built on an older dictionary must degrade to "unknown
class", not crash.
"""

from __future__ import annotations

import pickle
import struct
from typing import Dict, List, Optional, Tuple

from parsec_tpu_torch.prof.profiling import EV_END, EV_START, MAGIC, _EV


def read_trace(path: str) -> Tuple[dict, List[dict]]:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != MAGIC:
        raise ValueError(f"{path}: not a parsec_tpu trace")
    off = 8
    (mlen,) = struct.unpack_from("!Q", raw, off)
    off += 8
    meta = pickle.loads(raw[off:off + mlen])
    off += mlen
    # dictionary entries are (key, name, attrs) today; tolerate future
    # fields riding along (and, defensively, attr-less pairs)
    key_names = {}
    for entry in meta.get("dictionary", ()):
        if len(entry) >= 2:
            key_names[entry[0]] = entry[1]
    rows = []
    for stream_id, name, nev in meta["streams"]:
        events = []
        for _ in range(nev):
            events.append(_EV.unpack_from(raw, off))
            off += _EV.size
        (ilen,) = struct.unpack_from("!Q", raw, off)
        off += 8
        infos = pickle.loads(raw[off:off + ilen])
        off += ilen
        for i, (key, flags, tp, eid, oid, ts) in enumerate(events):
            rows.append({
                "stream": stream_id, "key": key,
                "name": key_names.get(key, f"key{key}"),
                "flags": flags, "taskpool_id": tp, "event_id": eid,
                "object_id": oid, "ts": ts, "info": infos.get(i),
            })
    return meta, rows


def wall_ns(meta: dict, ts: float) -> Optional[int]:
    """The wall-clock ns (``time.time_ns()``, the clock of a
    ``torch.profiler`` trace) of the timestamp ``ts`` of a trace whose
    header carries a clock anchor (prof/profiling.py
    ``set_clock_anchor``); None without one."""
    anchor = meta.get("clock_anchor")
    if not anchor:
        return None
    pc, ns = anchor
    return ns + round((ts - pc) * 1e9)


def intervals(rows: List[dict]) -> List[dict]:
    """Pair START/END events into one row per interval with duration: the
    START row's columns, its ``ts`` as ``ts_begin``, the END's as
    ``ts_end``, and ``duration``.

    Pairing is by event id — and by ``rank`` too when the rows carry one
    (merged multi-rank traces: each rank's profile numbers its events
    independently, so cross-rank id collisions must not pair).  Like the
    JAX package's inner merge, a START pairs with every END of its key,
    in the order of the START rows."""
    by_rank = bool(rows) and "rank" in rows[0]

    def key(r):
        return (r["rank"], r["event_id"]) if by_rank else r["event_id"]

    ends: Dict[object, List[float]] = {}
    for r in rows:
        if r["flags"] & EV_END:
            ends.setdefault(key(r), []).append(r["ts"])
    out = []
    for r in rows:
        if not r["flags"] & EV_START:
            continue
        for ts_end in ends.get(key(r), ()):
            row = {k: v for k, v in r.items() if k != "ts"}
            row["ts_begin"] = r["ts"]
            row["ts_end"] = ts_end
            row["duration"] = ts_end - r["ts"]
            out.append(row)
    return out
