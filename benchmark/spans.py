"""Per-layer readings from the program's own spans, on a traced pass's
``torch.profiler`` clock.

The program's causal tracer (``parsec_tpu_torch.prof.causal``, classes
``device`` and ``stages``) writes, per device task, a ``dev:<class>``
span (its launch step's time on the card, from CUDA timing events) and,
per launch step, the device manager's and completer's host stages
(``mgr.idle``, ``mgr.pop``, ``mgr.stage_in``, ``mgr.dispatch``,
``mgr.depth_wait``, ``fin.complete``, ``fin.finalize``), all stamped with
the host's ``perf_counter``.  The profile's header carries an anchor pair
(``perf_counter``, ``time.time_ns()``) that lays them onto the wall clock
of a chrome trace (``from_profile``).  Readers here take those spans, and
for ``idle_dag`` and ``gap_names`` the trace's summary too:

- ``trsm_share``: the union of TRSM's ``dev:`` intervals over the union
  of every ``dev:`` interval in the traced window, in percent;
- ``launch_us``: host microseconds of ``mgr.stage_in`` plus
  ``mgr.dispatch`` per task launched in the window;
- ``idle_dag``: the share of the traced window in which the trace shows
  the device idle while the device manager sat in ``mgr.idle`` (no ready
  device task), in percent;
- ``gap_names``: the trace's longest idle gaps named by the harness's
  stage and the innermost program span live at the gap's middle, e.g.
  ``bm.wait>mgr.idle``.

``python3 -m benchmark.spancheck`` runs a cell's traced passes with the
spans on and reads these; the harness does not read them yet.  A reader
returns None where the program wrote no such span (a program without
device spans), so the metric is left out of a result line.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark import trace as tr

#: the host stages whose time is the device module's launch path
LAUNCH_STAGES = ("mgr.stage_in", "mgr.dispatch")

Interval = Tuple[float, float]


@dataclass
class ProgramSpans:
    """The program's device spans and host stages on a trace's clock
    (microseconds after its ``baseTimeNanoseconds``)."""
    #: (task class, start, end, launch id, clock) per device task
    dev: List[Tuple[str, float, float, int, str]] = \
        field(default_factory=list)
    #: (stage name, start, end, launch id or task oid)
    stages: List[Tuple[str, float, float, int]] = field(default_factory=list)


def from_profile(meta: dict, rows: List[dict], base_ns: int
                 ) -> Optional[ProgramSpans]:
    """The spans of a program profile (``prof.reader.read_trace``'s meta
    and rows) on the clock of a chrome trace whose base is ``base_ns``;
    None where the header carries no clock anchor."""
    from parsec_tpu_torch.prof.causal import STAGE_CLASSES
    from parsec_tpu_torch.prof.reader import intervals, wall_ns
    if not meta.get("clock_anchor"):
        return None

    def us(ts: float) -> float:
        return (wall_ns(meta, ts) - base_ns) / 1e3

    out = ProgramSpans()
    for iv in intervals(rows):
        name = iv["name"]
        if name.startswith("dev:"):
            info = iv["info"] or {}
            out.dev.append((name[4:], us(iv["ts_begin"]), us(iv["ts_end"]),
                            int(info.get("lid", 0)),
                            str(info.get("clock", ""))))
        elif name in STAGE_CLASSES:
            out.stages.append((name, us(iv["ts_begin"]), us(iv["ts_end"]),
                               iv["object_id"]))
    return out


def _union(intervals, t0: float, t1: float) -> List[Interval]:
    return tr.clip(tr.merge(intervals), t0, t1)


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def trsm_share(spans: Optional[ProgramSpans], t0: float, t1: float,
               cls: str = "TRSM") -> Optional[float]:
    """The union of ``cls``'s device intervals over the union of all device
    intervals inside [t0, t1], in percent."""
    if spans is None:
        return None
    every = _union(((s, e) for _c, s, e, *_ in spans.dev), t0, t1)
    if not every:
        return None
    mine = _union(((s, e) for c, s, e, *_ in spans.dev if c == cls), t0, t1)
    return 100.0 * tr.total(mine) / tr.total(every)


def launch_us(spans: Optional[ProgramSpans], t0: float, t1: float
              ) -> Optional[float]:
    """Host microseconds of the launch path (``mgr.stage_in`` and
    ``mgr.dispatch``) per task launched, over the stages and the device
    tasks that start inside [t0, t1]."""
    if spans is None:
        return None
    tasks = sum(1 for _c, s, *_ in spans.dev if t0 <= s < t1)
    if not tasks:
        return None
    host = sum(e - s for n, s, e, _ in spans.stages
               if n in LAUNCH_STAGES and t0 <= s < t1)
    return host / tasks


def idle_dag(spans: Optional[ProgramSpans], summary) -> Optional[float]:
    """The share of the traced window in which the device ran nothing
    (the trace's gaps) while the device manager waited for work
    (``mgr.idle``), in percent."""
    if spans is None or summary is None:
        return None
    t0, t1 = summary.t0, summary.t1
    idle = _union(((s, e) for n, s, e, _ in spans.stages
                   if n == "mgr.idle"), t0, t1)
    if not any(n == "mgr.pop" for n, *_ in spans.stages):
        return None              # no host stages recorded
    gaps = tr.gaps(summary.busy, t0, t1)
    return 100.0 * tr.total(intersect(gaps, idle)) / (t1 - t0)


def innermost(spans: ProgramSpans, at: float) -> Optional[str]:
    """The shortest program span (device span or host stage) live at
    ``at``: its stage name, or ``dev:<class>``."""
    live = [(e - s, n) for n, s, e, _ in spans.stages if s <= at <= e]
    live += [(e - s, "dev:" + c) for c, s, e, *_ in spans.dev
             if s <= at <= e]
    return min(live)[1] if live else None


def gap_names(summary, spans: Optional[ProgramSpans], k: int = 10
              ) -> List[list]:
    """[name, seconds] of the longest idle gaps of the traced window, as
    ``trace.top_gaps`` gives them, each name followed by ``>`` and the
    innermost program span live at the gap's middle where one is."""
    idle = sorted(tr.gaps(summary.busy, summary.t0, summary.t1),
                  key=lambda g: g[0] - g[1])[:k]
    out = []
    for g in idle:
        name = tr.gap_name(g, summary.stages)
        inner = innermost(spans, (g[0] + g[1]) / 2) \
            if spans is not None else None
        out.append([name if inner is None else f"{name}>{inner}",
                    (g[1] - g[0]) * 1e-6])
    return out


def readings(spans: Optional[ProgramSpans], summary
             ) -> Dict[str, Optional[float]]:
    """The Cholesky cell's three per-layer readings over a traced window:
    ``trsm_share.potrf``, ``launch_us.potrf`` and ``idle_dag.potrf``."""
    t0, t1 = summary.t0, summary.t1
    return {"trsm_share.potrf": trsm_share(spans, t0, t1),
            "launch_us.potrf": launch_us(spans, t0, t1),
            "idle_dag.potrf": idle_dag(spans, summary)}
