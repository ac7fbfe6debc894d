"""Reduce a ``torch.profiler`` chrome trace of whole passes to device busy
time, kernel time by name and idle gaps named by the harness's spans.

The harness stamps each pass (``bm.pass``) and its stages (``bm.collect``,
``bm.restore``, ``bm.build_pool``, ``bm.add_taskpool``, ``bm.wait``,
``bm.synchronize``) with the host's wall clock, which is the clock the
profiler puts device activity on: a trace's ``ts`` is microseconds after
its ``baseTimeNanoseconds``.  The traced window runs from the first traced
pass's start to the last one's end.  The profiler records device activity
alone, so it adds no cost to the host's work.

Each device operation keeps its card (``card_of``).  A card's busy time is
the union of its own operations; over several cards the busy time is the
mean of theirs, so one less it over the window is the mean idle share, and
idle gaps are found card by card.  On one card every number is the union's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

PASS = "bm.pass"
STAGES = ("bm.collect", "bm.restore", "bm.build_pool", "bm.add_taskpool",
          "bm.wait", "bm.synchronize")
#: device activity: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[float, float]
#: (name, start, duration) of a device operation
Op = Tuple[str, float, float]


@dataclass
class CardTrace:
    """One card's part of the traced window."""
    #: (name, start, duration) of the card's kernels in the window
    kernels: List[Op] = field(default_factory=list)
    #: merged busy intervals of the card, clipped to the window
    busy: List[Interval] = field(default_factory=list)


@dataclass
class TraceSummary:
    t0: float
    t1: float
    passes: int
    #: (name, start, duration) of every kernel in the window, every card's
    kernels: List[Op] = field(default_factory=list)
    #: (name, start, duration) of every device operation in the window
    device_ops: List[Op] = field(default_factory=list)
    #: merged busy intervals of all cards together, clipped to the window
    busy: List[Interval] = field(default_factory=list)
    #: (stage name, start, end) of the harness's stage spans
    stages: List[Tuple[str, float, float]] = field(default_factory=list)
    #: each card of the run by its index, those that ran nothing included
    cards: Dict[int, CardTrace] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s_by_card(self) -> List[float]:
        """Each card's busy seconds, by card index."""
        return [total(self.cards[i].busy) * 1e-6 for i in sorted(self.cards)]

    @property
    def busy_s(self) -> float:
        """The mean of the cards' busy seconds."""
        by = self.busy_s_by_card
        return sum(by) / len(by) if by else 0.0


Span = Tuple[str, float, float]


def load(path: str) -> Tuple[list, int]:
    """(events, base time in ns) of a chrome trace file."""
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"], int(doc.get("baseTimeNanoseconds", 0))


def to_trace_clock(spans: Iterable[Tuple[str, int, int]], base_ns: int
                   ) -> List[Span]:
    """Host spans stamped in wall-clock ns, in the trace's microseconds."""
    return [(n, (s - base_ns) / 1e3, (e - base_ns) / 1e3)
            for n, s, e in spans]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: Iterable[Interval], t0: float, t1: float
         ) -> List[Interval]:
    return [(max(s, t0), min(e, t1)) for s, e in intervals
            if e > t0 and s < t1]


def total(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def gaps(busy: List[Interval], t0: float, t1: float) -> List[Interval]:
    """The idle intervals of the window between merged busy intervals."""
    out, at = [], t0
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if t1 > at:
        out.append((at, t1))
    return out


def card_of(event: dict) -> int:
    """The card a device operation of a chrome trace ran on: the profiler
    writes its index as ``args.device`` and as the event's ``pid``; a copy
    between two cards has no ``args.device``, and its ``pid`` is the card
    it copies from."""
    card = (event.get("args") or {}).get("device", event.get("pid", 0))
    return card if isinstance(card, int) else 0


def summarize(events: list, spans: List[Span], cards: int = 1
              ) -> TraceSummary:
    """The traced window: ``spans`` (the harness's ``bm.*`` stamps, in the
    trace's clock) over ``events`` (a chrome trace's event list), on the
    run's ``cards`` cards (0 to ``cards`` - 1)."""
    passes = [(s, e) for n, s, e in spans if n == PASS]
    if not passes:
        raise ValueError("no bm.pass span in the traced window")
    t0, t1 = min(s for s, _ in passes), max(e for _, e in passes)
    ops, kernels = [], []
    card_ops: Dict[int, List[Op]] = {i: [] for i in range(cards)}
    card_kernels: Dict[int, List[Op]] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        op = (str(e["name"]), float(e["ts"]), float(e.get("dur", 0.0)))
        if op[1] + op[2] > t0 and op[1] < t1:
            card = card_of(e)
            ops.append(op)
            card_ops.setdefault(card, []).append(op)
            if e["cat"] == "kernel":
                kernels.append(op)
                card_kernels.setdefault(card, []).append(op)
    return TraceSummary(
        t0=t0, t1=t1, passes=len(passes), kernels=kernels, device_ops=ops,
        busy=_busy(ops, t0, t1),
        stages=[sp for sp in spans if sp[0] in STAGES],
        cards={i: CardTrace(kernels=card_kernels.get(i, []),
                            busy=_busy(o, t0, t1))
               for i, o in sorted(card_ops.items())})


def _busy(ops: List[Op], t0: float, t1: float) -> List[Interval]:
    return clip(merge((s, s + d) for _, s, d in ops), t0, t1)


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)", "anon")
    for stop in ("(", "<"):
        cut = name.find(stop)
        if cut > 0:
            name = name[:cut]
    return name[:width]


def top_ops(summary: TraceSummary, k: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took most time,
    summed by short name."""
    by = {}
    for name, s, d in summary.device_ops:
        key = short_name(name)
        by[key] = by.get(key, 0.0) + d * 1e-6
    return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def gap_name(gap: Interval, stages: List[Tuple[str, float, float]]) -> str:
    """The stage span the host was in at the middle of ``gap``."""
    mid = (gap[0] + gap[1]) / 2
    inside = [(e - s, n) for n, s, e in stages if s <= mid <= e]
    return min(inside)[1] if inside else "bm.between_stages"


def top_gaps(summary: TraceSummary, k: int = 10) -> List[list]:
    """[stage, seconds] of the longest idle gaps of the window, found card
    by card; where more than one card ran, each name starts with its card
    (``cuda:<i> ``)."""
    idle = []
    for i, card in sorted(summary.cards.items()):
        prefix = f"cuda:{i} " if len(summary.cards) > 1 else ""
        idle += [(g, prefix) for g in gaps(card.busy, summary.t0, summary.t1)]
    idle = sorted(idle, key=lambda x: x[0][0] - x[0][1])[:k]
    return [[prefix + gap_name(g, summary.stages), (g[1] - g[0]) * 1e-6]
            for g, prefix in idle]
