"""The timed window: a closed loop with one problem in flight.

A pass is one problem solved (restore the operand, build the pool, add it,
wait, synchronize).  The window starts with the first pass after set-up
and ends with the last pass that started before ``seconds`` ran out; the
rate is the useful flops of every pass that completed without a failed
factor, over the whole window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Tuple


@dataclass
class Pass:
    start: float
    end: float
    failed: bool

    @property
    def seconds(self) -> float:
        return self.end - self.start


def run_window(one_pass: Callable[[], bool], seconds: float,
               clock: Callable[[], float] = time.perf_counter,
               min_passes: int = 1) -> List[Pass]:
    """Run passes until ``seconds`` have gone by since the first began;
    a pass that starts before then runs to its end.  ``one_pass`` returns
    True where the pass failed."""
    passes: List[Pass] = []
    t0 = clock()
    while True:
        s = clock()
        if len(passes) >= min_passes and s - t0 >= seconds:
            return passes
        failed = bool(one_pass())
        passes.append(Pass(s, clock(), failed))


def window_rate(passes: List[Pass], flops_per_pass: float
                ) -> Tuple[float, float, int]:
    """(useful flops per second, window seconds, passes completed
    without a failure) over the whole window."""
    if not passes:
        raise ValueError("an empty window has no rate")
    window = passes[-1].end - passes[0].start
    good = sum(1 for p in passes if not p.failed)
    return good * flops_per_pass / window, window, good


def check_peak(p: Pass, flops: float, peak_flops: float, chips: int = 1
               ) -> None:
    """A pass faster than the cell's ``chips`` cards at one card's peak
    each allow for its useful flops is a broken measurement: it fails the
    run (the port's ``_honest_dt``)."""
    floor = flops / (peak_flops * chips)
    if p.seconds < floor:
        raise RuntimeError(
            f"a pass took {p.seconds * 1e3:.3f} ms, under the "
            f"{floor * 1e3:.3f} ms the peak of {chips} card(s) allows for "
            f"its useful flops: the measurement is broken")
