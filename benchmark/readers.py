"""What a run observed, and the readings the metric files take from it.

Each file ``benchmark/metrics/<metric>.py`` defines ``read(obs)``, most of
them as one of the functions here.  A reader that finds nothing to read
returns None, and the harness leaves that metric out of the line.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from benchmark import trace as tr
from benchmark import work

#: the kernels that are the port's own, by name (a data file of the
#: kernel metrics)
KERNELS_FILE = Path(__file__).resolve().parent / "metrics" / "k1_kernels.json"


@dataclass
class Observation:
    """One run: its set-up, its window, and (``--trace 1``) its counters,
    clock samples and traced passes."""
    problem: object
    setup_s: float
    rate_flops: float = 0.0          # useful flops / s over the window
    #: deltas over the window, summed over the cell's device modules: each
    #: module's ``DeviceStats`` counters (executed_tasks, fused_launches,
    #: fused_tasks, bytes_in, ...), and with two modules or more the ICI
    #: engine's (``ici.puts``, ``ici.put_bytes``, ``ici.bcasts``, ...)
    counters: Dict[str, float] = field(default_factory=dict)
    #: the modules' ``DeviceStats`` deltas over the window, by card
    counters_by_card: List[Dict[str, float]] = field(default_factory=list)
    smi_mhz: List[float] = field(default_factory=list)
    trace: Optional[tr.TraceSummary] = None
    peaks: Dict[str, float] = field(default_factory=dict)


def kernel_names() -> Dict[str, List[str]]:
    with open(KERNELS_FILE) as f:
        return json.load(f)


def _matches(name: str, parts: List[str]) -> bool:
    return any(p in name for p in parts)


# -- end to end ---------------------------------------------------------------

def window_tflops(obs: Observation) -> Optional[float]:
    return obs.rate_flops / 1e12 if obs.rate_flops > 0 else None


def setup_seconds(obs: Observation) -> Optional[float]:
    return obs.setup_s


# -- device module (window counters) -----------------------------------------

def wave_width(obs: Observation) -> Optional[float]:
    """Tasks per launch step over the window: a fused wave is one step, any
    other task a step of its own."""
    c = obs.counters
    tasks = c.get("executed_tasks", 0)
    if not tasks:
        return None
    return tasks / (c["fused_launches"] + tasks - c["fused_tasks"])


def sm_clock_mhz(obs: Observation) -> Optional[float]:
    """The mean of the SM clock readings sampled beside the traced passes,
    every card's."""
    return sum(obs.smi_mhz) / len(obs.smi_mhz) if obs.smi_mhz else None


# -- device (traced passes) ---------------------------------------------------

def device_idle(obs: Observation) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or fill ran
    on a card, in percent: the mean over the cell's cards."""
    t = obs.trace
    if t is None or not t.busy:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def library_share(obs: Observation) -> Optional[float]:
    """The share of the cards' busy time covered by kernels that are not
    the port's own (K1, K2), in percent: each card's union of them, summed
    over the cards, over the sum of the cards' busy time."""
    t = obs.trace
    if t is None or not t.busy:
        return None
    own = kernel_names()["own"]
    lib = sum(tr.total(tr.clip(tr.merge((s, s + d) for n, s, d in c.kernels
                                        if not _matches(n, own)), t.t0, t.t1))
              for c in t.cards.values())
    return 100.0 * lib * 1e-6 / sum(t.busy_s_by_card)


def k1_roofline(obs: Observation) -> Optional[float]:
    """The least time the traced passes' K1 tasks need (their useful flops
    over the card's peak, or their bytes over its bandwidth, whichever is
    larger) over K1's device time in the trace, in percent."""
    t = obs.trace
    if t is None:
        return None
    k1 = kernel_names()["k1"]
    k1_s = sum(d for n, _, d in t.kernels if _matches(n, k1)) * 1e-6
    if k1_s <= 0:
        return None
    p = obs.problem
    flops = nbytes = 0.0
    for cls, count in p.k1_tasks_per_pass().items():
        f, b = p.k1_work(cls)
        flops += f * count * t.passes
        nbytes += b * count * t.passes
    least, _ = work.least_seconds(flops, nbytes,
                                  obs.peaks[p.k1_dtype], obs.peaks["bytes"])
    return 100.0 * least / k1_s
