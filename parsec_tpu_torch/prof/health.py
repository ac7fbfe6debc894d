"""Predictive health plane: continuous per-rank health scoring.

Every raw observability plane already exists — live attribution
(prof/liveattr.py), the protocol journal (prof/journal.py), per-peer
comm EWMAs (RemoteDepEngine.stats), heartbeat arrival tracking
(comm/engine.py hb_stats), the C chain's bailout counters — but
nothing consumes them continuously.  This module fuses them into ONE
number per rank: a health score in [0, 1] (1.0 = healthy), EWMA
smoothed, with a trend estimate and a bounded time-series, so the
serving fabric can drain a DEGRADING rank before the heartbeat
detector declares it dead.

Discipline (the same PAPI-SDE pattern as liveattr's comm bucket): the
monitor adds ZERO hot-path crossings.  Every signal below is a counter
or EWMA some other plane already maintains; :meth:`HealthMonitor.refresh`
reads them at SCRAPE time (rate-limited to ``health_interval_s``) and
folds penalties into per-rank scores:

* **self signals** (this rank's own degradation): straggler-counter
  growth and per-(job, class) sojourn drift (EWMA vs long-run mean)
  from the live attribution records; native-chain bailout-rate
  regressions (``load_schedext().bailout_stats``); transport
  backpressure growth (ring-full stalls, partial writes, eager
  downshifts); and unresolved recovery rounds / degraded retirements
  in the journal tail;
* **peer signals** (a peer degrading as seen from here): heartbeat
  inter-arrival inflation + jitter against the learned cadence
  baseline (``CommEngine.hb_stats``), current silence age as a
  fraction of ``comm_peer_timeout_s``, and per-peer comm-delay
  inflation (clock-probe rtt/2 + drain EWMA) against its baseline.

Export rides the existing surfaces only: ``parsec_rank_health{rank}``
gauges through RuntimeMetrics.samples, a ``__health__`` section record
on the TAG_METRICS pull (zero new wire tags — the liveattr section
precedent), a ``health`` block in the ``{"op": "status"}`` document
(:func:`merge_health` folds per-rank sections pessimistically), state
transitions in the protocol journal (``health_transition``), and
time-series snapshots in flight-recorder incident bundles.  The loop
is closed in service/fabric.py: quotes inflate against the gang's
minimum health, and a sustained below-threshold score triggers a
journaled pre-emptive drain audited by tools/journal_audit.py (H1).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from parsec_tpu_torch.prof.metrics import counter_sample, gauge_sample
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose

params.register("health_enable", 1,
                "arm the predictive health plane on the metrics "
                "registry: per-rank 0..1 scores fused at scrape time "
                "from the straggler/journal/comm/bailout counters the "
                "other planes already maintain (0 disables)")
params.register("health_interval_s", 1.0,
                "minimum seconds between health folds: every scrape "
                "or fabric tick inside the window reuses the last "
                "fold (bounds the scrape-side cost)")
params.register("health_series", 120,
                "bounded per-rank score time-series length (the "
                "flight-recorder snapshot and drain evidence window)")
params.register("health_alpha", 0.3,
                "EWMA fold factor of the per-rank health score")
params.register("health_degraded", 0.75,
                "smoothed score below this enters state 'degraded'")
params.register("health_critical", 0.5,
                "smoothed score below this enters state 'critical' — "
                "the fabric's pre-emptive drain threshold")
params.register("health_hysteresis", 0.05,
                "margin above a threshold required to move back UP a "
                "state (flap damping on the transition journal)")


class _RankHealth:
    """Mutable per-rank scoring state (guarded-by: monitor lock)."""

    __slots__ = ("rank", "score", "ewma", "trend", "state", "since",
                 "series", "n")

    def __init__(self, rank: int, cap: int, now: float):
        self.rank = rank
        self.score = 1.0
        self.ewma = 1.0
        self.trend = 0.0
        self.state = "ok"
        self.since = now
        self.series: deque = deque(maxlen=cap)
        self.n = 0


def _clamp(x: float, lo: float = 0.0, hi: float = 1.0) -> float:
    return lo if x < lo else hi if x > hi else x


class HealthMonitor:
    """Scrape-time fusion of the existing observability planes into
    per-rank health scores.  Created by RuntimeMetrics.install (the
    liveattr precedent); every accessor is safe against a partially
    torn-down context — a broken signal source degrades that penalty
    to zero, never the scrape."""

    def __init__(self, metrics, clock=time.monotonic):
        self._metrics = metrics
        #: the monitor's clock (rate limit, state ages, series stamps).
        #: A deliberate difference from the JAX package, which reads
        #: time.monotonic directly: an injected clock lets a test drive
        #: the rate limit without resting on wall time
        self._clock = clock
        self._lock = threading.Lock()
        self._interval = float(params.get("health_interval_s", 1.0))
        self._alpha = float(params.get("health_alpha", 0.3))
        self._cap = max(8, int(params.get("health_series", 120)))
        self._thr_deg = float(params.get("health_degraded", 0.75))
        self._thr_crit = float(params.get("health_critical", 0.5))
        self._hyst = float(params.get("health_hysteresis", 0.05))
        self._ranks: Dict[int, _RankHealth] = {}
        self._last_fold = 0.0
        #: counter baselines (self signals fold as window deltas)
        self._strag_base = 0.0
        self._bail_base: Optional[float] = None
        self._bail_rate = 0.0
        self._bp_base: Optional[float] = None
        #: per-peer learned baselines (min-tracked: the healthy floor)
        self._hb_base: Dict[int, float] = {}
        self._delay_base: Dict[int, float] = {}
        self.folds = 0
        self.transitions = 0

    # -- signal reads (each best-effort, scrape time only) ---------------

    def _context(self):
        return getattr(self._metrics, "context", None)

    def _pen_stragglers(self) -> float:
        """Straggler-counter growth this window (liveattr counts)."""
        la = getattr(self._metrics, "_la", None)
        if la is None:
            return 0.0
        try:
            with la._lock:  # lint: ignore[PCL-HOT] (scrape-side read of liveattr's counters, rate-limited by health_interval_s)
                total = float(sum(la._strag_counts.values()))
        except Exception:
            return 0.0
        delta = max(0.0, total - self._strag_base)
        self._strag_base = total
        return _clamp(0.08 * delta, 0.0, 0.35)

    def _pen_sojourn_drift(self) -> float:
        """Per-(job, class) sojourn EWMA drifting above its own
        long-run mean — slowdown without (yet) any straggler event."""
        la = getattr(self._metrics, "_la", None)
        if la is None:
            return 0.0
        worst = 0.0
        try:
            with la._lock:  # lint: ignore[PCL-HOT] (scrape-side walk of liveattr's records, rate-limited)
                recs = list(la._recs.values())
            for rec in recs:
                with rec.lock:  # lint: ignore[PCL-HOT] (per-record scrape-side read, bounded by (job, class) count)
                    p = rec.lat
                    if p.n < 32 or p.sum <= 0.0:
                        continue
                    mean = p.sum / p.n
                    if mean > 0.0:
                        worst = max(worst, p.ewma / mean - 1.0)
        except Exception:
            return 0.0
        return _clamp(0.15 * max(0.0, worst - 0.5), 0.0, 0.3)

    def _pen_bailouts(self) -> float:
        """Native-chain bailout RATE regression: a steady bailout mix
        is the workload's shape; a step-up means classes started
        falling off the C chain."""
        try:
            from parsec_tpu_torch.native import load_schedext
            se = load_schedext()
            if se is None:
                return 0.0
            total = float(sum(se.bailout_stats().values()))
        except Exception:
            return 0.0
        if self._bail_base is None:
            self._bail_base = total
            return 0.0
        delta = max(0.0, total - self._bail_base)
        self._bail_base = total
        prev = self._bail_rate
        self._bail_rate += 0.3 * (delta - self._bail_rate)
        if prev <= 0.0:
            return 0.0
        return _clamp(0.05 * max(0.0, delta / prev - 2.0), 0.0, 0.2)

    def _pen_backpressure(self, st: Dict[str, Any]) -> float:
        """Transport backpressure growth: ring-full stalls, partial
        writes, protocol eager downshifts."""
        total = 0.0
        for k in ("shm_ring_full_stalls", "partial_writes",
                  "eager_downshift"):
            try:
                total += float(st.get(k, 0) or 0)
            except Exception:
                pass
        if self._bp_base is None:
            self._bp_base = total
            return 0.0
        delta = max(0.0, total - self._bp_base)
        self._bp_base = total
        return _clamp(0.02 * delta, 0.0, 0.25)

    def _pen_journal(self) -> float:
        """Unresolved recovery rounds / degraded retirements in the
        journal tail: a rank mid-recovery is not a healthy rank."""
        ctx = self._context()
        jr = getattr(ctx, "journal", None) if ctx is not None else None
        if jr is None:
            return 0.0
        pen = 0.0
        try:
            open_rec = 0
            for ev in jr.tail(256):
                e = ev.get("e")
                if e == "recovery_start":
                    open_rec += 1
                elif e == "recovery_done":
                    open_rec = max(0, open_rec - 1)
                elif e == "retire_degraded":
                    pen = max(pen, 0.1)
            if open_rec > 0:
                pen = max(pen, 0.25)
        except Exception:
            return 0.0
        return pen

    def _peer_penalties(self, st: Dict[str, Any],
                        timeout: float) -> Dict[int, float]:
        """Per-peer penalty fold from the comm engine's existing
        state: heartbeat gap inflation + jitter vs the learned
        cadence, silence age vs the death timeout, and comm-delay
        inflation vs the healthy floor."""
        ctx = self._context()
        comm = getattr(ctx, "comm", None) if ctx is not None else None
        ce = getattr(comm, "ce", None) if comm is not None else None
        pens: Dict[int, float] = {}
        if ce is None:
            return pens
        try:
            hb = ce.hb_stats()
        except Exception:
            hb = {}
        for r, s in hb.items():
            if int(s.get("n", 0)) < 3:
                continue
            ewma = float(s.get("ewma_s", 0.0))
            base = self._hb_base.get(r)
            base = ewma if base is None or ewma < base else base
            self._hb_base[r] = base
            pen = 0.0
            if base > 0.0:
                infl = ewma / base - 1.0
                pen += _clamp(0.6 * max(0.0, infl - 0.25), 0.0, 0.5)
                pen += _clamp(0.8 * (float(s.get("jitter_s", 0.0))
                                     / base - 0.25), 0.0, 0.3)
            if timeout > 0.0:
                frac = float(s.get("age_s", 0.0)) / timeout
                pen += _clamp(1.5 * max(0.0, frac - 0.2), 0.0, 0.6)
            pens[r] = pens.get(r, 0.0) + pen
        for r, d in (st.get("peer_comm_delay_s") or {}).items():
            try:
                r, d = int(r), float(d)
            except Exception:
                continue
            if d <= 0.0:
                continue
            base = self._delay_base.get(r)
            base = d if base is None or d < base else base
            self._delay_base[r] = base
            if base > 0.0:
                infl = d / base - 1.0
                pens[r] = pens.get(r, 0.0) + \
                    _clamp(0.1 * max(0.0, infl - 1.0), 0.0, 0.5)
        return pens

    # -- the fold ---------------------------------------------------------

    # lint: hot-path (fabric dispatcher tick + every scrape: PCL-HOT
    # keeps per-fold lock/allocation creep out of this chain)
    def refresh(self, force: bool = False) -> Dict[int, dict]:
        """One rate-limited fold; returns :meth:`snapshot`.  Callers
        are the metrics scrape and the fabric's dispatcher tick —
        never the task hot path."""
        now = self._clock()
        with self._lock:  # lint: ignore[PCL-HOT] (THE scrape-side monitor lock: one round-trip per rate-limited fold, not per task)
            if not force and now - self._last_fold < self._interval:
                return self._snapshot_locked(now)
            self._last_fold = now
            self._fold_locked(now)
            return self._snapshot_locked(now)

    # holds-lock: _lock
    def _fold_locked(self, now: float) -> None:
        ctx = self._context()
        rank = getattr(ctx, "rank", 0) if ctx is not None else 0
        comm = getattr(ctx, "comm", None) if ctx is not None else None
        st: Dict[str, Any] = {}
        if comm is not None:
            try:
                st = comm.stats()
            except Exception:
                st = {}
        timeout = float(params.get("comm_peer_timeout_s", 15.0))
        self_pen = (self._pen_stragglers() + self._pen_sojourn_drift()
                    + self._pen_bailouts() + self._pen_backpressure(st)
                    + self._pen_journal())
        scores = {rank: _clamp(1.0 - self_pen)}
        for r, pen in self._peer_penalties(st, timeout).items():
            if r != rank:
                scores[r] = _clamp(1.0 - pen)
        for r, score in scores.items():
            self._observe_locked(r, score, now)
        self.folds += 1

    # holds-lock: _lock
    def _observe_locked(self, r: int, score: float, now: float) -> None:
        rh = self._ranks.get(r)
        if rh is None:
            rh = self._ranks[r] = _RankHealth(r, self._cap, now)
        rh.score = score
        rh.ewma += self._alpha * (score - rh.ewma)
        rh.series.append((now, round(score, 4)))
        rh.n += 1
        pts = [s for _, s in list(rh.series)[-8:]]
        if len(pts) >= 4:
            half = len(pts) // 2
            rh.trend = round(sum(pts[half:]) / (len(pts) - half)
                             - sum(pts[:half]) / half, 4)
        else:
            rh.trend = 0.0
        new = self._state_for(rh)
        if new != rh.state:
            old, rh.state, rh.since = rh.state, new, now
            self.transitions += 1
            self._journal_transition(r, old, new, rh.ewma)

    def _state_for(self, rh: _RankHealth) -> str:
        e = rh.ewma
        if rh.state == "critical":
            # climb out only past the hysteresis margin
            if e >= self._thr_deg + self._hyst:
                return "ok"
            if e >= self._thr_crit + self._hyst:
                return "degraded"
            return "critical"
        if rh.state == "degraded":
            if e < self._thr_crit:
                return "critical"
            if e >= self._thr_deg + self._hyst:
                return "ok"
            return "degraded"
        if e < self._thr_crit:
            return "critical"
        if e < self._thr_deg:
            return "degraded"
        return "ok"

    def _journal_transition(self, r: int, old: str, new: str,
                            ewma: float) -> None:
        ctx = self._context()
        jr = getattr(ctx, "journal", None) if ctx is not None else None
        if jr is not None:
            jr.emit("health_transition", peer=r, frm=old, to=new,
                    score=round(ewma, 4))
        debug_verbose(2, "health: rank %d %s -> %s (score %.3f)",
                      r, old, new, ewma)

    # -- accessors --------------------------------------------------------

    # holds-lock: _lock
    def _snapshot_locked(self, now: float) -> Dict[int, dict]:
        return {r: {"score": round(rh.score, 4),
                    "ewma": round(rh.ewma, 4),
                    "trend": rh.trend,
                    "state": rh.state,
                    "since_s": round(now - rh.since, 3),
                    "n": rh.n}
                for r, rh in self._ranks.items()}

    def snapshot(self) -> Dict[int, dict]:
        """Current per-rank scoring state (no fold)."""
        with self._lock:
            return self._snapshot_locked(self._clock())

    def evidence(self, rank: int, k: int = 8) -> List[List[float]]:
        """The drain decision's evidence: the last ``k`` scored points
        of ``rank`` as ``[age_seconds, score]`` pairs (newest last).
        Journaled verbatim with every ``health_drain``."""
        now = self._clock()
        with self._lock:
            rh = self._ranks.get(rank)
            pts = list(rh.series)[-k:] if rh is not None else []
        return [[round(now - t, 3), s] for t, s in pts]

    def series_snapshot(self) -> Dict[int, List[List[float]]]:
        """Every rank's bounded score series (flight-recorder bundles);
        points are ``[age_seconds, score]``, newest last."""
        now = self._clock()
        with self._lock:
            return {r: [[round(now - t, 3), s] for t, s in rh.series]
                    for r, rh in self._ranks.items()}

    # lint: hot-path (scrape entry: rides every TAG_METRICS pull)
    def section(self) -> dict:
        """The per-rank wire form riding the TAG_METRICS pull (the
        liveattr section precedent: one extra sample record, zero new
        wire tags)."""
        ctx = self._context()
        now = self._clock()
        with self._lock:  # lint: ignore[PCL-HOT] (scrape-side snapshot lock, once per pull)
            return {"v": 1,
                    "rank": getattr(ctx, "rank", 0)
                    if ctx is not None else 0,
                    "scores": {str(r): {"score": round(rh.score, 4),
                                        "ewma": round(rh.ewma, 4),
                                        "trend": rh.trend,
                                        "state": rh.state,
                                        "since_s": round(now - rh.since,
                                                         3),
                                        "n": rh.n}
                               for r, rh in self._ranks.items()},
                    "folds": self.folds,
                    "transitions": self.transitions}

    # lint: hot-path (scrape entry: rides every /metrics exposition)
    def samples(self) -> List[dict]:
        """Prometheus-side additions (ride RuntimeMetrics.samples)."""
        out: List[dict] = []
        now = self._clock()
        with self._lock:  # lint: ignore[PCL-HOT] (scrape-side snapshot lock, once per scrape)
            for r, rh in self._ranks.items():
                out.append(gauge_sample("parsec_rank_health", rh.ewma,
                                        {"rank": str(r)}))
                out.append(gauge_sample("parsec_rank_health_trend",
                                        rh.trend, {"rank": str(r)}))
            out.append(counter_sample("parsec_health_transitions_total",
                                      self.transitions))
            out.append(counter_sample("parsec_health_folds_total",
                                      self.folds))
        del now
        return out


def merge_health(sections: Optional[Dict[int, dict]]) -> dict:
    """Fold per-rank ``__health__`` sections into one cluster view.
    Counts (folds / transitions) sum EXACTLY; per-rank scores merge
    PESSIMISTICALLY — the lowest smoothed score any rank observed
    wins, self-view or peer-view alike (a wedged rank's rosy
    self-report must not mask what its peers measure), with the
    observing rank recorded as ``src``.  Ranks whose section is
    absent (a mid-pull death, a disabled plane) are tolerated: they
    simply contribute nothing."""
    ranks: Dict[int, dict] = {}
    folds = 0
    transitions = 0
    for rank in sorted(sections or {}):
        sec = (sections or {}).get(rank) or {}
        folds += int(sec.get("folds", 0) or 0)
        transitions += int(sec.get("transitions", 0) or 0)
        src = int(sec.get("rank", rank))
        for tgt_s, ent in (sec.get("scores") or {}).items():
            try:
                tgt = int(tgt_s)
                ewma = float(ent.get("ewma", 1.0))
            except Exception:
                continue
            cur = ranks.get(tgt)
            if cur is None or ewma < cur["ewma"]:
                ranks[tgt] = {"score": float(ent.get("score", ewma)),
                              "ewma": ewma,
                              "trend": float(ent.get("trend", 0.0)),
                              "state": str(ent.get("state", "ok")),
                              "since_s": float(ent.get("since_s", 0.0)),
                              "n": int(ent.get("n", 0)),
                              "src": src}
    return {"ranks": ranks, "folds": folds, "transitions": transitions}
