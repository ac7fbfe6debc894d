"""Live attribution plane: online critical-path attribution + stragglers.

The online half of the causal pipeline (reference: the PINS/PAPI-SDE
instrumentation operators read while a DAG runs; our offline half is
prof/critpath.py over merged ``.ptt`` dumps).  This module answers
"why is job 7 slow RIGHT NOW" without stopping anything:

* **per-(job, task-class) streaming latency profiles** — exact done
  counts plus sampled observations (count, EWMA, fixed log2 buckets,
  ring-reservoir p50/p95/p99) for the ready->complete sojourn, and —
  with the opt-in ``metrics_queue_wait`` select hook — separate
  queue-wait and execution profiles.  Everything rides the
  metrics hooks (``RuntimeMetrics._select``/``_complete``): NO new
  hot-path PINS crossings;
* **straggler detection** — a task whose sojourn (or queue wait)
  exceeds ``liveattr_straggler_mult`` x its class p99 (min-count
  guarded) emits a structured anomaly event, counts in
  ``parsec_stragglers_total{job,class,kind}``, and — rate-limited by
  ``liveattr_straggler_incident_s`` — fires the flight recorder so the
  incident bundle captures the straggler's causal neighborhood;
* **online makespan decomposition** — each job's elapsed time
  telescopes into exec / queue / comm / idle buckets: exec and queue
  from the class profiles (sampled mean x exact done count), comm from
  the per-peer comm-delay estimates folded at SCRAPE time out of
  ``RemoteDepEngine.stats()`` (clock-probe rtt/2 + drain-delay EWMA —
  no comm-layer hooks), idle as the telescoped remainder.  On a
  serial-chain workload (the traced rtt leg) the split converges to
  the offline ``critpath.attribute()`` answer; on wide DAGs the three
  measured buckets are proportionally clamped to the elapsed window
  (documented approximation — the buckets always sum to elapsed);
* **ETA** — remaining-task counts x live class profiles through the
  calibrated dagsim list-scheduling model (parallel/dagsim.py): the
  completion quote a predictive admission controller will reuse.

Cross-rank: each rank's engine serializes a ``section()`` dict that
rides the existing TAG_METRICS pull as one extra sample record (zero
new wire tags); :func:`merge_sections` folds them (exact counts and
buckets sum; quantiles re-derived from merged buckets) and
:func:`cluster_status` builds the ``{"op": "status"}`` / ``GET
/status`` document the JobServer serves (service/server.py) and
the JAX package's tools/live_view.py renders.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from parsec_tpu_torch.prof.metrics import (BUCKET_BOUNDS, _NBUCKETS,
                                     bucket_index, counter_sample)
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose

params.register("liveattr_enable", 1,
                "arm the online attribution engine on the metrics "
                "registry: per-(job, task-class) latency profiles, "
                "straggler detection, the live exec/queue/comm/idle "
                "split and the dagsim ETA behind the job server's "
                "status surface (0 disables; requires metrics_enabled)")
params.register("liveattr_ring", 128,
                "per-class-profile quantile reservoir: the most recent "
                "N sampled observations kept for the p50/p95/p99 "
                "estimates the straggler threshold arms from")
params.register("liveattr_ewma_alpha", 0.2,
                "smoothing factor of the per-class latency EWMA the "
                "status surface and the ETA's duration model read")
params.register("liveattr_max_series", 64,
                "bound on tracked (job, task-class) profile rows: past "
                "it the oldest row is dropped (a resident service must "
                "not grow O(jobs x classes))")
params.register("liveattr_straggler_mult", 8.0,
                "straggler threshold: a task whose sojourn or queue "
                "wait exceeds this multiple of its class p99 emits an "
                "anomaly event and counts in parsec_stragglers_total")
params.register("liveattr_straggler_min", 64,
                "minimum sampled observations before a class arms its "
                "straggler threshold (an unwarmed p99 over 3 samples "
                "would flag ordinary variance)")
params.register("liveattr_straggler_floor_ms", 50.0,
                "absolute straggler floor in milliseconds: the armed "
                "threshold is max(mult x class p99, this floor) — for "
                "microsecond-scale task classes a pure multiple of a "
                "tight p99 would flag every GC pause and scheduler "
                "deschedule on a loaded host")
params.register("liveattr_straggler_incident_s", 60.0,
                "rate limit on straggler-triggered flight-recorder "
                "incident dumps, seconds (the recorder's own "
                "flightrec_min_interval_s applies on top; 0 disables "
                "the trigger entirely)")
params.register("liveattr_anomaly_log", 64,
                "bounded ring of recent structured anomaly events kept "
                "for the status surface")
params.register("liveattr_sim_tasks", 512,
                "node budget of the synthetic dagsim ETA model: a "
                "job's remaining tasks beyond it are collapsed into "
                "equal-work nodes per class (total work preserved)")
params.register("liveattr_enum_max", 100000,
                "cap on enumerating a pool's per-class task totals for "
                "the progress/ETA surface; larger spaces fall back to "
                "the pool's aggregate remaining count")


# ---------------------------------------------------------------------------
# streaming per-class profiles
# ---------------------------------------------------------------------------

class _Profile:
    """One streaming latency profile: exact-ish sampled count/sum/EWMA,
    positional log2 buckets (mergeable across ranks), and a ring
    reservoir for precise local quantiles.  NOT self-locking: the
    owning record's lock covers every mutation."""

    __slots__ = ("n", "sum", "ewma", "buckets", "_ring", "_rn")

    def __init__(self, ring: int):
        self.n = 0
        self.sum = 0.0
        self.ewma = 0.0
        self.buckets = [0] * (_NBUCKETS + 1)
        self._ring: List[float] = [0.0] * max(8, ring)
        self._rn = 0

    def observe(self, x: float, alpha: float) -> None:
        self.buckets[bucket_index(x)] += 1
        self.sum += x
        self.ewma = x if self.n == 0 else \
            (1.0 - alpha) * self.ewma + alpha * x
        self.n += 1
        self._ring[self._rn % len(self._ring)] = x
        self._rn += 1

    def quantile(self, q: float) -> float:
        n = min(self._rn, len(self._ring))
        if not n:
            return 0.0
        snap = sorted(self._ring[:n])
        return snap[min(n - 1, int(q * n))]

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def to_wire(self) -> dict:
        return {"n": self.n, "sum": round(self.sum, 9),
                "ewma": round(self.ewma, 9),
                "q": [round(self.quantile(p), 9)
                      for p in (0.5, 0.95, 0.99)],
                "b": list(self.buckets)}


def bucket_quantile(buckets: List[int], q: float) -> float:
    """Quantile estimate from merged positional log2 buckets (upper
    bound of the bucket where the cumulative count crosses q — factor-2
    resolution, which is what cross-rank merged rows can offer)."""
    total = sum(buckets)
    if not total:
        return 0.0
    goal = q * total
    cum = 0
    for i, b in enumerate(buckets):
        cum += b
        if cum >= goal and b:
            return BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) \
                else BUCKET_BOUNDS[-1] * 2.0
    return BUCKET_BOUNDS[-1] * 2.0


class _Rec:
    """Per-(job, task-class) row: exact counters + profiles + the armed
    straggler thresholds.  ``la`` back-references the owning engine so
    the per-TaskClass cache (``tc._la_rec``) can detect staleness after
    a reset/reinstall with one identity compare.

    ``done`` counts SAMPLED completions only (the metrics stride):
    the per-task hot path pays liveattr nothing — the section scales
    by the stride (exact at stride 1 and in split mode, where every
    completion reaches :meth:`LiveAttr.task_done`), and
    :func:`build_status` snaps a completed pool's counts to its
    enumerated class totals."""

    __slots__ = ("la", "job", "cls", "lock", "done", "sel",
                 "lat", "queue", "exq", "thr_lat", "thr_exec",
                 "thr_queue", "strag", "t0", "t1")

    def __init__(self, la: "LiveAttr", job, cls: str, ring: int):
        self.la = la
        self.job = job
        self.cls = cls
        self.lock = threading.Lock()
        self.done = 0                 # sampled completions (guarded-by:
        self.sel = 0                  # lock); exact selections (split)
        self.lat = _Profile(ring)     # sampled ready->complete sojourn
        self.queue = _Profile(ring)   # sampled ready->select (split mode)
        self.exq = _Profile(ring)     # sampled body interval (split)
        self.thr_lat = 0.0            # armed straggler threshold (sojourn)
        self.thr_exec = 0.0           # armed threshold (body interval)
        self.thr_queue = 0.0          # armed straggler threshold (queue)
        self.t0 = 0.0                 # first/last completion stamps
        self.t1 = 0.0                 # (perf_counter; window of activity)

    def invalidate(self) -> None:
        """Break the per-TaskClass cache binding (``rec.la is self``):
        called on eviction and reset so a class still running cannot
        keep counting into an orphaned row — its next task re-resolves
        through ``_rec_for`` and registers a live one."""
        self.la = None


class LiveAttr:
    """One per RuntimeMetrics (prof/metrics.py owns install/uninstall
    and calls :meth:`task_selected` / :meth:`task_done` from its
    existing PINS handlers — the engine itself registers nothing)."""

    def __init__(self, metrics):
        self._metrics = metrics
        self._lock = threading.Lock()
        #: (job_id-or-None, class name) -> _Rec (guarded-by: _lock)
        self._recs: Dict[Tuple, _Rec] = {}
        self._ring = max(8, int(params.get("liveattr_ring", 128)))
        self._alpha = float(params.get("liveattr_ewma_alpha", 0.2))
        self._max = int(params.get("liveattr_max_series", 64))
        self._mult = float(params.get("liveattr_straggler_mult", 8.0))
        self._min_n = int(params.get("liveattr_straggler_min", 64))
        self._floor = float(params.get("liveattr_straggler_floor_ms",
                                       50.0)) * 1e-3
        self._inc_s = float(params.get("liveattr_straggler_incident_s",
                                       60.0))
        self._last_incident = 0.0
        self._anomalies: deque = deque(
            maxlen=max(4, int(params.get("liveattr_anomaly_log", 64))))
        #: per-(job, class, kind) straggler counts (guarded-by: _lock)
        self._strag_counts: Dict[Tuple, int] = {}
        #: comm counter baseline captured at reset() so the comm bucket
        #: describes the current window, not process lifetime
        self._acts_base = 0.0

    # -- hot path (called from RuntimeMetrics PINS handlers) -------------
    def _rec_for(self, task) -> _Rec:
        """Slow half of the per-TaskClass record cache: runs once per
        (class, install) and on cache staleness."""
        tc = task.task_class
        key = (getattr(task.taskpool, "job_id", None), tc.name)
        with self._lock:
            rec = self._recs.get(key)
            if rec is None:
                rec = self._recs[key] = _Rec(self, key[0], key[1],
                                             self._ring)
                while len(self._recs) > self._max:
                    # the evicted row must not keep receiving updates
                    # through a TaskClass cache that still points at it
                    self._recs.pop(next(iter(self._recs))).invalidate()
        tc._la_rec = rec     # per-class cache; staleness via rec.la
        return rec

    def task_done(self, rec: _Rec, es, task, sampled: bool,
                  check: bool = True,
                  _perf=time.perf_counter) -> None:
        """Completion accounting.  Single-hook mode reaches here only
        for SAMPLED tasks (the metrics stride), so the engine adds
        NOTHING to the common per-task path — counts, profiles and the
        straggler check all ride the stride, exactly like the metrics
        histograms (detection probability for an isolated straggler is
        1/stride there; stride 1 or the split hooks buy full
        coverage).  Split mode calls per task (the knob opted into
        that cost).  ``check=False`` in split mode: the exec-side
        straggler check already ran at exec_end
        (:meth:`observe_exec`)."""
        hit = 0.0
        with rec.lock:
            rec.done += 1
            thr = rec.thr_lat
            now = _perf()
            rec.t1 = now
            if not rec.t0:
                rec.t0 = now
            # sojourn needs ready_at, which a co-installed causal
            # tracer legitimately consumes at select
            dt = None
            t0 = task.ready_at
            if t0 is not None and t0 <= now:
                dt = now - t0
            if sampled and dt is not None:
                rec.lat.observe(dt, self._alpha)
                if not rec.lat.n % 16:
                    self._refresh_thr(rec)
            if check and thr > 0.0 and dt is not None and dt > thr:
                hit = dt
        if hit:
            self._anomaly(rec, task, "exec", hit, rec.thr_lat)

    def observe_exec(self, task, dt: float, sampled: bool) -> None:
        """Split-mode body interval (exec_begin->exec_end, the task
        profiler's own definition): the exec profile and the exec-side
        straggler check."""
        rec = self.rec_of(task)
        hit = 0.0
        with rec.lock:
            if sampled:
                rec.exq.observe(dt, self._alpha)
                if not rec.exq.n % 16:
                    self._refresh_thr(rec)
            thr = rec.thr_exec
            if thr > 0.0 and dt > thr:
                hit = dt
        if hit:
            self._anomaly(rec, task, "exec", hit, rec.thr_exec)

    def rec_of(self, task) -> _Rec:
        """Cached per-TaskClass record (fast path + slow fallback)."""
        rec = getattr(task.task_class, "_la_rec", None)
        if rec is not None and rec.la is self:
            return rec
        return self._rec_for(task)

    def task_selected(self, task, qwait: Optional[float],
                      _perf=time.perf_counter) -> None:
        """Split-mode (metrics_queue_wait=1) selection accounting:
        exact per-class in-flight bookkeeping plus the queue-wait
        profile/straggler side."""
        rec = self.rec_of(task)
        hit = 0.0
        with rec.lock:
            rec.sel += 1
            if qwait is not None:
                rec.queue.observe(qwait, self._alpha)
                if not rec.queue.n % 16:
                    self._refresh_thr(rec)
            thr = rec.thr_queue
            if thr > 0.0:
                q = qwait
                if q is None:
                    t0 = task.ready_at
                    if t0 is not None:
                        q = _perf() - t0
                if q is not None and q > thr:
                    hit = q
        if hit:
            self._anomaly(rec, task, "queue", hit, rec.thr_queue)

    def _refresh_thr(self, rec: _Rec) -> None:
        """Recompute the armed thresholds from the ring p99 (rec.lock
        held).  Amortized: called one sampled observation in 16 — the
        sort is over the bounded ring, off every other task's path."""
        # three thresholds, each armed from ITS OWN distribution: a
        # body duration compared against a sojourn p99 would mask exec
        # stragglers of queue-dominated classes (and vice versa)
        if rec.lat.n >= self._min_n:
            rec.thr_lat = max(self._mult * rec.lat.quantile(0.99),
                              self._floor)
        if rec.exq.n >= self._min_n:
            rec.thr_exec = max(self._mult * rec.exq.quantile(0.99),
                               self._floor)
        if rec.queue.n >= self._min_n:
            rec.thr_queue = max(self._mult * rec.queue.quantile(0.99),
                                self._floor)

    # -- anomalies --------------------------------------------------------
    def _anomaly(self, rec: _Rec, task, kind: str, dt: float,
                 thr: float) -> None:
        """Structured straggler event: log it, count it, and —
        rate-limited — fire the flight recorder so the incident bundle
        captures the straggler's causal neighborhood."""
        ev = {"ts": time.time(), "job": rec.job, "cls": rec.cls,
              "kind": kind, "latency_s": round(dt, 6),
              "threshold_s": round(thr, 6), "mult": self._mult,
              "task": repr(task)[:120]}
        with self._lock:
            self._anomalies.append(ev)
            k = (rec.job, rec.cls, kind)
            self._strag_counts[k] = self._strag_counts.get(k, 0) + 1
        debug_verbose(2, "liveattr: straggler %s %s %.3fms > %.3fms",
                      rec.cls, kind, dt * 1e3, thr * 1e3)
        ctx = getattr(self._metrics, "context", None)
        if ctx is None or self._inc_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_incident < self._inc_s:
                return
            self._last_incident = now
        # telemetry_incident never raises (it logs a failed dump)
        ctx.telemetry_incident(
            f"straggler: {rec.cls} job={rec.job} {kind} "
            f"{dt * 1e3:.1f}ms > {self._mult:g}x p99 "
            f"({thr * 1e3:.1f}ms)")

    def anomalies(self) -> List[dict]:
        with self._lock:
            return list(self._anomalies)

    # -- scrape-side ------------------------------------------------------
    def samples(self) -> List[dict]:
        """Prometheus-side additions (ride RuntimeMetrics.samples)."""
        with self._lock:
            counts = dict(self._strag_counts)
        out = []
        for (job, cls, kind), n in counts.items():
            out.append(counter_sample(
                "parsec_stragglers_total", n,
                {"job": "-" if job is None else str(job),
                 "class": cls, "kind": kind}))
        return out

    def _comm_estimate(self) -> dict:
        """Scrape-time comm-delay fold from the transport's existing
        counters: activations sent this window x the per-peer delay
        estimate (clock-probe rtt/2 + queue->wire drain EWMA,
        RemoteDepEngine.stats()).  No comm-layer hooks — the PAPI-SDE
        pattern again: read counters that already exist."""
        ctx = getattr(self._metrics, "context", None)
        comm = getattr(ctx, "comm", None) if ctx is not None else None
        if comm is None:
            return {"acts": 0.0, "delay_s": 0.0, "per_peer": {}}
        try:
            st = comm.stats()
        except Exception:
            return {"acts": 0.0, "delay_s": 0.0, "per_peer": {}}
        acts = float(st.get("act_eager", 0) + st.get("act_rdv", 0)
                     + st.get("act_inline", 0)) - self._acts_base
        per_peer = {str(r): round(v, 9) for r, v in
                    (st.get("peer_comm_delay_s") or {}).items()}
        vals = [v for v in per_peer.values() if v > 0]
        delay = sum(vals) / len(vals) if vals else 0.0
        return {"acts": max(0.0, acts), "delay_s": round(delay, 9),
                "per_peer": per_peer}

    def section(self) -> dict:
        """The per-rank wire form riding the TAG_METRICS pull."""
        ctx = getattr(self._metrics, "context", None)
        # done counts are SAMPLED in single-hook mode: scale by the
        # stride (exact at stride 1 / split mode; build_status snaps
        # completed pools to their enumerated totals)
        m = self._metrics
        scale = 1 if getattr(m, "_split_queue", False) \
            else max(1, getattr(m, "_sample", 1))
        with self._lock:
            recs = list(self._recs.values())
        rows = []
        for rec in recs:
            with rec.lock:
                rows.append({
                    "job": rec.job, "cls": rec.cls,
                    "done": rec.done * scale,
                    "sel": rec.sel, "t0": rec.t0, "t1": rec.t1,
                    "lat": rec.lat.to_wire(),
                    "queue": rec.queue.to_wire() if rec.queue.n
                    else None,
                    "exec": rec.exq.to_wire() if rec.exq.n else None,
                })
        with self._lock:
            strag = [list(k) + [n]
                     for k, n in self._strag_counts.items()]
            anomalies = list(self._anomalies)[-16:]
        return {"v": 1,
                "rank": ctx.rank if ctx is not None else 0,
                "recs": rows,
                "strag": strag,
                "anomalies": anomalies,
                "comm": self._comm_estimate()}

    def reset(self) -> None:
        """Start a fresh attribution window (benches call this after
        warmup so the split describes the measured run)."""
        with self._lock:
            for rec in self._recs.values():
                rec.invalidate()   # cached on still-live TaskClasses
            self._recs.clear()
            self._strag_counts.clear()
            self._anomalies.clear()
            self._acts_base = 0.0
        # re-baseline the comm counters OUTSIDE the lock (stats() takes
        # transport locks of its own)
        est = self._comm_estimate()
        with self._lock:
            self._acts_base += est["acts"]


# ---------------------------------------------------------------------------
# cross-rank merge + the status document
# ---------------------------------------------------------------------------

def _merge_profile(dst: Optional[dict], src: Optional[dict]) -> \
        Optional[dict]:
    if src is None:
        return dst
    if dst is None:
        return {**src, "b": list(src["b"]), "_single": True}
    n0, n1 = dst["n"], src["n"]
    dst["n"] = n0 + n1
    dst["sum"] += src["sum"]
    dst["ewma"] = ((dst["ewma"] * n0 + src["ewma"] * n1)
                   / max(1, n0 + n1))
    for i, b in enumerate(src["b"]):
        dst["b"][i] += b
    dst["_single"] = False
    return dst


def _finish_profile(p: Optional[dict]) -> Optional[dict]:
    """Non-destructive: build_status finishes the SAME merged row dict
    once per job entry and once in the aggregate section."""
    if p is None:
        return None
    n = p["n"]
    out = {"n": n, "mean_s": round(p["sum"] / n, 9) if n else 0.0,
           "ewma_s": round(p["ewma"], 9)}
    if p.get("_single", False):
        q = p.get("q") or [0.0, 0.0, 0.0]
    else:
        q = [bucket_quantile(p["b"], x) for x in (0.5, 0.95, 0.99)]
    out["p50_s"], out["p95_s"], out["p99_s"] = \
        [round(v, 9) for v in q]
    return out


def merge_sections(sections: Dict[int, dict]) -> dict:
    """Fold per-rank section dicts into one cluster view: counts and
    buckets sum, quantiles re-derive from the merged buckets, the
    activity window is the widest per-rank window (per-rank clocks are
    unaligned perf_counter timelines, so windows merge by width, never
    by endpoint)."""
    recs: Dict[Tuple, dict] = {}
    strag: Dict[Tuple, int] = {}
    anomalies: List[dict] = []
    acts_total = 0.0
    delay_max = 0.0
    window = 0.0
    per_peer: Dict[str, float] = {}
    for rank in sorted(sections):
        sec = sections[rank] or {}
        for row in sec.get("recs", ()):
            key = (row.get("job"), row.get("cls"))
            cur = recs.get(key)
            if cur is None:
                cur = recs[key] = {
                    "job": key[0], "cls": key[1], "done": 0, "sel": 0,
                    "lat": None, "queue": None, "exec": None,
                    "window_s": 0.0}
            cur["done"] += int(row.get("done", 0))
            cur["sel"] += int(row.get("sel", 0))
            for k in ("lat", "queue", "exec"):
                cur[k] = _merge_profile(cur[k], row.get(k))
            t0, t1 = row.get("t0", 0.0), row.get("t1", 0.0)
            if t1 > t0 > 0.0:
                cur["window_s"] = max(cur["window_s"], t1 - t0)
                window = max(window, t1 - t0)
        for ent in sec.get("strag", ()):
            k = tuple(ent[:3])
            strag[k] = strag.get(k, 0) + int(ent[3])
        for ev in sec.get("anomalies", ()):
            anomalies.append({**ev, "rank": sec.get("rank", rank)})
        cm = sec.get("comm") or {}
        acts_total += float(cm.get("acts", 0.0))
        delay_max = max(delay_max, float(cm.get("delay_s", 0.0)))
        for r, v in (cm.get("per_peer") or {}).items():
            per_peer[r] = max(per_peer.get(r, 0.0), float(v))
            delay_max = max(delay_max, float(v))
    # total activations x the best-informed per-frame delay estimate.
    # Direction estimates of one symmetric link legitimately diverge
    # (an accepted clock sample may have probed an idle or a congested
    # loop), so take the pessimistic direction, and scale by the
    # measured load factor: a delivery during a BUSY pipeline pays
    # wire + busy-loop dispatch + deliver/schedule — on the traced
    # rtt leg ~2x the idle-link one-way latency the clock probe
    # measures.  Deliberately an UPPER estimate: the telescoping
    # remainder clamp bounds it by what exec/queue leave, so on
    # comm-dominated runs comm converges to the true residual while
    # traffic-free windows stay at zero
    comm_s = acts_total * delay_max * 2.0
    anomalies.sort(key=lambda e: e.get("ts", 0.0))
    return {"recs": recs, "strag": strag,
            "anomalies": anomalies[-32:],
            "comm_s": comm_s, "per_peer_delay_s": per_peer,
            "window_s": window}


def telescope(elapsed: float, exec_s: float, queue_s: float,
              comm_s: float) -> dict:
    """Telescoping decomposition with a trust hierarchy: exec and
    queue are MEASURED (sampled per-task stamps — trusted first),
    comm is an ESTIMATE (scrape-time activation count x per-frame
    delay — capped into whatever the measured buckets leave), and
    idle is the INFERRED remainder.  The buckets ALWAYS sum to
    elapsed (the property the offline ``critpath.attribute``
    guarantees by construction); on wide DAGs, where cumulative task
    time legitimately exceeds the window, exec+queue scale down
    proportionally and comm/idle go to zero (documented
    approximation: the split is exact on critical-chain-dominated
    runs, a proportional share elsewhere)."""
    exec_s = max(0.0, exec_s)
    queue_s = max(0.0, queue_s)
    comm_s = max(0.0, comm_s)
    if elapsed <= 0.0:
        return {"exec": 0.0, "queue": 0.0, "comm": 0.0, "idle": 0.0,
                "elapsed": 0.0, "coverage": 0.0}
    eq = exec_s + queue_s
    if eq > elapsed:
        f = elapsed / eq
        exec_s, queue_s, comm_s, idle = exec_s * f, queue_s * f, \
            0.0, 0.0
    else:
        comm_s = min(comm_s, elapsed - eq)
        idle = elapsed - eq - comm_s
    covered = exec_s + queue_s + comm_s
    return {"exec": round(exec_s, 6), "queue": round(queue_s, 6),
            "comm": round(comm_s, 6), "idle": round(idle, 6),
            "elapsed": round(elapsed, 6),
            "coverage": round(min(1.0, covered / elapsed), 4)}


def _bucket_sums(rows: List[dict]) -> Tuple[float, float]:
    """(exec_s, queue_s) estimates over merged rows: sampled mean x
    exact done count per class.  Split mode contributes a real
    exec/queue separation; single-hook mode folds both into the
    sojourn, which lands in exec (documented: 'exec' then reads
    ready->complete)."""
    exec_s = queue_s = 0.0
    for row in rows:
        done = row["done"]
        ex, qu, lat = row.get("exec"), row.get("queue"), row.get("lat")
        q = (qu["sum"] / qu["n"]) * done \
            if qu is not None and qu["n"] else None
        if q is not None:
            queue_s += q
        if ex is not None and ex["n"]:
            exec_s += (ex["sum"] / ex["n"]) * done
        elif lat is not None and lat["n"]:
            # single-hook sojourn: subtract the queue share when the
            # split hook measured one, else the whole sojourn is exec
            sojourn = (lat["sum"] / lat["n"]) * done
            exec_s += max(0.0, sojourn - (q or 0.0))
    return exec_s, queue_s


# -- per-pool class totals (progress + ETA) ---------------------------------

def class_totals(tp, cap: Optional[int] = None) -> Optional[Dict[str,
                                                                 int]]:
    """Per-class task totals of a parameterized pool, enumerated once
    and cached on the pool.  Returns None for dynamic pools (totals
    unknowable before insertion stops) or spaces past the enumeration
    cap."""
    if tp is None:
        return None
    cached = getattr(tp, "_liveattr_totals", ...)
    if cached is not ...:
        return cached
    totals: Optional[Dict[str, int]] = {}
    cap = int(params.get("liveattr_enum_max", 100000)) \
        if cap is None else cap
    try:
        from parsec_tpu_torch.core.taskpool import Compound, DynamicTaskpool
        pools = tp.pools if isinstance(tp, Compound) else [tp]
        seen = 0
        for pool in pools:
            if isinstance(pool, DynamicTaskpool):
                totals = None
                break
            for tc in pool.task_classes.values():
                n = 0
                for _ in tc.iter_space(pool.globals):
                    n += 1
                    seen += 1
                    if seen > cap:
                        raise OverflowError
                totals[tc.name] = totals.get(tc.name, 0) + n
    except OverflowError:
        totals = None
    except Exception:
        totals = None
    tp._liveattr_totals = totals
    return totals


def eta_seconds(class_rows: List[dict], pending_total: int,
                n_chips: int, done_total: int = 0,
                window_s: float = 0.0) -> Optional[float]:
    """Completion quote: remaining-task counts x live class profiles
    through the calibrated dagsim list-scheduling model.  ``class_rows``
    carry {"cls", "pending", "mean_s"[, "done"]}; classes with no
    profile yet borrow the across-class mean.  Returns None with
    nothing to go on.

    CALIBRATION: the class profiles give the relative cost mix, but
    their absolute scale can be off in either direction — a
    single-hook sojourn mean double-counts queueing (dagsim models
    queueing itself; verified 37x over on a deep-queued pool), and a
    split-mode body mean ignores comm/idle overhead.  When the
    observed completion rate is available (``done_total`` tasks over
    the ``window_s`` activity window), every class duration scales by
    one factor so the model's implied steady throughput matches the
    measured one — the quote then extrapolates what the gang actually
    sustains, with dagsim handling the mix and the tail."""
    # profile means come from EVERY observed class, pending or not —
    # a dynamic pool (unknown per-class totals, all pending None/0)
    # must still quote off its profiles + the aggregate remaining
    known = [r["mean_s"] for r in class_rows
             if r.get("mean_s", 0.0) > 0.0]
    if not known:
        return None
    fallback = sum(known) / len(known)
    rows = [dict(r) for r in class_rows if r.get("pending", 0) > 0]
    for r in rows:
        if r.get("mean_s", 0.0) <= 0.0:
            r["mean_s"] = fallback
    listed = sum(r["pending"] for r in rows)
    if pending_total > listed:
        # tasks outside the per-class rows (unknown totals): one
        # synthetic class at the blended duration — appended BEFORE
        # calibration so it scales with everything else
        rows.append({"cls": "__rest__",
                     "pending": pending_total - listed,
                     "mean_s": fallback})
    if done_total > 0 and window_s > 0.0:
        w = [(r.get("done", 0), r["mean_s"]) for r in rows]
        wsum = sum(d for d, _m in w)
        model_mean = (sum(d * m for d, m in w) / wsum) if wsum \
            else fallback
        target_mean = max(1, int(n_chips)) * window_s / done_total
        if model_mean > 0:
            f = target_mean / model_mean
            for r in rows:
                r["mean_s"] *= f
    from parsec_tpu_torch.parallel.dagsim import SimDag, simulate
    budget = max(8, int(params.get("liveattr_sim_tasks", 512)))
    total = sum(r["pending"] for r in rows)
    if total <= 0:
        return 0.0
    dag = SimDag()
    chip = 0
    for r in rows:
        pend = r["pending"]
        nodes = max(1, min(pend, int(round(budget * pend / total))))
        work = pend * r["mean_s"]
        for i in range(nodes):
            key = (r["cls"], i)
            dag.nodes[key] = {"tc": r["cls"], "locals": {},
                              "chip": chip, "prio": 0,
                              "dur": work / nodes}
            chip += 1
    n_chips = max(1, int(n_chips))
    try:
        return round(simulate(dag, n_chips)["makespan_s"], 6)
    except Exception:
        return round(sum(r["pending"] * r["mean_s"] for r in rows)
                     / n_chips, 6)


# -- the status document ----------------------------------------------------

def _class_entry(row: dict, total: Optional[int],
                 completed: bool = False) -> dict:
    done = row["done"]
    if total is not None:
        # done is a stride-scaled estimate (exact at stride 1 / split
        # mode): clamp into the enumerated space, and snap a COMPLETED
        # pool's count to its total
        done = total if completed else min(done, total)
    inflight = max(0, row["sel"] - done) if row["sel"] else 0
    out = {"done": done, "inflight": inflight,
           "pending": (max(0, total - done - inflight)
                       if total is not None else None),
           "lat": _finish_profile(row.get("lat"))}
    for k in ("queue", "exec"):
        p = _finish_profile(row.get(k))
        if p is not None:
            out[k] = p
    return out


def _job_entry(job, merged: dict, comm_total: float,
               done_total: int, n_chips: int) -> dict:
    jid = job.job_id
    rows = [r for (j, _c), r in merged["recs"].items() if j == jid]
    totals = class_totals(job.taskpool)
    completed = job.taskpool is not None \
        and bool(getattr(job.taskpool, "completed", False))
    classes = {}
    pend_rows = []
    for r in sorted(rows, key=lambda x: x["cls"]):
        tot = totals.get(r["cls"]) if totals else None
        ent = _class_entry(r, tot, completed)
        classes[r["cls"]] = ent
        # the ETA's duration model prefers the split-mode BODY profile
        # (exec) over the sojourn; either way the throughput
        # calibration in eta_seconds sets the absolute scale
        prof = ent.get("exec") or ent.get("lat") or {}
        pend_rows.append({"cls": r["cls"],
                          "pending": ent["pending"] or 0,
                          "done": ent["done"],
                          "mean_s": prof.get("mean_s", 0.0)})
    if totals:
        for cls, tot in totals.items():
            if cls not in classes and tot > 0:
                # class never sampled: a completed pool's count snaps
                # to the enumerated total, a running one shows pending
                classes[cls] = {"done": tot if completed else 0,
                                "inflight": 0,
                                "pending": 0 if completed else tot,
                                "lat": None}
                if not completed:
                    pend_rows.append({"cls": cls, "pending": tot,
                                      "mean_s": 0.0})
    done = sum(ent["done"] for ent in classes.values())
    tp = job.taskpool
    remaining = max(0, int(getattr(tp, "nb_tasks", 0) or 0)) \
        if tp is not None and not getattr(tp, "completed", False) else 0
    status = job.status().name
    now = time.time()
    if job.started_at is None:
        elapsed = 0.0
    else:
        end = job.finished_at if job.finished_at is not None else now
        elapsed = max(0.0, end - job.started_at)
    exec_s, queue_s = _bucket_sums(rows)
    comm_s = comm_total * (done / done_total) if done_total else 0.0
    att = telescope(elapsed, exec_s, queue_s, comm_s)
    stragglers = [e for e in merged["anomalies"]
                  if e.get("job") == jid]
    eta = None
    if status == "RUNNING" and remaining:
        window = max((r.get("window_s", 0.0) for r in rows),
                     default=0.0)
        eta = eta_seconds(pend_rows, remaining, n_chips,
                          done_total=done, window_s=window)
    return {"job": jid, "name": job.name, "status": status,
            "elapsed_s": round(elapsed, 6),
            "progress": {"done": done,
                         "remaining": remaining,
                         "classes": classes},
            "attribution": att,
            "stragglers": stragglers,
            "eta_s": eta,
            "eta_method": None if eta is None else "dagsim"}


def build_status(context, service=None,
                 sections: Optional[Dict[int, dict]] = None,
                 health_sections: Optional[Dict[int, dict]] = None) -> dict:
    """Assemble the status document from merged per-rank sections.
    Degrades rather than fails: a job whose pieces cannot be read
    still appears with what is known.  ``health_sections`` are the
    per-rank ``__health__`` records riding the same pull; merged
    (prof/health.merge_health) into the document's ``health`` block."""
    merged = merge_sections(sections or {})
    done_total = sum(r["done"] for r in merged["recs"].values())
    comm_total = merged["comm_s"]
    n_chips = max(1, context.nranks) * max(1, len(context.streams))
    jobs = []
    if service is not None:
        for job in service.jobs():
            try:
                jobs.append(_job_entry(job, merged, comm_total,
                                       done_total, n_chips))
            except Exception as exc:   # degrade, never drop the scrape
                jobs.append({"job": job.job_id, "name": job.name,
                             "status": job.status().name,
                             "error": f"{type(exc).__name__}: {exc}"})
    # context-wide aggregate (covers batch pools with no job id)
    rows = list(merged["recs"].values())
    exec_s, queue_s = _bucket_sums(rows)
    agg_elapsed = merged["window_s"]
    agg = {
        "done": done_total,
        "classes": {r["cls"]: _class_entry(r, None)
                    for r in sorted(rows, key=lambda x: x["cls"])},
        "attribution": telescope(agg_elapsed, exec_s, queue_s,
                                 comm_total),
    }
    doc = {"ts": time.time(),
           "rank": context.rank,
           "ranks": sorted(sections or {context.rank: None}),
           "jobs": jobs,
           "aggregate": agg,
           "stragglers": merged["anomalies"],
           "stragglers_total": sum(merged["strag"].values()),
           "comm": {"per_peer_delay_s": merged["per_peer_delay_s"]}}
    if health_sections:
        try:
            from parsec_tpu_torch.prof.health import merge_health
            doc["health"] = merge_health(health_sections)
        except Exception:   # degrade, never drop the scrape
            pass
    if service is not None:
        try:
            doc["service"] = service.stats()
        except Exception:
            pass
    return doc


def cluster_status(context, service=None, aggregate: bool = True,
                   timeout: float = 2.0) -> dict:
    """One status scrape: this rank's section plus — on a multi-rank
    context — every live peer's, extracted from the SAME TAG_METRICS
    pull the /metrics scrape uses (each rank's metrics snapshot
    carries its liveattr section as one extra sample record; zero new
    wire tags)."""
    m = getattr(context, "metrics", None)
    la = getattr(m, "_la", None) if m is not None else None
    hm = getattr(m, "_health", None) if m is not None else None
    sections: Dict[int, dict] = {}
    health_sections: Dict[int, dict] = {}
    if la is not None:
        sections[context.rank] = la.section()
    if hm is not None:
        try:
            hm.refresh()
            health_sections[context.rank] = hm.section()
        except Exception:
            pass
    comm = getattr(context, "comm", None)
    ce = getattr(comm, "ce", None) if comm is not None else None
    if aggregate and ce is not None and context.nranks > 1:
        try:
            for rank, samples in ce.gather_metrics(
                    timeout=timeout).items():
                for s in samples:
                    if s.get("t") != "section":
                        continue
                    if s.get("n") == "__liveattr__":
                        sections[int(rank)] = s.get("doc") or {}
                    elif s.get("n") == "__health__":
                        health_sections[int(rank)] = s.get("doc") or {}
        except Exception:   # degrade to the local view, never fail
            pass
    return build_status(context, service, sections, health_sections)
