"""Always-on telemetry: metrics registry + Prometheus scrape surface.

The production counterpart of the reference's PAPI-SDE live counters
(reference: parsec/papi_sde.{c,h} — software-defined events external
agents read while the runtime serves).  prof/gauges.py rebuilt those
counters; this module grows them into a telemetry PLANE:

* a lock-cheap registry of Counter / Gauge / Histogram metrics with
  labeled families (per-peer, per-device-class, per-job), fed from the
  existing PINS / ``CommEngine.stats`` / ``RemoteDepEngine.stats()`` /
  JobGauges paths;
* Histograms use FIXED log2 latency buckets (one ``frexp`` per
  observation, no bucket search) plus a small ring reservoir for
  quantile estimates;
* hot-path counters are sampled (``metrics_sample``): the per-task cost
  is two PINS dispatches and one short lock hold — the
  telemetry-overhead gate bounds the whole plane at <= 5% of the tasks
  probe (vs ~30% for the full causal tracer);
* ``samples()`` snapshots everything into a wire-friendly list;
  ``render_text()`` emits Prometheus text exposition;
  ``merge_samples`` folds per-rank snapshots into one cluster view
  (counters/histograms sum, gauges keep a ``rank`` label) — the
  TAG_METRICS pull in comm/engine.py ships peer snapshots so one
  scrape sees the mesh.

In the port: installed by default on every Context (``metrics_enabled``),
with live attribution and health armed, as in the JAX package; read with
``ctx.metrics.samples()`` (or ``render_text`` of them), and across the
ranks of a distributed run with ``cluster_exposition``, which pulls the
peers' samples over the comm engine's TAG_METRICS lane.  The comm
collectors return nothing while ``ctx.comm`` is None (a single-rank
run), and the job-service collector while no JobService is attached.
Scraped through the JobServer's ``{"op": "metrics"}`` request or a
plain HTTP ``GET /metrics`` on the same port (service/server.py), as in
the JAX package.  A job over ``metrics_slo_job_s`` counts in
``parsec_jobs_slo_breached_total`` and, with the flight recorder armed,
triggers an incident dump.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from parsec_tpu_torch.utils.mca import params

params.register("metrics_enabled", 1,
                "install the always-on telemetry registry on every "
                "Context: task/comm/device/job counter families plus "
                "latency histograms, scrapeable through the job "
                "server's /metrics surface and aggregated across ranks "
                "over TAG_METRICS (0 disables every hook)")
params.register("metrics_sample", 16,
                "histogram sampling stride for per-task latency and "
                "queue-wait observations: 1 observes every task, N "
                "observes one in N (counters stay exact; sampling only "
                "thins the histogram population to keep the always-on "
                "cost inside the <=5% telemetry-overhead gate)")
params.register("metrics_queue_wait", 0,
                "split the task-latency telemetry: hook the select + "
                "exec_begin/exec_end PINS events too, so queue-wait "
                "(ready->select) and body execution latency "
                "(exec_begin->exec_end, the same interval the task "
                "profiler records) are separate histograms — also "
                "what the live attribution plane needs for a true "
                "exec/queue split.  Default off — each additional "
                "hooked event costs tasks-probe budget; the default "
                "single-hook path folds everything into the "
                "sojourn-time latency histogram (ready->complete), "
                "which is what a serving SLO reads anyway")
params.register("metrics_ring", 256,
                "per-histogram quantile reservoir size: the most recent "
                "N observations kept in a ring for q50/q99 estimates "
                "(bucket counts are exact regardless)")
params.register("metrics_slo_job_s", 0.0,
                "job admission->completion SLO in seconds: a finished "
                "job over budget counts in jobs_slo_breached_total and "
                "— with the flight recorder armed — triggers an "
                "incident dump (0 disables the breach trigger)")

#: log2 histogram bucket bounds: 2^-20 s (~1 us) .. 2^6 s (64 s).
#: Fixed at module scope so every rank's buckets merge positionally.
_LOW = -20
_NBUCKETS = 27
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    float(2.0 ** (_LOW + i)) for i in range(_NBUCKETS))


def bucket_index(x: float) -> int:
    """Index of the smallest bound >= x (len(BUCKET_BOUNDS) = +Inf).
    One frexp, no search: x = m * 2^e with m in [0.5, 1) puts x under
    bound 2^e — except exact powers of two (m == 0.5), which belong one
    bucket down (le semantics: count of observations <= bound)."""
    if x <= BUCKET_BOUNDS[0]:
        return 0
    m, e = math.frexp(x)
    i = e - _LOW - (1 if m == 0.5 else 0)
    return i if i < _NBUCKETS else _NBUCKETS


class Counter:
    """Monotonic counter.  ``inc`` takes one short lock hold — cheap
    enough for per-task paths, exact under every thread interleaving."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0                    # guarded-by: _lock

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Point-in-time value (set/add); reads are snapshot-racy by
    design, like the reference's SDE counters."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0                    # guarded-by: _lock

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed log2-bucket histogram + ring reservoir for quantiles.

    ``observe`` is one lock hold around four scalar updates; bucket
    selection is a single ``frexp`` (no search), so the latency classes
    this serves (task latency, queue wait, frame RTT, job SLO) cost the
    same regardless of magnitude."""

    __slots__ = ("_lock", "buckets", "sum", "count", "_ring", "_rn")

    def __init__(self, ring: Optional[int] = None):
        self._lock = threading.Lock()
        #: raw (non-cumulative) per-bucket counts; index NBUCKETS = +Inf
        #: (guarded-by: _lock)
        self.buckets = [0] * (_NBUCKETS + 1)
        self.sum = 0.0                   # guarded-by: _lock
        self.count = 0                   # guarded-by: _lock
        n = ring if ring is not None \
            else max(16, int(params.get("metrics_ring", 256)))
        self._ring: List[float] = [0.0] * n   # guarded-by: _lock
        self._rn = 0                     # guarded-by: _lock

    def observe(self, x: float) -> None:
        i = bucket_index(x)
        with self._lock:
            self.buckets[i] += 1
            self.sum += x
            self.count += 1
            self._ring[self._rn % len(self._ring)] = x
            self._rn += 1

    def quantile(self, q: float) -> float:
        """Estimate from the ring reservoir (recent-window quantile)."""
        with self._lock:
            n = min(self._rn, len(self._ring))
            snap = sorted(self._ring[:n])
        if not snap:
            return 0.0
        return snap[min(len(snap) - 1, int(q * len(snap)))]

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self.buckets), self.sum, self.count


class Family:
    """Labeled metric family: ``family.labels(peer="1")`` returns the
    child metric, created on demand.  Bounded: past ``max_series`` the
    oldest-inserted child is dropped (a resident service must not grow
    O(label cardinality))."""

    def __init__(self, kind: type, label_names: Tuple[str, ...],
                 max_series: int, **kw):
        self.kind = kind
        self.label_names = label_names
        self._kw = kw
        self._max = max_series
        self._lock = threading.Lock()
        #: label-value tuple -> metric (guarded-by: _lock)
        self._children: Dict[Tuple[str, ...], Any] = {}

    def labels(self, **labels) -> Any:
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self.kind(**self._kw)
                while len(self._children) > self._max:
                    self._children.pop(next(iter(self._children)))
            return child

    def items(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            kids = list(self._children.items())
        return [(dict(zip(self.label_names, key)), m) for key, m in kids]


# ---------------------------------------------------------------------------
# sample records: the wire/merge/render interchange form
# ---------------------------------------------------------------------------

def counter_sample(name: str, value: float,
                   labels: Optional[Dict[str, str]] = None) -> dict:
    return {"n": name, "t": "counter", "l": dict(labels or {}),
            "v": float(value)}


def gauge_sample(name: str, value: float,
                 labels: Optional[Dict[str, str]] = None) -> dict:
    return {"n": name, "t": "gauge", "l": dict(labels or {}),
            "v": float(value)}


def histogram_sample(name: str, hist: Histogram,
                     labels: Optional[Dict[str, str]] = None) -> dict:
    buckets, s, c = hist.snapshot()
    return {"n": name, "t": "histogram", "l": dict(labels or {}),
            "b": buckets, "sum": s, "cnt": c}


def merge_samples(per_rank: Dict[int, List[dict]]) -> List[dict]:
    """Fold per-rank sample lists into one cluster view: counters and
    histograms SUM across ranks (positional log2 buckets make that
    exact); gauges are point-in-time per-rank readings, so each keeps
    its origin as a ``rank`` label."""
    merged: Dict[Tuple, dict] = {}
    for rank in sorted(per_rank):
        for s in per_rank[rank]:
            if s.get("t") == "section":
                # non-metric side-channel records (the liveattr status
                # section) ride the same pull but never merge or render
                continue
            labels = dict(s.get("l") or {})
            if s["t"] == "gauge":
                labels["rank"] = str(rank)
            key = (s["n"], s["t"], tuple(sorted(labels.items())))
            cur = merged.get(key)
            if cur is None:
                cur = merged[key] = {**s, "l": labels}
                if s["t"] == "histogram":
                    cur["b"] = list(s["b"])
                continue
            if s["t"] == "histogram":
                for i, b in enumerate(s["b"]):
                    cur["b"][i] += b
                cur["sum"] += s["sum"]
                cur["cnt"] += s["cnt"]
            else:
                cur["v"] += s["v"]
    return list(merged.values())


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{%s}" % inner


def _fmt_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_text(samples: List[dict]) -> str:
    """Prometheus text exposition (0.0.4): HELP/TYPE once per family,
    histogram buckets CUMULATIVE with le labels + _sum/_count."""
    by_name: Dict[str, List[dict]] = {}
    for s in samples:
        if s.get("t") == "section":   # side-channel records don't render
            continue
        by_name.setdefault(s["n"], []).append(s)
    out: List[str] = []
    for name in sorted(by_name):
        group = by_name[name]
        typ = group[0]["t"]
        out.append(f"# TYPE {name} {typ}")
        for s in group:
            labels = s.get("l") or {}
            if typ == "histogram":
                cum = 0
                for i, b in enumerate(s["b"]):
                    cum += b
                    le = ("+Inf" if i >= len(BUCKET_BOUNDS)
                          else repr(BUCKET_BOUNDS[i]))
                    out.append("%s_bucket%s %d" % (
                        name, _fmt_labels({**labels, "le": le}), cum))
                out.append("%s_sum%s %s" % (name, _fmt_labels(labels),
                                            _fmt_num(s["sum"])))
                out.append("%s_count%s %d" % (name, _fmt_labels(labels),
                                              s["cnt"]))
            else:
                out.append("%s%s %s" % (name, _fmt_labels(labels),
                                        _fmt_num(s["v"])))
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# the runtime installer: PINS hooks + scrape-time collectors
# ---------------------------------------------------------------------------

class _StrideGated:
    """complete_exec callback wrapper advertising its sampling stride
    to the native worker quantum (schedext.run_quantum): when
    ``es.nb_tasks_done % __pins_stride__`` is nonzero the C dispatcher
    skips the call entirely — exactly equivalent to the wrapped
    handler's own unsampled early-return (which touches nothing, not
    even liveattr), but without the per-task Python call.  Split mode
    (``metrics_queue_wait=1``) does real work on every event, so the
    property answers stride 1 there (= never skip); the Python
    dispatch path ignores the attribute and calls through unchanged."""

    __slots__ = ("fn", "_m")

    def __init__(self, fn, metrics):
        self.fn = fn
        self._m = metrics

    @property
    def __pins_stride__(self) -> int:
        m = self._m
        return 1 if m._split_queue else m._sample

    def __call__(self, es, event, task):
        return self.fn(es, event, task)


class RuntimeMetrics:
    """One per Context.  Live hot-path metrics (task counters, sampled
    latency/queue-wait histograms, job SLO histograms) update through
    PINS; everything already counted elsewhere — ``CommEngine.stats``,
    ``RemoteDepEngine.stats()``, device stats, JobGauges — is read at
    SCRAPE time by collectors, so steady state pays nothing for it
    (the PAPI-SDE pattern: the counter is the source of truth, the
    exporter just reads it)."""

    def __init__(self, rank: int = 0):
        self.rank = rank
        self.context = None
        self._service = None
        self._lock = threading.Lock()
        self._sample = max(1, int(params.get("metrics_sample", 16)))
        self._split_queue = bool(int(params.get("metrics_queue_wait", 0)))
        #: opt-in select/exec-hook sampling strides (racy ints:
        #: approximate stride is fine, the samples are a reservoir)
        self._sn = 0
        self._en = 0
        #: discards are rare (pool cancellation) — a locked counter
        #: costs nothing at steady state
        self._discarded = Counter()
        self.task_latency = Histogram()
        self.task_queue_wait = Histogram()
        self.job_duration = Histogram()
        self.job_queue = Histogram()
        self.comm_frame_rtt = Histogram()
        self._jobs_done = Family(Counter, ("status",), 16)
        self._slo = float(params.get("metrics_slo_job_s", 0.0))
        self._slo_breached = Counter()
        self._collectors: List[Callable[[], List[dict]]] = []
        #: online attribution engine (prof/liveattr.py) riding THESE
        #: hooks — it registers no PINS callbacks of its own
        self._la = None
        #: predictive health plane (prof/health.py): scrape-time
        #: fusion of the existing counters — no hooks, no hot path
        self._health = None
        #: the stride-advertising wrapper _complete registers through
        #: (built at install; the native quantum reads its stride)
        self._complete_cb = None

    # -- lifecycle -------------------------------------------------------
    @property
    def liveattr(self):
        """The online attribution engine, or None when disarmed."""
        return self._la

    @property
    def health(self):
        """The predictive health monitor, or None when disarmed."""
        return self._health

    def install(self, context) -> "RuntimeMetrics":
        self.rank = context.rank
        self.context = context
        context.metrics = self
        context._recompute_ready_stamp()
        if int(params.get("liveattr_enable", 1)):
            from parsec_tpu_torch.prof.liveattr import LiveAttr
            self._la = LiveAttr(self)
        if int(params.get("health_enable", 1)):
            from parsec_tpu_torch.prof.health import HealthMonitor
            self._health = HealthMonitor(self)
        # ONE hooked hot-path event by default: every additional PINS
        # dispatch with a live callback costs ~0.5us/task on the tasks
        # probe — two hooks alone would eat the whole armed budget
        if self._split_queue:
            context.pins_register("select", self._select)
            context.pins_register("exec_begin", self._exec_begin)
            context.pins_register("exec_end", self._exec_end)
        # registered through a stride-advertising wrapper: the native
        # run_quantum reads __pins_stride__ and SKIPS the unsampled
        # calls entirely (valid because _complete's unsampled
        # single-hook path is a pure no-op — it returns before
        # touching liveattr; split mode advertises stride 1)
        self._complete_cb = _StrideGated(self._complete, self)
        context.pins_register("complete_exec", self._complete_cb)
        context.pins_register("task_discard", self._discard)
        context.pins_register("job_done", self._job_done)
        ce = self._ce(context)
        if ce is not None:
            ce.metrics_provider = self.samples
            ce.on_clock_rtt = self.comm_frame_rtt.observe
        return self

    @staticmethod
    def _ce(context):
        comm = getattr(context, "comm", None)
        return getattr(comm, "ce", None) if comm is not None else None

    def uninstall(self, context) -> None:
        if self._split_queue:
            context.pins_unregister("select", self._select)
            context.pins_unregister("exec_begin", self._exec_begin)
            context.pins_unregister("exec_end", self._exec_end)
        context.pins_unregister("complete_exec", self._complete_cb)
        context.pins_unregister("task_discard", self._discard)
        context.pins_unregister("job_done", self._job_done)
        ce = self._ce(context)
        if ce is not None and ce.metrics_provider == self.samples:
            # a detached registry must not keep serving TAG_METRICS
            ce.metrics_provider = None
            ce.on_clock_rtt = None
        if getattr(context, "metrics", None) is self:
            context.metrics = None
            context._recompute_ready_stamp()
        self.context = None
        self._la = None   # cached per-TaskClass recs detect the
        #                   staleness through their rec.la identity
        self._health = None

    def attach_service(self, service) -> None:
        """Job-service gauges (pending/running/degraded + the bounded
        per-job task counters JobGauges already keeps) join the scrape."""
        self._service = service

    def detach_service(self, service) -> None:
        if self._service is service:
            self._service = None

    def register_collector(self, fn: Callable[[], List[dict]]) -> None:
        self._collectors.append(fn)

    # -- PINS hot path ---------------------------------------------------
    # The retired counter is NOT kept here: complete_execution already
    # maintains ExecutionStream.nb_tasks_done, so the scrape sums that
    # for free and the hot handler only pays the sampling stride — an
    # attribute read, a modulo, and (one task in N) a perf_counter +
    # histogram observe.  That is what keeps the whole armed plane
    # inside the <=5% telemetry-overhead gate.

    def _select(self, es, event, task) -> None:
        # opt-in (metrics_queue_wait=1): split queue-wait from exec
        n = self._sn = self._sn + 1
        qw = None
        if not n % self._sample:
            now = time.perf_counter()
            t0 = task.ready_at
            if t0 is not None and t0 <= now:
                qw = now - t0
                self.task_queue_wait.observe(qw)
        la = self._la
        if la is not None:
            # liveattr rides this hook: exact per-class selection
            # counts, the sampled queue-wait profile, and the armed
            # queue-side straggler check
            la.task_selected(task, qw)

    def _exec_begin(self, es, event, task,
                    _perf=time.perf_counter) -> None:
        # split mode only: stamp the body interval's start — the SAME
        # interval the task profiler records, so the online exec
        # bucket means what the offline critpath exec bucket means
        task.mtr_t0 = _perf()

    def _exec_end(self, es, event, task,
                  _perf=time.perf_counter) -> None:
        t0 = task.mtr_t0
        if t0 is None:
            return
        task.mtr_t0 = None
        dt = _perf() - t0
        n = self._en = self._en + 1
        sampled = not n % self._sample
        if sampled:
            self.task_latency.observe(dt)
        la = self._la
        if la is not None:
            # exec profile + the exec-side straggler check live here
            # (complete_exec fires after release_deps, so a
            # select->complete clock would fold dep-release and
            # activation-pack time into 'exec')
            la.observe_exec(task, dt, sampled)

    def _complete(self, es, event, task,
                  _perf=time.perf_counter) -> None:
        # default-bound locals: this runs once per task on every
        # stream — each saved attribute lookup is overhead-gate budget
        la = self._la
        sampled = not es.nb_tasks_done % self._sample   # stream-local
        if self._split_queue:
            if task.mtr_t0 is not None:
                # ASYNC (device) task: exec_end never ran on a worker
                # stream — close the interval here
                self._exec_end(es, event, task)
            if la is not None:
                # split mode opted into per-task cost: exact done
                # counts; the straggler check already ran at exec_end
                la.task_done(la.rec_of(task), es, task, sampled,
                             check=False)
            return
        if not sampled:
            # the common case pays liveattr NOTHING: counts, profiles
            # and the straggler check all ride the sampling stride,
            # exactly like the latency histogram below this line
            return
        # single-hook mode: the sampled observation is the SOJOURN time
        # (ready->complete, what an SLO reads); Task.ready_at is the
        # scheduler's stamp, still set unless a causal tracer consumed
        # it (which provides strictly richer data)
        t0 = task.ready_at
        if t0 is not None:
            now = _perf()
            if t0 <= now:
                self.task_latency.observe(now - t0)
        if la is not None:
            la.task_done(la.rec_of(task), es, task, True)

    def _discard(self, es, event, task) -> None:
        self._discarded.inc()

    # -- job lifecycle (service/service.py _emit; jobs_submitted derives
    # from the service collector, so only job_done is hooked) ------------
    def _job_done(self, es, event, job) -> None:
        # fired EXACTLY ONCE per job (JobService._emit_done's one-shot
        # seam): a recovery restart re-terminating a completed pool is
        # absorbed below the service, so the job histograms and the
        # per-status counters never double-observe a job
        try:
            status = job.status().name.lower()
            self._jobs_done.labels(status=status).inc()
            sub, start, end = job.submitted_mono, job.started_at, \
                job.finished_at
            if start is not None and end is not None:
                # started_at/finished_at are wall-clock; their
                # difference is the run time, and queue time falls out
                # of the monotonic submission stamp
                run_s = max(0.0, end - start)
                total_s = max(run_s, time.monotonic() - sub)
                self.job_queue.observe(max(0.0, total_s - run_s))
                self.job_duration.observe(total_s)
                if self._slo > 0 and total_s > self._slo:
                    self._slo_breached.inc()
                    ctx = self.context
                    if ctx is not None:
                        ctx.telemetry_incident(
                            f"job {job.job_id} breached the "
                            f"{self._slo:g}s SLO ({total_s:.2f}s)")
        except Exception:   # telemetry must never fail a job callback
            pass

    def _pending_tasks(self) -> int:
        ctx = self.context
        if ctx is None:
            return 0
        with ctx._lock:
            pools = list(ctx.taskpools.values())
        return sum(max(0, int(getattr(tp, "nb_tasks", 0) or 0))
                   for tp in pools
                   if not getattr(tp, "completed", False)
                   and not getattr(tp, "cancelled", False))

    # -- scrape ----------------------------------------------------------
    def samples(self) -> List[dict]:
        ctx = self.context
        # retired rides the streams' own nb_tasks_done (maintained by
        # complete_execution regardless of telemetry — the PAPI-SDE
        # pattern: read the counter that already exists)
        retired = sum(es.nb_tasks_done for es in ctx.streams) \
            if ctx is not None else 0
        discarded = int(self._discarded.value)
        # pending is a GAUGE, never folded into a *_total counter: a
        # failed pool leaving the registry legitimately shrinks it, and
        # a decreasing counter reads as a reset to rate()-style queries
        out = [
            counter_sample("parsec_tasks_retired_total", retired),
            counter_sample("parsec_tasks_discarded_total", discarded),
            gauge_sample("parsec_pending_tasks", self._pending_tasks()),
            histogram_sample("parsec_task_latency_seconds",
                             self.task_latency),
            histogram_sample("parsec_task_queue_wait_seconds",
                             self.task_queue_wait),
            histogram_sample("parsec_job_duration_seconds",
                             self.job_duration),
            histogram_sample("parsec_job_queue_seconds", self.job_queue),
            histogram_sample("parsec_comm_frame_rtt_seconds",
                             self.comm_frame_rtt),
            counter_sample("parsec_jobs_slo_breached_total",
                           self._slo_breached.value),
        ]
        for labels, c in self._jobs_done.items():
            out.append(counter_sample("parsec_jobs_done_total", c.value,
                                      labels))
        la = self._la
        if la is not None:
            # straggler counters + the liveattr status section (a
            # side-channel record the render/merge paths skip): the
            # cross-rank status document rides the SAME TAG_METRICS
            # pull as the /metrics scrape — zero new wire tags
            out.extend(la.samples())
            try:
                out.append({"n": "__liveattr__", "t": "section",
                            "l": {}, "doc": la.section()})
            except Exception:   # the side channel must not kill scrape
                pass
        hm = self._health
        if hm is not None:
            # per-rank health gauges + the __health__ status section —
            # the fold itself is rate-limited inside refresh(), so a
            # scrape storm costs one dict walk, not one re-score
            try:
                hm.refresh()
                out.extend(hm.samples())
                out.append({"n": "__health__", "t": "section",
                            "l": {}, "doc": hm.section()})
            except Exception:   # the side channel must not kill scrape
                pass
        out.extend(self._collect_comm())
        out.extend(self._collect_sched())
        out.extend(self._collect_devices())
        out.extend(self._collect_service())
        for fn in list(self._collectors):
            try:
                out.extend(fn())
            except Exception:   # a broken collector must not kill scrape
                pass
        return out

    def _collect_comm(self) -> List[dict]:
        ctx = self.context
        comm = getattr(ctx, "comm", None) if ctx is not None else None
        if comm is None:
            return []
        out: List[dict] = []
        try:
            st = comm.stats()
        except Exception:
            return []
        for key in ("frames_sent", "frames_recv", "bytes_sent",
                    "bytes_recv", "syscalls_send", "syscalls_recv",
                    "act_eager", "act_rdv", "act_inline",
                    "eager_bytes", "rdv_bytes", "coalesced_msgs",
                    "eager_downshift", "eager_upshift",
                    # native/shm data-plane counters (all
                    # maintained on their existing hot paths; this
                    # read is scrape-time only): frames through the C
                    # parser, shm ring backpressure stalls, doorbell
                    # traffic in each direction
                    "frames_parsed_native", "shm_ring_full_stalls",
                    "shm_doorbells_sent", "shm_doorbells_recv"):
            v = st.get(key)
            if isinstance(v, (int, float)):
                out.append(counter_sample(f"parsec_comm_{key}_total", v))
        ce = getattr(comm, "ce", None)
        if ce is None:
            return out
        out.append(gauge_sample("parsec_comm_dead_peers",
                                len(ce.dead_peers)))
        try:
            for r, info in ce.peer_debug().items():
                age = info.get("last_heard_age_s")
                if age is not None:
                    out.append(gauge_sample(
                        "parsec_comm_peer_silence_seconds", age,
                        {"peer": str(r)}))
            for r, n in ce.hb_rebases().items():
                out.append(counter_sample("parsec_comm_hb_rebase_total",
                                          n, {"peer": str(r)}))
            for r, stc in ce.clock_table().items():
                out.append(gauge_sample("parsec_comm_clock_rtt_seconds",
                                        stc.get("rtt", 0.0),
                                        {"peer": str(r)}))
        except Exception:
            pass
        return out

    def _collect_sched(self) -> List[dict]:
        """Native-scheduler family, read at scrape time from the C
        queue's own counters (sched/native.py stats()) — zero work on
        the schedule/select hot path."""
        ctx = self.context
        sched = getattr(ctx, "scheduler", None) if ctx is not None \
            else None
        out: List[dict] = []
        # no parsec_sched_native_fallbacks_total sample, a deliberate
        # difference from the JAX package: there a schedext that does not
        # build degrades to the Python ladder and counts it; the port has
        # no silent fallback (a failed build raises), so nothing to count
        st_fn = getattr(sched, "stats", None)
        if st_fn is None:
            return out
        try:
            st = st_fn()
        except Exception:
            return out
        out.append(counter_sample("parsec_sched_native_pushes_total",
                                  st.get("pushes", 0)))
        out.append(counter_sample("parsec_sched_native_pops_total",
                                  st.get("pops", 0)))
        out.append(gauge_sample("parsec_sched_native_pending",
                                st.get("pending", 0)))
        # per-reason fast-path bailouts: the attribution for "why is the
        # C chain not taking my tasks" — a comm_buffered or non_trivial
        # spike localizes a coverage regression without a bench rerun
        try:
            from parsec_tpu_torch.native import load_schedext
            se = load_schedext()
            bail_fn = getattr(se, "bailout_stats", None)
            if bail_fn is not None:
                for reason, n in sorted(bail_fn().items()):
                    if n:
                        out.append(counter_sample(
                            "parsec_sched_native_bailouts_total", n,
                            {"reason": reason}))
        except Exception:
            pass
        return out

    def _collect_devices(self) -> List[dict]:
        ctx = self.context
        if ctx is None:
            return []
        out: List[dict] = []
        for d in ctx.device_registry.devices:
            st = getattr(d, "stats", None)
            if st is None:
                continue
            labels = {"device": getattr(d, "name", "?")}
            for key, metric in (
                    ("executed_tasks", "parsec_device_tasks_total"),
                    ("bytes_in", "parsec_device_bytes_in_total"),
                    ("bytes_out", "parsec_device_bytes_out_total"),
                    ("evictions", "parsec_device_evictions_total"),
                    ("chained_launches",
                     "parsec_device_chained_launches_total"),
                    ("chained_tasks", "parsec_device_chained_tasks_total")):
                v = getattr(st, key, None)
                if isinstance(v, (int, float)) and v:
                    out.append(counter_sample(metric, v, labels))
        return out

    def _collect_service(self) -> List[dict]:
        svc = self._service
        if svc is None:
            return []
        out: List[dict] = []
        try:
            st = svc.stats()
            out.append(gauge_sample("parsec_jobs_pending", st["pending"]))
            out.append(gauge_sample("parsec_jobs_running", st["running"]))
            out.append(counter_sample("parsec_jobs_submitted_total",
                                      st["total"]))
            out.append(gauge_sample("parsec_service_degraded",
                                    1.0 if st["degraded"] else 0.0))
            # per-job task counters ride the existing JobGauges path
            # (bounded to its max_jobs window) — all three columns,
            # distinguished by the kind label
            for jid, row in svc.gauges.job_task_rows():
                for kind, v in zip(("enabled", "retired", "discarded"),
                                   row):
                    if v:
                        out.append(counter_sample(
                            "parsec_job_tasks_total", v,
                            {"job": str(jid), "kind": kind}))
        except Exception:
            pass
        return out


def install_metrics(context) -> RuntimeMetrics:
    return RuntimeMetrics(rank=context.rank).install(context)


# ---------------------------------------------------------------------------
# cluster scrape: local samples + TAG_METRICS peer pulls, rendered
# ---------------------------------------------------------------------------

def cluster_exposition(context, aggregate: bool = True,
                       timeout: float = 2.0) -> Tuple[str, List[int]]:
    """One scrape: this rank's samples plus — on a multi-rank context
    with ``aggregate`` — every live peer's, pulled over the TAG_METRICS
    control lane and merged (counters/histograms sum, gauges keep a
    rank label).  Returns (exposition text, ranks included)."""
    m = getattr(context, "metrics", None)
    local = m.samples() if m is not None else []
    comm = getattr(context, "comm", None)
    ce = getattr(comm, "ce", None) if comm is not None else None
    if not aggregate or ce is None or context.nranks <= 1:
        return render_text(local), [context.rank]
    per_rank = {context.rank: local}
    try:
        per_rank.update(ce.gather_metrics(timeout=timeout))
    except Exception:   # scrape degrades to the local view, never fails
        pass
    return render_text(merge_samples(per_rank)), sorted(per_rank)
