"""ServingFabric: multi-tenant mesh carving + SLO-driven admission.

The JobService (service/service.py) multiplexes concurrent jobs onto
ONE warm Context, but every job sees the whole device mesh: tenants
share every accelerator through the scheduler's load balancing, and
admission is a queue-depth check.  The serving fabric is the next
layer of the north star (PAPER.md §1, §7 — many concurrent jobs
spatially multiplexed over one warm mesh):

carving      — a free-list allocator (:class:`MeshCarver`) over the
               warm mesh's accelerator memory spaces
               (Context.accelerator_spaces) carves a DISJOINT device
               subset per exclusive tenant (best-fit contiguous runs
               first, scattered fallback).  The subset is stamped on
               the job's pool tree (``Taskpool.device_spaces``) so
               ``DeviceRegistry.best_device`` — affinity hints
               included — never leaves it.  Jobs with no device ask
               share the unreserved remainder temporally, exactly the
               old service behavior.
gang dispatch — an admitted job's whole pool tree lands on its subset
               at once (the ``_brand`` stamp covers Compound chains),
               so independent tenants run CONCURRENTLY on disjoint
               hardware instead of serially through one shared mesh.
prediction   — at submit the fabric quotes a completion makespan from
               learned per-(app, task-class) profiles through the
               calibrated dagsim model (prof/liveattr.eta_seconds),
               scaled to the subset being asked for, and verdicts the
               job against its declared SLO: ``admit``, ``queue``
               (admitted, will wait — the quote says the SLO is
               already lost), ``deprioritize`` (admitted at reduced
               priority) or ``reject`` (AdmissionError).  Profiles are
               learned from completed runs (measured makespan + live
               per-class latency profiles), closing the loop with the
               admission→completion SLO histograms.
elasticity   — when devices free up, running tenants below their
               ``devices_max`` ceiling GROW; a device death
               (:meth:`device_dead`) SHRINKS the owning tenant's
               subset in place; and a latency-critical job may PREEMPT
               a lower-priority resumable tenant mid-DAG
               (Taskpool.cancel — the collections the factory closes
               over keep their materialized tiles, the same snapshot
               substrate recovery restores from, so the resumed run
               starts from the data already produced).
audit        — every quote/admission/placement/resize/preemption/
               release decision is journaled (prof/journal.py) so
               tools/journal_audit.py can verify the fabric invariants
               offline: exclusive subsets disjoint at all times (F1),
               exactly one placement outcome per admitted job per
               admission epoch (F2), every preemption resumed or
               terminal (F3).

The port's copy of the JAX package's service/fabric.py: the carver
allocates over the CUDA device modules' memory spaces.  A card host has
one, so a job asking ``devices=1`` leases the card, and shared jobs queue
until the lease is released: the one deliberate difference, a shared job
dispatches only while some space is unreserved (commented in
``_pick_job``).  ``device="cpu:N"`` gives the carver N CPU-backed spaces
(the tests).  Its audit is ``parsec_tpu_torch.tools.journal_audit``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from parsec_tpu_torch.service.job import (AdmissionError, JobHandle, JobStatus)
from parsec_tpu_torch.service.service import JobService
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose

params.register("fabric_devices_default", 0,
                "exclusive accelerators carved for a job that declares "
                "no device ask (0 = temporal sharing of the unreserved "
                "remainder, the plain JobService behavior)")
params.register("fabric_slo_policy", "queue",
                "what an over-SLO quote does at submit: 'queue' admits "
                "anyway (the verdict records the lost SLO), "
                "'deprioritize' admits at reduced priority, 'reject' "
                "raises AdmissionError; per-submit slo_policy overrides")
params.register("fabric_depri_penalty", 8,
                "priority points subtracted from an over-SLO job under "
                "the 'deprioritize' policy")
params.register("fabric_preempt_enable", 1,
                "let an SLO-carrying higher-priority job preempt a "
                "lower-priority RESUMABLE tenant when its device ask "
                "cannot be carved (0 disables preemption entirely)")
params.register("fabric_elastic", 1,
                "grow running tenants toward their devices_max ceiling "
                "when devices free up (0 freezes subsets at placement)")
params.register("fabric_profile_alpha", 0.5,
                "EWMA fold factor of the learned per-app makespan "
                "profiles the admission quote extrapolates from")
params.register("fabric_health_enable", 1,
                "consume the predictive health plane (prof/health.py): "
                "admission quotes inflate against the gang's minimum "
                "health, and a sustained below-threshold rank is "
                "pre-emptively DRAINED before the heartbeat detector "
                "declares it dead (0 ignores health entirely)")
params.register("fabric_drain_score", 0.5,
                "smoothed health score below which a rank becomes a "
                "drain candidate (the health plane's 'critical' "
                "threshold by default)")
params.register("fabric_drain_sustain_s", 3.0,
                "seconds a rank must stay below fabric_drain_score "
                "before the drain fires — one bad fold must not shed "
                "a rank")
params.register("fabric_undrain_score", 0.8,
                "smoothed score a DRAINED rank must recover to before "
                "it rejoins the placement gang")


# ---------------------------------------------------------------------------
# the free-list mesh allocator
# ---------------------------------------------------------------------------

class MeshCarver:
    """Free-list allocator over the warm mesh's accelerator memory
    spaces.  NOT self-locking: the owning fabric's service lock covers
    every mutation (carve/grow/shrink happen inside the dispatcher's
    critical section).

    Placement policy: best-fit CONTIGUOUS run first — neighboring
    space indices are neighboring devices on the mesh ring, so a
    contiguous subset keeps a tenant's ICI traffic local and leaves
    the largest holes for later tenants — with a scattered fallback
    when fragmentation leaves no run long enough (the ask still
    carves; it just spans holes)."""

    def __init__(self, spaces):
        self.spaces: Tuple[int, ...] = tuple(sorted({int(s)
                                                     for s in spaces}))
        self._free = set(self.spaces)
        self._leases: Dict[int, List[int]] = {}

    # -- introspection ----------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def lease(self, owner: int) -> Tuple[int, ...]:
        return tuple(self._leases.get(owner, ()))

    def leases(self) -> Dict[int, Tuple[int, ...]]:
        return {o: tuple(l) for o, l in self._leases.items()}

    def _runs(self) -> List[List[int]]:
        """Maximal runs of consecutive free space indices."""
        runs: List[List[int]] = []
        cur: List[int] = []
        for s in sorted(self._free):
            if cur and s == cur[-1] + 1:
                cur.append(s)
            else:
                if cur:
                    runs.append(cur)
                cur = [s]
        if cur:
            runs.append(cur)
        return runs

    def fragmentation(self) -> float:
        """0.0 = one contiguous hole, →1.0 = free set shattered into
        single-device holes (1 - largest_run / free)."""
        if not self._free:
            return 0.0
        return 1.0 - max(len(r) for r in self._runs()) / len(self._free)

    # -- allocation -------------------------------------------------------
    def carve(self, owner: int, n: int) -> Optional[Tuple[int, ...]]:
        """Allocate ``n`` devices for ``owner``; None when the free
        list cannot cover the ask (or the owner already holds one)."""
        if n <= 0 or owner in self._leases or n > len(self._free):
            return None
        fits = [r for r in self._runs() if len(r) >= n]
        if fits:
            take = min(fits, key=len)[:n]      # best fit: smallest run
        else:
            take = sorted(self._free)[:n]      # scattered fallback
        self._free.difference_update(take)
        self._leases[owner] = sorted(take)
        return tuple(self._leases[owner])

    def grow(self, owner: int, n: int) -> Tuple[int, ...]:
        """Add up to ``n`` free devices to an existing lease, adjacent
        spaces first; returns what was added (possibly empty)."""
        cur = self._leases.get(owner)
        if cur is None or n <= 0 or not self._free:
            return ()
        held = set(cur)
        free = sorted(self._free)
        adj = [s for s in free if s - 1 in held or s + 1 in held]
        take: List[int] = []
        for s in adj + [s for s in free if s not in adj]:
            if len(take) >= n:
                break
            if s not in take:
                take.append(s)
        self._free.difference_update(take)
        cur.extend(take)
        cur.sort()
        return tuple(take)

    def shrink(self, owner: int, n: int) -> Tuple[int, ...]:
        """Return ``n`` devices of a lease to the free list (highest
        indices first); returns what was dropped."""
        cur = self._leases.get(owner)
        if cur is None or n <= 0:
            return ()
        drop = cur[-n:]
        del cur[-len(drop):]
        self._free.update(drop)
        if not cur:
            del self._leases[owner]
        return tuple(drop)

    def release(self, owner: int) -> Tuple[int, ...]:
        cur = self._leases.pop(owner, None)
        if cur:
            self._free.update(cur)
        return tuple(cur or ())

    def evict(self, space: int) -> Optional[int]:
        """Remove a DEAD device from the pool entirely (it returns to
        no one).  Returns the owner whose lease shrank, or None when
        the device was free / unknown."""
        space = int(space)
        if space not in self.spaces:
            return None
        self.spaces = tuple(s for s in self.spaces if s != space)
        if space in self._free:
            self._free.discard(space)
            return None
        for owner, cur in self._leases.items():
            if space in cur:
                cur.remove(space)
                if not cur:
                    del self._leases[owner]
                return owner
        return None


# ---------------------------------------------------------------------------
# learned per-app profiles -> the admission quote
# ---------------------------------------------------------------------------

class FabricProfiles:
    """Per-app learned makespan profiles feeding the admission quote.

    A completed run folds (EWMA) its measured dispatch→completion
    makespan, the device count it ran on, its enumerated per-class
    task totals and the live per-class latency means (prof/liveattr).
    A quote replays those through the calibrated dagsim model
    (liveattr.eta_seconds) at the device count being ASKED for — the
    per-class means are pre-scaled so the model's implied total work
    matches the measured makespan x measured chips (eta_seconds's own
    throughput calibration assumes the quoted gang IS the measured
    one, which is exactly what a cross-subset quote must not assume).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._alpha = float(params.get("fabric_profile_alpha", 0.5))
        #: app key -> {"makespan","chips","total","means","runs"}
        self._apps: Dict[str, dict] = {}

    def observe(self, key: str, makespan: float, chips: int,
                totals: Optional[Dict[str, int]],
                means: Dict[str, float]) -> None:
        if not key or makespan <= 0.0:
            return
        chips = max(1, int(chips))
        total = sum(totals.values()) if totals else None
        with self._lock:
            p = self._apps.get(key)
            if p is None:
                self._apps[key] = {"makespan": float(makespan),
                                   "chips": chips, "total": total,
                                   "totals": dict(totals or {}),
                                   "means": dict(means), "runs": 1}
                return
            a = self._alpha
            p["makespan"] = (1 - a) * p["makespan"] + a * float(makespan)
            p["chips"] = chips
            if total is not None:
                p["total"] = total
                p["totals"] = dict(totals)
            for cls, m in means.items():
                old = p["means"].get(cls)
                p["means"][cls] = m if old is None \
                    else (1 - a) * old + a * m
            p["runs"] += 1

    def quote(self, key: str, chips: int) -> Optional[float]:
        """Predicted makespan in seconds on a ``chips``-device subset;
        None with no history for the app (first-run jobs admit on
        faith — there is nothing to quote from)."""
        with self._lock:
            p = self._apps.get(key)
            if p is None:
                return None
            makespan = p["makespan"]
            measured_chips = p["chips"]
            total = p["total"]
            totals = dict(p["totals"])
            means = dict(p["means"])
        chips = max(1, int(chips))
        if total and means:
            raw = sum(totals.get(c, 0) * m for c, m in means.items())
            f = (makespan * measured_chips / raw) if raw > 0 else 1.0
            rows = [{"cls": c, "pending": n,
                     "mean_s": means.get(c, 0.0) * f}
                    for c, n in sorted(totals.items()) if n > 0]
            try:
                from parsec_tpu_torch.prof.liveattr import eta_seconds
                eta = eta_seconds(rows, total, chips)
                if eta is not None:
                    return eta
            except Exception:
                pass
        # no class mix on record: linear strong-scaling extrapolation
        return round(makespan * measured_chips / chips, 6)


def _job_class_stats(context, job) -> Tuple[Dict[str, float],
                                            Optional[Dict[str, int]]]:
    """(per-class latency means, enumerated per-class totals) of a
    finished job — the live-attribution rows (body profile preferred
    over the sojourn) plus liveattr.class_totals.  Best-effort: either
    side may be empty/None."""
    means: Dict[str, float] = {}
    m = getattr(context, "metrics", None)
    la = getattr(m, "_la", None) if m is not None else None
    if la is not None:
        try:
            for row in la.section().get("recs", ()):
                if row.get("job") != job.job_id:
                    continue
                prof = row.get("exec") or row.get("lat")
                if prof and prof.get("n"):
                    means[row["cls"]] = prof["sum"] / prof["n"]
        except Exception:
            means = {}
    totals = None
    try:
        from parsec_tpu_torch.prof.liveattr import class_totals
        totals = class_totals(job.taskpool)
    except Exception:
        pass
    return means, totals


# ---------------------------------------------------------------------------
# the fabric itself
# ---------------------------------------------------------------------------

class ServingFabric(JobService):
    """JobService grown into a multi-tenant serving fabric: disjoint
    per-job device subsets, predictive SLO admission, elastic
    capacity, and a fully journaled decision trail."""

    #: class-level defaults so the dispatcher thread — started by
    #: JobService.__init__ BEFORE this subclass finishes initializing
    #: — sees a consistent (inert) fabric on its first ticks
    _carver: Optional[MeshCarver] = None
    _elastic = False
    _preempt_enable = False
    _health_enable = False
    _health_drained: frozenset = frozenset()

    def __init__(self, context=None, **kw):
        super().__init__(context, **kw)
        self._carver = MeshCarver(self.context.accelerator_spaces())
        self._profiles = FabricProfiles()
        #: chip count a SHARED (no exclusive ask) job is quoted at:
        #: the whole accelerator mesh, or the worker streams on a
        #: host-only context
        self._chips_shared = max(1, len(self._carver.spaces)
                                 or len(self.context.streams))
        self._devices_default = int(params.get("fabric_devices_default",
                                               0))
        self._slo_policy = str(params.get("fabric_slo_policy", "queue"))
        self._depri_penalty = int(params.get("fabric_depri_penalty", 8))
        self._preempt_enable = bool(int(params.get(
            "fabric_preempt_enable", 1)))
        self._elastic = bool(int(params.get("fabric_elastic", 1)))
        #: job_id -> count of STALE pool terminations to absorb: a
        #: preemption cancels the victim's pool, whose termination
        #: callback would otherwise walk the re-queued (PENDING) job
        #: into DONE through _finish (guarded-by: _lock)
        self._preempted: Dict[int, int] = {}
        self.preemptions = 0
        #: predictive health consumption (prof/health.py): ranks the
        #: fabric pre-emptively drained, and the below-threshold
        #: stopwatch feeding the sustain window (guarded-by: _lock)
        self._drain_score = float(params.get("fabric_drain_score", 0.5))
        self._drain_sustain = float(params.get("fabric_drain_sustain_s",
                                               3.0))
        self._undrain_score = float(params.get("fabric_undrain_score",
                                               0.8))
        self._health_drained = set()
        self._below_since: Dict[int, float] = {}
        self._health_next = 0.0
        self.drains = 0
        self._health_enable = bool(int(params.get(
            "fabric_health_enable", 1)))

    # -- submission: quote + verdict --------------------------------------
    def submit(self, factory, *, priority: int = 0,
               deadline: Optional[float] = None, client: str = "",
               name: str = "", block: bool = False,
               timeout: Optional[float] = None,
               slo: Optional[float] = None,
               devices: Optional[int] = None,
               devices_max: int = 0, resumable: bool = False,
               app: str = "", slo_policy: str = "") -> JobHandle:
        """Admit with a makespan quote.  ``slo`` is the declared
        completion budget in seconds from submission; ``devices`` the
        exclusive-subset ask (0/None = temporal sharing, clamped to
        the mesh); ``devices_max`` the elastic growth ceiling;
        ``resumable`` opts the job into preemption (its factory is
        kept and re-run on resume); ``app`` keys the learned profile
        (defaults to the job name)."""
        want = int(self._devices_default if devices is None else devices)
        want = max(0, min(want, len(self._carver.spaces)))
        key = app or name or getattr(factory, "__name__", "job")
        chips = want if want > 0 else self._chips_shared
        quote = self._profiles.quote(key, chips)
        # predictive admission against the health plane: a quote onto
        # a DEGRADING gang inflates by the worst live rank's smoothed
        # score, so the existing SLO policy machinery deprioritizes /
        # queues / rejects placements a degrading rank would slow —
        # before anything fails
        health = self._gang_health()
        if quote is not None and health < 1.0:
            quote = round(quote / max(health, 0.05), 6)
        policy = slo_policy or self._slo_policy
        verdict = "admit"
        eff_priority = int(priority)
        over = (slo is not None and quote is not None
                and quote > float(slo))
        if over:
            if policy == "reject":
                jid = next(self._seq)
                jr = getattr(self.context, "journal", None)
                if jr is not None:
                    jr.emit("fabric_quote", job=jid, eta=quote, app=key,
                            chips=chips, slo=float(slo), health=health)
                    jr.emit("fabric_admit", job=jid, verdict="reject",
                            eta=quote, slo=float(slo))
                raise AdmissionError(
                    f"quoted makespan {quote:.3f}s exceeds SLO "
                    f"{float(slo):g}s (policy=reject)")
            if policy == "deprioritize":
                verdict = "deprioritize"
                eff_priority -= self._depri_penalty
            else:
                verdict = "queue"
        # stamp the fabric fields UNDER the service lock: the
        # dispatcher must never pick a job whose device ask / SLO it
        # cannot see yet (the lock is reentrant; a blocking admission
        # wait fully releases it inside Condition.wait)
        with self._lock:
            job = super().submit(factory, priority=eff_priority,
                                 deadline=deadline, client=client,
                                 name=name, block=block, timeout=timeout)
            job.slo = None if slo is None else float(slo)
            job.devices_want = want
            job.devices_max = max(want, int(devices_max or 0))
            job.resumable = bool(resumable)
            job.app_key = key
            job.quote_eta = quote
            job.verdict = verdict
        jr = getattr(self.context, "journal", None)
        if jr is not None:
            jr.emit("fabric_quote", job=job.job_id, eta=quote, app=key,
                    chips=chips, slo=job.slo, health=health)
            jr.emit("fabric_admit", job=job.job_id, verdict=verdict,
                    eta=quote, slo=job.slo)
        return job

    # -- placement-aware dispatch -----------------------------------------
    def _pick_job(self, now_mono: float) -> Optional[JobHandle]:
        """Aged-priority order, but placement-aware (lock held): an
        exclusive ask dispatches only when its subset carves; a
        blocked exclusive job does NOT head-of-line-block the shared
        tenants behind it (temporal sharing of the remainder).  When
        the top ask cannot carve and preemption is armed, a
        lower-priority resumable tenant is preempted mid-DAG."""
        if self._carver is None:        # dispatcher beat __init__
            return None
        self._health_tick(now_mono)
        if self._pending and len(self._running) < self._max_active:
            order = sorted(self._pending,
                           key=lambda j: self._score(j, now_mono),
                           reverse=True)
            for job in order:
                want = int(getattr(job, "devices_want", 0) or 0)
                if want <= 0:
                    # deliberate difference: a shared job shares the
                    # UNRESERVED remainder, so it waits while exclusive
                    # leases hold the whole mesh — on a one-card host,
                    # while the card is leased (the JAX package
                    # dispatches it onto leased devices).  A context
                    # with no accelerator shares its host
                    if self._carver.spaces \
                            and not self._carver.free_count():
                        continue
                    self._place(job, None)
                    return job
                lease = self._carver.carve(job.job_id, want)
                if lease is None and self._preempt_enable \
                        and job.slo is not None:
                    victim = self._pick_victim(job)
                    if victim is not None and self._preempt(victim,
                                                            job):
                        lease = self._carver.carve(job.job_id, want)
                if lease is not None:
                    self._place(job, lease)
                    return job
        self._elastic_grow()
        return None

    def _place(self, job: JobHandle, lease) -> None:
        """Record one placement outcome (lock held).  A re-placement
        after a preemption is the RESUME leg of the round-trip.  The
        ``ranks`` field stamps the gang the placement targets — live
        ranks minus the health-drained set — which is exactly what
        the auditor's H1 invariant replays: a drained rank must never
        appear in a subsequent placement's gang."""
        jr = getattr(self.context, "journal", None)
        if job.preempted_at is not None:
            job.preempted_at = None
            if jr is not None:
                jr.emit("fabric_resume", job=job.job_id)
        if lease is not None:
            job.devices = tuple(lease)
            if jr is not None:
                jr.emit("fabric_place", job=job.job_id,
                        devices=list(lease), shared=False,
                        ranks=self._gang_ranks())
        else:
            job.devices = None
            if jr is not None:
                jr.emit("fabric_place", job=job.job_id, devices=[],
                        shared=True, ranks=self._gang_ranks())

    # -- predictive health: deprioritize, then drain before death ---------
    def _gang_ranks(self) -> List[int]:
        """The placement-target gang: the context's ranks minus dead
        peers minus the health-drained set."""
        ctx = self.context
        comm = getattr(ctx, "comm", None)
        ce = getattr(comm, "ce", None) if comm is not None else None
        dead = getattr(ce, "dead_peers", None) or set()
        return [r for r in range(max(1, int(getattr(ctx, "nranks", 1))))
                if r not in dead and r not in self._health_drained]

    def _health_monitor(self):
        m = getattr(self.context, "metrics", None)
        return getattr(m, "_health", None) if m is not None else None

    def _gang_health(self) -> float:
        """Minimum smoothed health score across the live gang (1.0
        with no monitor / no observations).  Drained ranks are no
        longer placement targets, so they stop taxing quotes."""
        if not self._health_enable:
            return 1.0
        hm = self._health_monitor()
        if hm is None:
            return 1.0
        try:
            snap = hm.snapshot()
        except Exception:
            return 1.0
        vals = [e["ewma"] for r, e in snap.items()
                if r not in self._health_drained]
        return round(min(vals), 4) if vals else 1.0

    def _health_tick(self, now: float) -> None:
        """One rate-limited health consumption pass (lock held, on
        the dispatcher tick — never the task hot path): start/stop
        the below-threshold stopwatch per rank, fire the pre-emptive
        drain once the score stays below ``fabric_drain_score`` for
        ``fabric_drain_sustain_s``, lift it on sustained recovery."""
        if not self._health_enable or now < self._health_next:
            return
        self._health_next = now + 0.25
        hm = self._health_monitor()
        if hm is None:
            return
        try:
            snap = hm.refresh()
        except Exception:
            return
        my = int(getattr(self.context, "rank", 0))
        for r, ent in snap.items():
            if r == my:
                continue        # a rank cannot drain itself
            ewma = float(ent.get("ewma", 1.0))
            if r in self._health_drained:
                if ewma >= self._undrain_score:
                    self._undrain(r, ewma)
                continue
            if ewma < self._drain_score:
                since = self._below_since.setdefault(r, now)
                if now - since >= self._drain_sustain:
                    self._drain(r, ewma, hm)
            else:
                self._below_since.pop(r, None)

    # holds-lock: _lock
    def _drain(self, rank: int, ewma: float, hm) -> None:
        """Journaled pre-emptive drain: the decision carries its
        below-threshold evidence (the score series tail), the rank
        leaves the placement gang, and resumable tenants migrate off
        it through the existing preempt/resume machinery (their
        resume leg re-places onto the post-drain gang; the recovery
        plane's shrink path remains the backstop if the rank does
        die).  Fires strictly before the heartbeat detector: the
        whole point is to beat ``comm_peer_timeout_s``."""
        self._health_drained.add(rank)
        self._below_since.pop(rank, None)
        self.drains += 1
        evidence = []
        try:
            evidence = hm.evidence(rank)
        except Exception:
            pass
        jr = getattr(self.context, "journal", None)
        if jr is not None:
            jr.emit("health_drain", peer=rank, score=round(ewma, 4),
                    thr=self._drain_score,
                    sustain_s=round(self._drain_sustain, 3),
                    evidence=evidence)
        debug_verbose(1, "fabric: pre-emptive drain of rank %d "
                      "(score %.3f < %.3f sustained)", rank, ewma,
                      self._drain_score)
        self._migrate_off(rank)

    # holds-lock: _lock
    def _migrate_off(self, rank: int) -> None:
        """Migrate what can move: resumable running tenants preempt
        (cancel + re-queue with factory intact — the datarepo
        snapshot substrate keeps their materialized tiles) so their
        resume placement lands on the post-drain gang.  Non-resumable
        tenants run to completion — a drain stops NEW placement, it
        does not kill in-flight work."""
        for job in list(self._running.values()):
            if getattr(job, "resumable", False) \
                    and job.taskpool is not None \
                    and job.status() == JobStatus.RUNNING:
                self._preempt(job, job)

    # holds-lock: _lock
    def _undrain(self, rank: int, ewma: float) -> None:
        self._health_drained.discard(rank)
        jr = getattr(self.context, "journal", None)
        if jr is not None:
            jr.emit("health_undrain", peer=rank, score=round(ewma, 4))
        debug_verbose(1, "fabric: rank %d recovered (score %.3f); "
                      "drain lifted", rank, ewma)

    def _pick_victim(self, job: JobHandle) -> Optional[JobHandle]:
        """Lowest-priority RUNNING tenant that is resumable, holds an
        exclusive lease, and ranks strictly below the contender."""
        cands = [j for j in self._running.values()
                 if getattr(j, "resumable", False)
                 and j.priority < job.priority
                 and j.taskpool is not None
                 and j.status() == JobStatus.RUNNING
                 and self._carver.lease(j.job_id)]
        return min(cands, key=lambda j: (j.priority, j.job_id)) \
            if cands else None

    # holds-lock: _lock
    def _preempt(self, victim: JobHandle, by: JobHandle) -> bool:
        """Preempt a running tenant mid-DAG (lock held): cancel its
        pool (remaining tasks are discarded; the collections its
        factory closes over keep every tile already materialized —
        the datarepo snapshot substrate recovery restores from), free
        its subset, and re-queue the job PENDING with its factory
        intact for the resume leg.  False when the victim beat us to a
        terminal state (its _finish already set DONE before taking the
        lock) — nothing was touched."""
        if not victim._to(JobStatus.PENDING):   # RUNNING -> PENDING
            return False
        self._preempted[victim.job_id] = \
            self._preempted.get(victim.job_id, 0) + 1
        victim.preemptions += 1
        self.preemptions += 1
        victim.preempted_at = time.monotonic()
        self._running.pop(victim.job_id, None)
        lease = self._carver.release(victim.job_id)
        tp = victim.taskpool
        victim.taskpool = None
        victim.devices = None
        victim._result_fn = None
        self._pending.append(victim)
        jr = getattr(self.context, "journal", None)
        if jr is not None:
            jr.emit("fabric_preempt", job=victim.job_id, by=by.job_id)
            jr.emit("fabric_release", job=victim.job_id,
                    devices=list(lease), cause="preempt")
        debug_verbose(2, "fabric: preempted %s for %s (freed %s)",
                      victim.name, by.name, list(lease))
        if tp is not None:
            # safe under the reentrant lock (same precedent as the
            # deadline sweep); the stale termination is absorbed by
            # the _preempted count in _finish
            tp.cancel()
        self._work.notify_all()
        return True

    # -- branding: the carve stamp ----------------------------------------
    def _brand(self, tp, job: JobHandle) -> None:
        super()._brand(tp, job)
        tp.device_spaces = (frozenset(job.devices)
                            if job.devices else None)

    # -- completion: absorb stale terminations, free the lease ------------
    def _finish(self, job: JobHandle) -> None:
        with self._lock:
            n = self._preempted.get(job.job_id, 0)
            if n:
                if n == 1:
                    self._preempted.pop(job.job_id, None)
                else:
                    self._preempted[job.job_id] = n - 1
                absorb = True
            else:
                absorb = False
        if absorb:
            debug_verbose(2, "fabric: %s preempted; stale pool "
                          "termination absorbed", job.name)
            return
        super()._finish(job)

    def _release_job(self, job: JobHandle) -> None:
        """The job left the running set (lock held): return its subset
        to the free list, journal the release, fold the measured run
        into the app profile, and let waiting tenants grow/place."""
        if self._carver is None:
            return
        lease = self._carver.release(job.job_id)
        if lease:
            jr = getattr(self.context, "journal", None)
            if jr is not None:
                jr.emit("fabric_release", job=job.job_id,
                        devices=list(lease), cause="done")
        if job.status() == JobStatus.DONE and job.started_at \
                and job.finished_at:
            makespan = job.finished_at - job.started_at
            chips = len(lease) if lease else self._chips_shared
            means, totals = _job_class_stats(self.context, job)
            self._profiles.observe(getattr(job, "app_key", job.name),
                                   makespan, chips, totals, means)
        job.devices = None
        self._elastic_grow()
        self._work.notify_all()

    # -- elastic capacity --------------------------------------------------
    def _elastic_grow(self) -> None:
        """Grow running tenants toward their devices_max ceiling from
        the free list (lock held), highest-priority first."""
        if not self._elastic or not self._carver.free_count():
            return
        for job in sorted(self._running.values(),
                          key=lambda j: -j.priority):
            ceiling = int(getattr(job, "devices_max", 0) or 0)
            cur = self._carver.lease(job.job_id)
            if not cur or ceiling <= len(cur):
                continue
            added = self._carver.grow(job.job_id,
                                      ceiling - len(cur))
            if not added:
                continue
            job.devices = self._carver.lease(job.job_id)
            self._restamp(job)
            jr = getattr(self.context, "journal", None)
            if jr is not None:
                jr.emit("fabric_resize", job=job.job_id,
                        devices=list(job.devices), delta=len(added),
                        cause="grow")
            if not self._carver.free_count():
                return

    def device_dead(self, space: int) -> Optional[int]:
        """A device died: evict it from the mesh; the owning tenant's
        subset shrinks IN PLACE (its pool keeps running on what is
        left — the elastic counterpart of peer-death containment).
        Returns the affected job id, or None."""
        with self._lock:
            owner = self._carver.evict(space)
            self._chips_shared = max(1, len(self._carver.spaces)
                                     or len(self.context.streams))
            if owner is None:
                return None
            job = self._running.get(owner) or self._jobs.get(owner)
            if job is not None:
                job.devices = self._carver.lease(owner) or None
                self._restamp(job)
                jr = getattr(self.context, "journal", None)
                if jr is not None:
                    jr.emit("fabric_resize", job=owner,
                            devices=list(job.devices or ()), delta=-1,
                            cause="device_dead")
            return owner

    def _restamp(self, job: JobHandle) -> None:
        """Re-stamp a resized subset onto the live pool tree (plain
        attribute store; best_device reads it per dispatch)."""
        tp = job.taskpool
        if tp is None:
            return
        from parsec_tpu_torch.core.taskpool import Compound
        stack = [tp]
        while stack:
            p = stack.pop()
            p.device_spaces = (frozenset(job.devices)
                               if job.devices else None)
            if isinstance(p, Compound):
                stack.extend(p.pools)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        st = super().stats()
        with self._lock:
            st["fabric"] = {
                "mesh": list(self._carver.spaces),
                "free": self._carver.free_count(),
                "fragmentation": round(self._carver.fragmentation(), 4),
                "leases": {str(o): list(l) for o, l in
                           self._carver.leases().items()},
                "preemptions": self.preemptions,
                "drains": self.drains,
                "drained_ranks": sorted(self._health_drained),
                "gang_health": self._gang_health(),
            }
        return st

    def queue_position(self, job_id: int) -> Optional[int]:
        """0-based dispatch-order position of a pending job (by the
        dispatcher's aged-priority score), None when not pending."""
        with self._lock:
            now = time.monotonic()
            order = sorted(self._pending,
                           key=lambda j: self._score(j, now),
                           reverse=True)
            for i, j in enumerate(order):
                if j.job_id == job_id:
                    return i
        return None
