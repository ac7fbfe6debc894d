"""Flight recorder: a bounded ring of causal events, dumped on failure.

The causal tracer answers "what just happened" but costs a large share
of the task rate and must be armed BEFORE the incident.  The production
pattern (a resident service) is the inverse: a cheap,
continuously-overwritten ring of the last N causal-class events —
comm flow edges (send/recv/deliver with correlation ids), device
dispatch spans, DTD lane transitions — that is dumped automatically
AFTER a failure is detected:

* ``Context.record_pool_error`` / PeerFailedError containment /
  the hang autopsy / a job-SLO breach (prof/metrics.py) / a recovery
  start or full-replay fallback (core/recovery.py) / a live straggler
  (prof/liveattr.py) all call ``Context.telemetry_incident``, which
  lands here;
* the dump writes this rank's ring as a standard ``.ptt`` (rank +
  TAG_CLOCK offsets in the header, exactly like a causal trace) into
  the incident bundle directory, appends a manifest line, and
  broadcasts TAG_FLIGHT so live peers dump their rings into the same
  bundle — ``prof/critpath.merge_traces`` then opens the bundle
  unchanged (row dicts, no pandas);
* the event encodings ARE prof/causal.py's: FlightRecorder subclasses
  CausalTracer, swapping the unbounded Profile for a ring-backed one
  and installing only the cheap hooks (no queue-wait stamping, no exec
  intervals; dep/dtd points ride a sampling gate) so the armed steady
  state stays cheap.

The port's ring dump replays the ring through a real ``Profile``, whose
streams write through the native trace sink (``native/pinsext.c``), so a
bundle's ``.ptt`` files are byte-compatible with every other trace.

Arm with ``PARSEC_MCA_FLIGHTREC_ENABLED=1`` (knobs: ring size, bundle
directory, recorded classes, sampling, re-dump interval).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from parsec_tpu_torch.prof.causal import COMM_STREAM, CausalTracer
from parsec_tpu_torch.prof.profiling import EV_END, EV_START, EventClass, Profile
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import warning

params.register("flightrec_enabled", 0,
                "arm the crash-dump flight recorder on every Context: a "
                "bounded ring of causal-class events (comm flow edges, "
                "device spans, DTD lane ops) continuously overwritten "
                "and dumped to a merged-openable incident bundle when "
                "containment, the hang autopsy, or an SLO breach fires")
params.register("flightrec_ring", 65536,
                "flight-recorder ring capacity in EVENTS (bounded "
                "memory: oldest events are overwritten; at comm-frame "
                "rates the default holds the last tens of seconds)")
params.register("flightrec_dir", "",
                "incident bundle directory shared by every rank "
                "(default: <tmpdir>/parsec-flightrec); each incident "
                "dump writes rank<N>.ptt here plus a line in "
                "incidents.jsonl")
params.register("flightrec_classes", "comm,device,dtd",
                "event classes the recorder captures: comm (send/recv/"
                "deliver flow edges), device (dispatch->done spans), "
                "dtd (lane/surrogate points), deps (local dep_edge "
                "points; off by default — the densest class)")
params.register("flightrec_sample", 1,
                "sampling stride for the dense point classes (dtd, "
                "deps): 1 records every event, N one in N; comm flow "
                "edges are never sampled so send/deliver pairs match "
                "in the merged bundle")
params.register("flightrec_min_interval_s", 30.0,
                "minimum seconds between incident dumps on one rank "
                "(a failure storm re-dumps at most this often; the "
                "first dump of each quiet period wins)")


class _RingStream:
    """StreamBuffer-shaped writer appending into the shared ring (pure
    Python: the ring is the bounded store, not the native sink)."""

    __slots__ = ("stream_id", "name", "_ring", "_now")

    def __init__(self, stream_id: int, name: str, ring: deque):
        self.stream_id = stream_id
        self.name = name
        self._ring = ring
        self._now = time.perf_counter

    def trace(self, key: int, flags: int, taskpool_id: int, event_id: int,
              object_id: int = 0, info: Any = None,
              timestamp: Optional[float] = None) -> None:
        # deque.append with maxlen is a single atomic op under the GIL:
        # the ring takes no lock on the hot path
        self._ring.append((self.stream_id, key, flags, taskpool_id,
                           event_id, object_id,
                           timestamp if timestamp is not None
                           else self._now(), info))

    def interval(self, key: int, taskpool_id: int, event_id: int,
                 object_id: int, t_begin: float) -> None:
        self._ring.append((self.stream_id, key, EV_START, taskpool_id,
                           event_id, object_id, t_begin, None))
        self._ring.append((self.stream_id, key, EV_END, taskpool_id,
                           event_id, object_id, self._now(), None))


class RingProfile(Profile):
    """A Profile whose streams write into ONE bounded ring; ``dump``
    replays the ring snapshot through a real Profile so the on-disk
    format (and every reader: prof/reader, critpath) is
    identical to a causal trace."""

    def __init__(self, maxlen: int, hr_id: str = "flightrec"):
        super().__init__(hr_id)
        self._ring: deque = deque(maxlen=max(256, maxlen))

    def stream(self, stream_id: int, name: str = ""):
        with self._lock:
            sb = self._streams.get(stream_id)
            if sb is None:
                sb = _RingStream(stream_id, name or f"stream-{stream_id}",
                                 self._ring)
                self._streams[stream_id] = sb
            return sb

    def dump(self, path: str) -> str:
        events = list(self._ring)          # one consistent snapshot
        with self._lock:
            dico = list(self._dict.values())
            names = {sid: sb.name for sid, sb in self._streams.items()}
            info = dict(self._info)
        p = Profile(self.hr_id)
        p._info.update(info)
        p._dict = {ec.name: EventClass(ec.name, ec.key, ec.attributes)
                   for ec in dico}
        for sid, key, flags, tpid, eid, oid, ts, evinfo in events:
            sb = p.stream(sid, names.get(sid, ""))
            sb.events.append((key, flags, tpid, eid, oid, ts, evinfo))
        return p.dump(path)

    def __len__(self) -> int:
        return len(self._ring)


class FlightRecorder(CausalTracer):
    """CausalTracer encodings over a ring profile, with only the cheap
    hooks installed and an ``incident`` dump path."""

    def __init__(self, context):
        ring = int(params.get("flightrec_ring", 65536))
        super().__init__(RingProfile(ring), rank=context.rank)
        self.context = context
        self.classes = {c.strip() for c in
                        str(params.get("flightrec_classes",
                                       "comm,device,dtd")).split(",")
                        if c.strip()}
        self._sample = max(1, int(params.get("flightrec_sample", 1)))
        self._sn = 0
        raw_dir = str(params.get("flightrec_dir", "") or "").strip()
        self.bundle_dir = raw_dir or os.path.join(
            tempfile.gettempdir(), "parsec-flightrec")
        self._min_interval = float(params.get("flightrec_min_interval_s",
                                              30.0))
        self._inc_lock = threading.Lock()
        self._last_inc = -float("inf")   # guarded-by: _inc_lock
        self.incidents = 0
        self.last_bundle: Optional[str] = None
        #: comm-engine counter baseline for the incident WINDOW: the
        #: bundle records stats deltas since arm (or the previous
        #: dump), not lifetime totals — a straggler incident carries
        #: its own comm context
        self._comm_base: Optional[Dict[str, float]] = None
        self._comm_base_at = time.monotonic()

    # -- lifecycle (override: only the cheap hooks) ----------------------
    def install(self, context) -> "FlightRecorder":
        self.rank = context.rank
        self.context = context
        context._flightrec = self
        context._recompute_ready_stamp()   # device-span gate
        try:
            # surface a misconfigured bundle dir at ARM time: an
            # incident pointing the autopsy at an unwritable path
            # would only warn after the fact
            os.makedirs(self.bundle_dir, exist_ok=True)
        except OSError as exc:
            warning("flight recorder: bundle dir %s is not writable "
                    "(%s) — incident dumps WILL fail; fix "
                    "flightrec_dir", self.bundle_dir, exc)
        if "device" in self.classes:
            context.pins_register("device_dispatch", self._dev_dispatch)
            context.pins_register("device_done", self._dev_done)
        if "deps" in self.classes:
            context.pins_register("deliver_dep", self._deliver_dep)
        self.attach_comm(context.comm)
        self._comm_base = self._comm_scalars()
        self._comm_base_at = time.monotonic()
        return self

    def uninstall(self, context) -> None:
        if getattr(context, "_flightrec", None) is self:
            context._flightrec = None
            context._recompute_ready_stamp()
        if "device" in self.classes:
            context.pins_unregister("device_dispatch", self._dev_dispatch)
            context.pins_unregister("device_done", self._dev_done)
        if "deps" in self.classes:
            context.pins_unregister("deliver_dep", self._deliver_dep)
        comm = getattr(context, "comm", None)
        if comm is not None and getattr(comm, "flightrec", None) is self:
            comm.flightrec = None
        ce = getattr(comm, "ce", None) if comm is not None else None
        if ce is not None and ce.on_flight_dump == self._remote_dump:
            # a detached recorder must not answer TAG_FLIGHT dumps
            ce.on_flight_dump = None

    def attach_comm(self, comm) -> None:
        """Wire the comm layer (either install order: recorder first or
        RemoteDepEngine first — remote_dep.__init__ calls this too)."""
        if comm is None:
            return
        if "comm" in self.classes:
            comm.flightrec = self
        ce = getattr(comm, "ce", None)
        if ce is not None:
            ce.on_flight_dump = self._remote_dump

    # -- sampling gate for the dense point classes -----------------------
    def _sampled(self) -> bool:
        self._sn += 1            # racy under threads: approximate stride
        return self._sn % self._sample == 0

    def _deliver_dep(self, es, event, payload) -> None:
        if self._sampled():
            super()._deliver_dep(es, event, payload)

    def dtd_event(self, op: str, tile, lane, ver: int, val=None) -> None:
        if "dtd" in self.classes and self._sampled():
            super().dtd_event(op, tile, lane, ver, val)

    # -- incident dump ---------------------------------------------------
    def incident(self, reason: str, broadcast: bool = True) -> Optional[str]:
        """Dump this rank's ring into the bundle directory (rate-limited)
        and — when ``broadcast`` — ask live peers over TAG_FLIGHT to do
        the same, so the bundle merges into one clock-aligned timeline.

        The dump runs on its OWN non-daemon thread: containment often
        fires on the comm loop thread, and stalling that loop for file
        I/O would starve the very heartbeats whose failure is being
        recorded (peers could declare US dead mid-dump); non-daemon so
        a failing worker process still finishes the write before exit.
        The bundle path is deterministic, so it is returned (and kept
        as ``last_bundle``) immediately."""
        now = time.monotonic()
        with self._inc_lock:
            if now - self._last_inc < self._min_interval:
                return self.last_bundle
            self._last_inc = now
        self.last_bundle = self.bundle_dir
        t = threading.Thread(target=self._dump_async,
                             args=(reason, broadcast),
                             name="flightrec-dump", daemon=False)
        try:
            t.start()
        except RuntimeError:   # interpreter teardown: last-ditch inline
            self._dump_async(reason, broadcast)
        return self.bundle_dir

    def _dump_async(self, reason: str, broadcast: bool) -> None:
        try:
            self._dump(reason)
        except Exception as exc:   # the dump must never re-raise
            warning("flight recorder: dump failed: %s", exc)
            with self._inc_lock:
                # give the rate-limit window back: a transient write
                # failure must not suppress the NEXT incident's dump
                self._last_inc = -float("inf")
            return
        if broadcast:
            self._broadcast(reason)

    def _dump(self, reason: str) -> str:
        os.makedirs(self.bundle_dir, exist_ok=True)
        ctx = self.context
        if ctx is not None:
            self.finalize(ctx)     # rank + nranks + clock offsets header
            jr = getattr(ctx, "journal", None)
            if jr is not None:
                # the control-plane story lands NEXT TO the data-plane
                # ring: every incident bundle carries this rank's
                # protocol journal (journal-rank<N>.jsonl), so the
                # journal auditor (parsec_tpu_torch.tools.journal_audit)
                # reconstructs the recovery rounds behind the incident
                # from the same directory
                try:
                    jr.dump(self.bundle_dir)
                except OSError as exc:
                    warning("flight recorder: journal dump failed: %s",
                            exc)
        self.profile.add_information("flightrec_reason", reason)
        out = os.path.join(self.bundle_dir, f"rank{self.rank}.ptt")
        self.profile.dump(out)
        self._dump_health(reason)
        with open(os.path.join(self.bundle_dir, "incidents.jsonl"),
                  "a") as fh:
            fh.write(json.dumps({
                "rank": self.rank, "reason": reason,
                "wall": time.time(), "events": len(self.profile),
            }) + "\n")
        self.incidents += 1
        self.last_bundle = self.bundle_dir
        warning("flight recorder: rank %d dumped %d events to incident "
                "bundle %s (%s)", self.rank, len(self.profile),
                self.bundle_dir, reason)
        return self.bundle_dir

    def _comm_scalars(self) -> Dict[str, float]:
        """Numeric comm-engine counters (best-effort snapshot)."""
        ctx = self.context
        comm = getattr(ctx, "comm", None) if ctx is not None else None
        if comm is None:
            return {}
        try:
            st = comm.stats()
        except Exception:
            return {}
        return {k: float(v) for k, v in st.items()
                if isinstance(v, (int, float))
                and not isinstance(v, bool)}

    def _dump_health(self, reason: str) -> None:
        """Write ``health-rank<N>.json`` next to the ring: the health
        plane's per-rank score time-series (prof/health.py) plus the
        comm-engine stats DELTAS for the incident window — the two
        planes that say why the incident happened, not just what.
        Best-effort: neither plane being armed skips the file."""
        cur = self._comm_scalars()
        base = self._comm_base or {}
        now = time.monotonic()
        delta = {k: round(v - base.get(k, 0.0), 6)
                 for k, v in cur.items() if v != base.get(k, 0.0)}
        series: Dict[Any, Any] = {}
        scores: Dict[Any, Any] = {}
        m = getattr(self.context, "metrics", None) \
            if self.context is not None else None
        hm = getattr(m, "_health", None) if m is not None else None
        if hm is not None:
            try:
                series = hm.series_snapshot()
                scores = hm.snapshot()
            except Exception:
                pass
        if not cur and not series:
            return
        doc = {"rank": self.rank, "reason": reason, "wall": time.time(),
               "comm_window_s": round(now - self._comm_base_at, 3),
               "comm_delta": delta,
               "health": {str(r): ent for r, ent in scores.items()},
               "health_series": {str(r): pts
                                 for r, pts in series.items()}}
        try:
            with open(os.path.join(self.bundle_dir,
                                   f"health-rank{self.rank}.json"),
                      "w") as fh:
                json.dump(doc, fh)
        except OSError as exc:
            warning("flight recorder: health snapshot failed: %s", exc)
            return
        # rebase: the NEXT incident's window starts here
        self._comm_base = cur
        self._comm_base_at = now

    def _broadcast(self, reason: str) -> None:
        ctx = self.context
        comm = getattr(ctx, "comm", None) if ctx is not None else None
        ce = getattr(comm, "ce", None) if comm is not None else None
        if ce is None:
            return
        from parsec_tpu_torch.comm.engine import TAG_FLIGHT
        for r in range(ce.nranks):
            if r == ce.rank or r in ce.dead_peers:
                continue
            try:
                ce.send_am(TAG_FLIGHT, r,
                           {"reason": f"rank {ce.rank}: {reason}"})
            except OSError:
                pass   # a dead peer cannot dump anyway

    def _remote_dump(self, reason: str) -> None:
        """TAG_FLIGHT handler target (engine.py posts it off-loop)."""
        self.incident(reason, broadcast=False)


def install_flight_recorder(context) -> FlightRecorder:
    return FlightRecorder(context).install(context)


# ---------------------------------------------------------------------------
# CLI: summarize an incident bundle
# ---------------------------------------------------------------------------

def summarize_bundle(path: str) -> Dict[str, Any]:
    """Merge a bundle's per-rank rings (clock-aligned) and report flow
    coverage."""
    import glob
    from parsec_tpu_torch.prof.critpath import matched_flows, merge_traces
    traces = sorted(glob.glob(os.path.join(path, "rank*.ptt")))
    if not traces:
        raise FileNotFoundError(f"no rank*.ptt traces under {path!r}")
    rows, metas = merge_traces(traces)
    if rows:
        sends, recvs, matched = matched_flows(rows)
    else:   # a ring with no events of interest dumps an empty trace
        sends = recvs = matched = 0
    incidents: List[dict] = []
    manifest = os.path.join(path, "incidents.jsonl")
    if os.path.exists(manifest):
        with open(manifest) as fh:
            incidents = [json.loads(line) for line in fh if line.strip()]
    return {"traces": traces, "ranks": sorted(metas), "events": len(rows),
            "flows": {"sends": sends, "recvs": recvs, "matched": matched},
            "incidents": incidents}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="summarize a flight-recorder incident bundle")
    ap.add_argument("bundle", help="incident bundle directory")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    out = summarize_bundle(args.bundle)
    if args.json:
        print(json.dumps(out))
        return 0
    print(f"bundle {args.bundle}: ranks {out['ranks']}, "
          f"{out['events']} events")
    f = out["flows"]
    print(f"flow edges: {f['matched']} matched of {f['sends']} sends / "
          f"{f['recvs']} recvs")
    for inc in out["incidents"]:
        print(f"  incident: rank {inc['rank']} — {inc['reason']} "
              f"({inc['events']} events)")
    print("critical path: python -m parsec_tpu_torch.prof.critpath "
          + " ".join(out["traces"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
