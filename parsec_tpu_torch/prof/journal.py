"""Control-plane black box: an always-on structured protocol journal.

The data plane is well-observed (causal traces, /metrics, the flight
recorder's event ring, live attribution) — but the runtime's hardest
bugs live in its *protocols*: the multi-round distributed control
plane grew (dead-set agreement, replay mode votes, DTD
insert-stream skip agreement, bounded need negotiation, the
retirement handshake, TAG_REJOIN incarnation fencing, epoch fences,
barrier generations) has documented residual failure modes — the
coordinator dying mid-handshake silently degrades the retirement
quorum to the grace window — that no existing surface records: when a
recovery round goes sideways there is no record of who voted what, in
which round, under which epoch.

This module is that record.  Same engineering discipline as the
metrics registry (prof/metrics.py):

* a ``Journal`` is installed on EVERY Context (``journal_enabled``,
  default 1): a bounded ring of small dicts, appended with one
  ``deque.append`` under the GIL (lock-free, no spill) plus a
  ``perf_counter`` stamp — the same timeline TAG_CLOCK aligns, so
  per-rank journals merge onto rank 0's clock exactly like traces;
* every emit site is CONTROL-PLANE code (recovery rounds, termdet
  rewinds, rejoin handshakes, barrier generations, job lifecycle
  decisions) — there are no per-task emits, so the C ``run_quantum``
  fast path never crosses this module (the journal-overhead gate
  proves it);
* each event carries the common stamps (rank, incarnation epoch,
  monotonic seq) plus the schema'd protocol fields below — pool
  run_epoch, round id, peer set — so the offline auditor
  (JAX package's tools/journal_audit.py) can check protocol INVARIANTS instead of
  eyeballing logs;
* journals are pulled cross-rank over the job port (``{"op":
  "journal"}`` — the pull rides the TAG_METRICS control lane, zero
  new wire tags) and every flight-recorder incident bundle includes
  ``journal-rank<N>.jsonl`` next to the event ring, so an incident
  dump carries the control-plane story next to the data-plane one.

In the port: the journal is installed on every Context at
``journal_enabled`` 1, as in the JAX package, and dumped at
``Context.fini`` under ``journal_dir``.  The emit sites of the JAX
package live in its comm, recovery and service layers; the port carries
the comm layer's (barrier rounds, peer deaths, excusals, the Safra
reconcile), the recovery plane's (core/recovery.py: dead-set agreement,
epoch fences, mode votes, the DTD skip agreement's ``skip_offer`` and
``skip_cut``, retirement, the rejoin handshake's ``rejoin_req`` and
``rejoin_done``), the job service's (``service_state``, the recovery
notices among them) and the health plane's ``health_transition``; the
hang autopsy prints the clock-aligned tail (``journal_autopsy_tail``),
and ``cluster_journals`` pulls the peers' snapshots over the comm
engine's TAG_METRICS lane.  One deliberate difference: at
``journal_enabled`` 0 the port installs no journal at all
(``ctx.journal`` is None) where the JAX package installs a disabled one.

Event-schema table (``EVENT_SCHEMA``): every ``journal.emit("<type>",
...)`` literal in the tree must appear here with its required fields
— parseclint's PCL-JRNL pass enforces it, and requires ``round=`` on
every round-scoped protocol emit (the schema-drift bug class: an
emit the auditor cannot attribute to a round is an emit the auditor
cannot check).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from parsec_tpu_torch.utils.mca import params

params.register("journal_enabled", 1,
                "install the always-on control-plane journal on every "
                "Context: a bounded ring of structured protocol events "
                "(recovery rounds, termdet rewinds, retirement "
                "handshakes, rejoin fencing, barrier generations, job "
                "lifecycle), pullable over the job port and included "
                "in flight-recorder incident bundles (0 disables "
                "every emit)")
params.register("journal_ring", 4096,
                "journal ring capacity in EVENTS (bounded memory: "
                "oldest events are overwritten; control-plane rates "
                "are low, so the default holds whole recovery "
                "histories)")
params.register("journal_dir", "",
                "when set, every Context APPENDS its journal to "
                "<dir>/journal-rank<N>.jsonl at fini — the per-rank "
                "bundle tools/journal_audit.py merges and audits "
                "(chaos --audit-journal arms this per case)")
params.register("journal_autopsy_tail", 20,
                "control-plane events per rank the hang autopsy "
                "prints (clock-aligned, newest last) so a wedged "
                "negotiation is visible in the autopsy text without "
                "pulling bundles (0 disables the section)")

#: The event-schema table: type -> REQUIRED emit fields.  PCL-JRNL
#: checks every ``journal.emit("<type>")`` literal in the tree against
#: this table and requires each listed field as an explicit kwarg —
#: in particular ``round`` on every round-scoped protocol event.
#: Fields beyond the required ones are free-form context.
EVENT_SCHEMA: Dict[str, tuple] = {
    # termdet epoch transitions and rewind fences (core/recovery.py)
    "epoch_fence": ("pool", "epoch"),
    "termdet_rewind": ("pool", "was"),
    "safra_reconcile": ("peer",),
    # peer lifecycle (comm/engine.py)
    "peer_dead": ("peer", "detector"),
    "peer_excused": ("peer",),
    # dead-set agreement round (TAG_RECOVER)
    "deadset_report": ("peers", "coord"),
    "deadset_bcast": ("peers",),
    "deadset_recv": ("peers", "src", "kind"),
    "deadset_timeout": ("peers", "coord"),
    # replay mode votes (round = the pool's restart-attempt count)
    "mode_decl": ("pool", "round", "mode", "peers"),
    "mode_vote": ("pool", "round", "mode", "src"),
    "mode_result": ("pool", "round", "mode"),
    # DTD insert-stream skip agreement
    "skip_offer": ("pool", "round", "frontier"),
    "skip_cut": ("pool", "round", "prefix"),
    # minimal-replay need negotiation (round = negotiation round 1..N)
    "need_send": ("pool", "round", "peers"),
    "need_req": ("pool", "src"),
    "need_ack": ("pool", "dst", "ok"),
    "need_round": ("pool", "round", "outcome", "peers"),
    # retirement handshake (incl. the grace-window degradation and the
    # coordinator-succession round that avoids it)
    "retire_report": ("pool", "coord"),
    "retire_recv": ("pool", "src"),
    "retired": ("pool",),
    "retire_degraded": ("pool",),
    "retire_succession": ("pool", "coord"),
    # rejoin incarnation fencing (TAG_REJOIN)
    "rejoin_req": ("src", "epoch", "ok"),
    "rejoin_done": ("epoch",),
    # recovery lifecycle + the chosen replay policy
    "recovery_start": ("peer",),
    "recovery_done": ("peer", "ok"),
    "replay_mode": ("pool", "mode"),
    # barrier generations (comm/engine.py)
    "barrier": ("gen", "outcome"),
    # JobService lifecycle decisions (service/service.py)
    "job_admit": ("job",),
    "job_start": ("job",),
    "job_done": ("job", "status"),
    "job_cancel": ("job",),
    "service_state": ("peer", "state"),
    # serving-fabric decisions (service/fabric.py): admission quotes,
    # placement/release of carved device subsets, elastic resizes,
    # preemption round-trips.  The auditor's F-invariants replay these:
    # exclusive subsets disjoint at all times (F1), exactly one
    # placement outcome per admitted job (F2), every preemption
    # resumed or cancelled (F3).
    "fabric_quote": ("job", "eta"),
    "fabric_admit": ("job", "verdict"),
    "fabric_place": ("job", "devices"),
    "fabric_resize": ("job", "devices", "delta"),
    "fabric_release": ("job",),
    "fabric_preempt": ("job", "by"),
    "fabric_resume": ("job",),
    # predictive health plane (prof/health.py + service/fabric.py):
    # scored state transitions and the drain decisions they justify.
    # The auditor's H1 invariant replays these: every health_drain
    # preceded by recorded below-threshold evidence for the same rank
    # (a transition out of "ok"), and no drained rank placement-
    # targeted while the drain is in force.  ``peer`` not ``rank``:
    # merge_journals stamps ``rank`` (the OBSERVING rank) onto every
    # merged event, so the observed rank must ride another key.
    "health_transition": ("peer", "frm", "to", "score"),
    "health_drain": ("peer", "score", "thr"),
    "health_undrain": ("peer", "score"),
}


def _jsonable(v: Any) -> Any:
    """Normalize emit-site values to wire-safe primitives: peer sets
    become sorted lists, everything exotic becomes its repr."""
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return repr(v)


class Journal:
    """One per Context.  ``emit`` is the only hot call: a dict build
    plus a bounded ``deque.append`` (atomic under the GIL — the flight
    recorder's ring discipline), stamped with ``perf_counter`` so the
    TAG_CLOCK offsets align per-rank journals exactly like traces.
    Disabled (``journal_enabled=0``) it is a single attribute check.
    """

    def __init__(self, rank: int = 0, cap: Optional[int] = None):
        self.rank = rank
        self.enabled = bool(int(params.get("journal_enabled", 1)))
        n = cap if cap is not None \
            else max(64, int(params.get("journal_ring", 4096)))
        self._ring: deque = deque(maxlen=n)
        self._seq = itertools.count(1)
        #: this rank's incarnation epoch (comm_epoch); re-stamped when
        #: the comm engine attaches — a restarted rank journals under
        #: its bumped incarnation
        self.incarnation = int(params.get("comm_epoch", 0))
        self.nranks = 1
        #: TAG_CLOCK table provider (CommEngine.clock_table) — read at
        #: snapshot/dump time only, never on the emit path
        self._clock_provider: Optional[Callable[[], Dict]] = None
        self._dump_lock = threading.Lock()

    # -- wiring ----------------------------------------------------------
    def attach_comm(self, ce) -> None:
        """Wire the comm engine (RemoteDepEngine construction): the
        journal learns its incarnation and clock table, the engine
        learns where barrier/death events land and how to serve
        cross-rank journal pulls."""
        self.incarnation = int(getattr(ce, "epoch", 0))
        self.nranks = int(getattr(ce, "nranks", 1))
        self._clock_provider = getattr(ce, "clock_table", None)
        ce.journal = self
        ce.journal_provider = self.snapshot

    # -- the emit path ---------------------------------------------------
    def emit(self, etype: str, **fields) -> None:
        """Append one control-plane event.  Call sites pass the
        schema'd fields (EVENT_SCHEMA) as kwargs; sets are normalized
        to sorted lists so snapshots serialize.  Never raises and
        never blocks — a journal failure must not perturb the protocol
        it records."""
        if not self.enabled:
            return
        ev = {"e": etype, "t": time.perf_counter(),
              "seq": next(self._seq), "inc": self.incarnation}
        for k, v in fields.items():
            ev[k] = _jsonable(v)
        self._ring.append(ev)

    # -- read side -------------------------------------------------------
    def tail(self, n: int = 20) -> List[dict]:
        events = list(self._ring)           # one consistent snapshot
        return events[-n:]

    def snapshot(self) -> dict:
        """Wire/merge form: header (rank, incarnation, clock table,
        wall + perf anchors) plus the ring contents.  The perf/wall
        anchor pair lets offline readers print wall-clock times; the
        clock table is what the auditor aligns with."""
        clock = {}
        prov = self._clock_provider
        if prov is not None:
            try:
                clock = {int(r): {"offset": float(st.get("offset", 0.0)),
                                  "rtt": float(st.get("rtt", 0.0))}
                         for r, st in prov().items()}
            except Exception:   # a torn comm engine must not kill reads
                clock = {}
        return {"rank": self.rank, "inc": self.incarnation,
                "nranks": self.nranks, "wall": time.time(),
                "perf": time.perf_counter(), "clock": clock,
                "events": list(self._ring)}

    def dump(self, dir_path: str) -> str:
        """APPEND this journal to ``<dir>/journal-rank<N>.jsonl``: one
        ``{"h": header}`` line then one line per event.  Append (not
        truncate) so a restarted incarnation's dump lands after its
        predecessor's in the same file — the auditor checks epoch
        monotonicity across exactly that boundary."""
        os.makedirs(dir_path, exist_ok=True)
        path = os.path.join(dir_path, f"journal-rank{self.rank}.jsonl")
        snap = self.snapshot()
        events = snap.pop("events")
        with self._dump_lock:
            with open(path, "a") as fh:
                fh.write(json.dumps({"h": snap}) + "\n")
                for ev in events:
                    fh.write(json.dumps(ev) + "\n")
        return path

    def __len__(self) -> int:
        return len(self._ring)


def install_journal(context) -> Journal:
    j = Journal(rank=context.rank)
    context.journal = j
    return j


# ---------------------------------------------------------------------------
# merge + alignment (shared by the auditor, the autopsy tail, and the
# job-port pull)
# ---------------------------------------------------------------------------

def merge_journals(per_rank: Dict[int, dict],
                   ref: Optional[int] = None) -> List[dict]:
    """Fold per-rank snapshots into ONE time-ordered event list on the
    reference (lowest-rank by default) clock.

    Alignment follows prof/critpath.merge_traces: for rank r, prefer
    r's OWN measured offset to the reference (``offset = clock_ref -
    clock_r`` -> ``t + offset``), fall back to the reference's
    measurement of r (negated); same-host journals share
    CLOCK_MONOTONIC so a missing table degrades to zero shift.  Each
    merged event gains ``rank`` and its aligned ``t``."""
    if not per_rank:
        return []
    ranks = sorted(per_rank)
    if ref is None or ref not in per_rank:
        ref = ranks[0]
    ref_clock = (per_rank[ref] or {}).get("clock") or {}
    out: List[dict] = []
    for r in ranks:
        snap = per_rank[r] or {}
        shift = 0.0
        if r != ref:
            own = snap.get("clock") or {}
            ent = own.get(ref, own.get(str(ref)))
            if ent is not None:
                shift = float(ent.get("offset", 0.0))
            else:
                ent = ref_clock.get(r, ref_clock.get(str(r)))
                if ent is not None:
                    shift = -float(ent.get("offset", 0.0))
        for ev in snap.get("events", ()):
            mev = dict(ev)
            mev["rank"] = r
            mev["t"] = float(ev.get("t", 0.0)) + shift
            out.append(mev)
    out.sort(key=lambda e: (e["t"], e["rank"], e.get("seq", 0)))
    return out


def format_event(ev: dict, t0: float = 0.0) -> str:
    """One human-readable timeline line (shared by the autopsy tail
    and ``journal_audit --timeline``)."""
    skip = {"e", "t", "seq", "inc", "rank"}
    extra = " ".join(f"{k}={ev[k]}" for k in ev if k not in skip)
    return (f"t+{ev.get('t', 0.0) - t0:10.4f}s rank {ev.get('rank', '?')}"
            f" inc={ev.get('inc', 0)} {ev.get('e', '?'):16s} {extra}")


def cluster_journals(context, timeout: float = 2.0) -> Dict[int, dict]:
    """This rank's snapshot plus every live peer's, pulled over the
    TAG_METRICS control lane (the job-port ``{"op": "journal"}``
    surface and the autopsy tail both read this).  Degrades to the
    local view, never fails."""
    j = getattr(context, "journal", None)
    local = j.snapshot() if j is not None else {}
    per_rank = {context.rank: local}
    comm = getattr(context, "comm", None)
    ce = getattr(comm, "ce", None) if comm is not None else None
    if ce is not None and context.nranks > 1:
        try:
            per_rank.update(ce.gather_journals(timeout=timeout))
        except Exception:
            pass
    return per_rank
