#!/usr/bin/env python
"""journal_audit — merge, render, and AUDIT control-plane journals.

The offline half of the control-plane black box (prof/journal.py):
every rank's protocol journal — recovery rounds, termdet rewinds,
retirement handshakes, rejoin fencing, barrier generations, job
lifecycle — lands in ``journal-rank<N>.jsonl`` files (``--mca
journal_dir``, a flight-recorder incident bundle, or the job port's
``{"op": "journal"}`` pull saved to disk).  This tool:

* ``--timeline``   merges the per-rank journals onto rank 0's clock
                   (the recorded TAG_CLOCK offsets, the same alignment
                   prof/critpath.merge_traces uses) and prints ONE
                   human-readable protocol timeline;
* ``--chrome F``   emits the merged events as Perfetto/chrome instant
                   events (pid = rank) — open next to a
                   ``trace2chrome.py --merge`` view of the same bundle
                   and the control plane lines up under the data plane;
* ``--audit``      runs the offline INVARIANT AUDITOR; violations
                   print one per line and exit nonzero.

Audited invariants (the protocol contracts the runtime argues in prose,
assertable from evidence):

  I1  mode votes within one (pool, round_id) agree on the round's
      MEMBERSHIP — every voter declared the same live gang;
  I2  an agreed DTD skip prefix is <= EVERY rank's offered cut in its
      round, and no round with a ``full`` offer agreed a nonzero cut;
  I3  incarnation epochs are MONOTONE per rank (journal-file order)
      and pool run_epoch fences are strictly increasing per
      (rank, pool);
  I4  exactly ONE retirement outcome per (rank, pool): never a
      duplicate, never both ``retired`` and ``retire_degraded``;
  I5  every need-negotiation request is ANSWERED or explicitly
      degraded: per (rank, pool) the need_req count equals the
      need_ack count, and every requester round carries a terminal
      outcome (acked / nacked / widened / exhausted);
  F1  serving-fabric mesh carving (service/fabric.py): replaying
      fabric_place / fabric_resize / fabric_release chronologically,
      the EXCLUSIVE device subsets of distinct jobs are disjoint at
      every instant;
  F2  exactly one placement outcome per admitted job per admission
      epoch: per job, count(fabric_place) - count(fabric_resume) is
      0 or 1, and a REJECTED job records no placement at all;
  F3  every preemption resolves: a fabric_preempt is followed by a
      fabric_resume or a terminal job_done for that job;
  H1  health decisions are evidence-backed (prof/health.py): every
      pre-emptive drain is PRECEDED by recorded below-threshold
      evidence for that rank (a health_transition out of "ok") and
      carries a score strictly below its own threshold — and no rank
      is both drained and placement-targeted while the drain is in
      force (replaying health_drain / health_undrain / fabric_place
      chronologically per fabric).

Usage:
    python -m parsec_tpu_torch.tools.journal_audit <bundle> --timeline
    python -m parsec_tpu_torch.tools.journal_audit <bundle> --audit
    python -m parsec_tpu_torch.tools.journal_audit <bundle> --chrome ctl.json

The port's copy of the JAX package's tools/journal_audit.py: it reads
the port's prof/journal.py, and nothing else differs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_RANK_RE = re.compile(r"journal-rank(\d+)\.jsonl$")


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def load_file(path: str) -> List[dict]:
    """One journal file -> list of SNAPSHOTS (a file holds one header
    + events per dump; a restarted incarnation APPENDS another pair,
    and the auditor checks epoch monotonicity across that boundary)."""
    snaps: List[dict] = []
    cur: Optional[dict] = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "h" in rec:
                cur = dict(rec["h"])
                cur["events"] = []
                snaps.append(cur)
            elif cur is not None:
                cur["events"].append(rec)
    return snaps


def load_bundle(paths: List[str]) -> Dict[int, List[dict]]:
    """Bundle dirs and/or journal files -> rank -> snapshot list (in
    dump order)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(
                os.path.join(p, "journal-rank*.jsonl"))))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(
            f"no journal-rank*.jsonl under {paths!r}")
    per_rank: Dict[int, List[dict]] = defaultdict(list)
    for f in files:
        m = _RANK_RE.search(os.path.basename(f))
        snaps = load_file(f)
        for snap in snaps:
            rank = int(snap.get("rank",
                                m.group(1) if m else len(per_rank)))
            per_rank[rank].append(snap)
    return dict(per_rank)


def _merge_rank_snaps(snaps: List[dict]) -> dict:
    """Concatenate one rank's dumps (events stay in file order; the
    LAST snapshot's clock table wins — it has the freshest offsets)."""
    if not snaps:
        return {}
    out = dict(snaps[-1])
    events: List[dict] = []
    for s in snaps:
        events.extend(s.get("events", ()))
    out["events"] = events
    return out


def merged_events(per_rank: Dict[int, List[dict]]) -> List[dict]:
    """All ranks' events on the reference clock, time-ordered."""
    from parsec_tpu_torch.prof.journal import merge_journals
    return merge_journals({r: _merge_rank_snaps(s)
                           for r, s in per_rank.items()})


# ---------------------------------------------------------------------------
# the invariant auditor
# ---------------------------------------------------------------------------

def audit(per_rank: Dict[int, List[dict]]) -> List[str]:
    """Run every invariant; returns violation strings (empty = clean).

    Keying note: per-rank invariants (I3/I4/I5) include the
    incarnation stamp so a restarted rank's RECYCLED pool ids (the id
    is a per-process counter) never alias its predecessor's events.
    The cross-rank round invariants (I1/I2) group by (pool, round)
    only — a round spans ranks whose incarnation stamps legitimately
    differ (a rejoined voter), so incarnation cannot join the key;
    the residual aliasing there needs a recycled pool id to reach the
    SAME restart-attempt round number again within one bundle."""
    violations: List[str] = []
    events = merged_events(per_rank)

    # I1: mode votes within one (pool, round) agree on membership
    members: Dict[Tuple, List[Tuple[int, tuple]]] = defaultdict(list)
    for ev in events:
        if ev.get("e") == "mode_decl":
            members[(ev.get("pool"), ev.get("round"))].append(
                (ev["rank"], tuple(sorted(ev.get("peers") or ()))))
    for (pool, rnd), decls in members.items():
        views = {v for _r, v in decls}
        if len(views) > 1:
            violations.append(
                f"I1 pool={pool} round={rnd}: mode votes disagree on "
                f"membership: "
                + "; ".join(f"rank {r} saw {list(v)}"
                            for r, v in sorted(set(decls))))

    # I2: agreed skip prefix <= every offered cut in its round
    offers: Dict[Tuple, List[Tuple[int, int, Optional[str]]]] = \
        defaultdict(list)
    cuts: Dict[Tuple, int] = {}
    for ev in events:
        key = (ev.get("pool"), ev.get("round"))
        if ev.get("e") == "skip_offer":
            offerer = ev.get("src", ev["rank"])
            offers[key].append((int(offerer),
                                int(ev.get("frontier", -1)),
                                ev.get("full")))
        elif ev.get("e") == "skip_cut":
            cuts[key] = max(cuts.get(key, 0), int(ev.get("prefix", 0)))
    for key, prefix in cuts.items():
        if prefix <= 0:
            continue
        # dedup: a rank's own offer and the coordinator's receive-side
        # record of it are the same ballot
        seen: Dict[int, Tuple[int, Optional[str]]] = {}
        for offerer, frontier, full in offers.get(key, ()):
            seen.setdefault(offerer, (frontier, full))
        for offerer, (frontier, full) in sorted(seen.items()):
            if full is not None:
                violations.append(
                    f"I2 pool={key[0]} round={key[1]}: prefix {prefix} "
                    f"agreed although rank {offerer} voted full "
                    f"({full})")
            elif frontier >= 0 and prefix > frontier:
                violations.append(
                    f"I2 pool={key[0]} round={key[1]}: agreed prefix "
                    f"{prefix} exceeds rank {offerer}'s offered cut "
                    f"{frontier}")

    # I3: incarnations monotone per rank; run_epoch fences strictly
    # increasing per (rank, incarnation, pool).  Pool ids are a
    # per-PROCESS counter, so a restarted incarnation legitimately
    # reuses its predecessor's ids — the incarnation stamp (monotone
    # within one rank's stream, checked first) disambiguates them.
    for rank, snaps in sorted(per_rank.items()):
        last_inc = None
        fences: Dict[Tuple, int] = {}
        for snap in snaps:
            for ev in snap.get("events", ()):
                inc = int(ev.get("inc", 0))
                if last_inc is not None and inc < last_inc:
                    violations.append(
                        f"I3 rank {rank}: incarnation regressed "
                        f"{last_inc} -> {inc} at seq {ev.get('seq')}")
                last_inc = inc
                if ev.get("e") == "epoch_fence":
                    pool, epoch = ev.get("pool"), int(ev.get("epoch", 0))
                    prev = fences.get((inc, pool))
                    if prev is not None and epoch <= prev:
                        violations.append(
                            f"I3 rank {rank} pool={pool}: run_epoch "
                            f"fence not monotone ({prev} -> {epoch})")
                    fences[(inc, pool)] = epoch

    # I4: exactly one retirement outcome per (rank, incarnation, pool)
    # — the incarnation key keeps a restarted rank's recycled pool id
    # from aliasing its predecessor's outcome
    outcomes: Dict[Tuple, List[str]] = defaultdict(list)
    for ev in events:
        if ev.get("e") in ("retired", "retire_degraded"):
            outcomes[(ev["rank"], ev.get("inc", 0),
                      ev.get("pool"))].append(ev["e"])
    for (rank, _inc, pool), outs in sorted(outcomes.items()):
        if len(outs) > 1:
            violations.append(
                f"I4 rank {rank} pool={pool}: {len(outs)} retirement "
                f"outcomes ({outs}) — expected exactly one")

    # I5: negotiation rounds answered or explicitly degraded (keyed
    # per incarnation for the same pool-id-recycling reason)
    reqs: Dict[Tuple, int] = defaultdict(int)
    acks: Dict[Tuple, int] = defaultdict(int)
    terminal = {"acked", "nacked", "widened", "exhausted"}
    for ev in events:
        key = (ev["rank"], ev.get("inc", 0), ev.get("pool"))
        if ev.get("e") == "need_req":
            reqs[key] += 1
        elif ev.get("e") == "need_ack":
            acks[key] += 1
        elif ev.get("e") == "need_round" \
                and ev.get("outcome") not in terminal:
            violations.append(
                f"I5 rank {ev['rank']} pool={ev.get('pool')}: "
                f"negotiation round {ev.get('round')} has non-terminal "
                f"outcome {ev.get('outcome')!r}")
    for key in sorted(set(reqs) | set(acks)):
        if reqs[key] != acks[key]:
            violations.append(
                f"I5 rank {key[0]} pool={key[2]}: {reqs[key]} "
                f"need_req(s) but {acks[key]} need_ack(s) — an "
                "unanswered negotiation")
    # requester side: a need_send with no terminal need_round in the
    # same (rank, inc, pool, round) is a round that went silent
    sends = {(ev["rank"], ev.get("inc", 0), ev.get("pool"),
              ev.get("round"))
             for ev in events if ev.get("e") == "need_send"}
    rounds = {(ev["rank"], ev.get("inc", 0), ev.get("pool"),
               ev.get("round"))
              for ev in events if ev.get("e") == "need_round"}
    for rank, _inc, pool, rnd in sorted(sends - rounds):
        violations.append(
            f"I5 rank {rank} pool={pool}: need round {rnd} was sent "
            "but records no terminal outcome")

    # F1: exclusive subsets disjoint at every instant — replay the
    # placement stream chronologically, tracking job -> device set per
    # (rank, incarnation) fabric (the fabric is rank-local; a resize
    # event carries the subset AFTER the change)
    holdings: Dict[Tuple, Dict[Tuple, set]] = defaultdict(dict)
    for ev in events:
        e = ev.get("e")
        if e not in ("fabric_place", "fabric_resize", "fabric_release"):
            continue
        fab = (ev["rank"], ev.get("inc", 0))
        jkey = (fab, ev.get("job"))
        if e == "fabric_release":
            holdings[fab].pop(jkey, None)
            continue
        if e == "fabric_place" and (ev.get("shared")
                                    or not ev.get("devices")):
            continue                       # temporal sharing: no claim
        devs = set(ev.get("devices") or ())
        for other, held in holdings[fab].items():
            if other != jkey and held & devs:
                violations.append(
                    f"F1 rank {ev['rank']}: jobs {other[1]} and "
                    f"{ev.get('job')} hold overlapping exclusive "
                    f"devices {sorted(held & devs)} at t={ev['t']:.6f}")
        if devs:
            holdings[fab][jkey] = devs
        else:
            holdings[fab].pop(jkey, None)  # shrunk to nothing

    # F2: one placement outcome per admitted job per admission epoch
    # (a resume opens a new epoch); a rejected job never places
    admits: Dict[Tuple, str] = {}
    places: Dict[Tuple, int] = defaultdict(int)
    resumes: Dict[Tuple, int] = defaultdict(int)
    for ev in events:
        key = (ev["rank"], ev.get("inc", 0), ev.get("job"))
        e = ev.get("e")
        if e == "fabric_admit":
            admits[key] = ev.get("verdict")
        elif e == "fabric_place":
            places[key] += 1
        elif e == "fabric_resume":
            resumes[key] += 1
    for key, verdict in sorted(admits.items()):
        n = places[key] - resumes[key]
        if verdict == "reject":
            if places[key]:
                violations.append(
                    f"F2 rank {key[0]} job={key[2]}: REJECTED but "
                    f"records {places[key]} placement(s)")
        elif n not in (0, 1):
            violations.append(
                f"F2 rank {key[0]} job={key[2]}: {places[key]} "
                f"placement(s) over {resumes[key]} resume(s) — "
                "expected one outcome per admission epoch")
    for key in sorted(set(places) - set(admits)):
        violations.append(
            f"F2 rank {key[0]} job={key[2]}: placed with no admission "
            "record")

    # F3: every preemption resolves — resumed, or terminal job_done
    # after the preemption (a cancelled-while-preempted job)
    outstanding: Dict[Tuple, float] = {}
    for ev in events:
        key = (ev["rank"], ev.get("inc", 0), ev.get("job"))
        e = ev.get("e")
        if e == "fabric_preempt":
            outstanding[key] = ev["t"]
        elif e == "fabric_resume":
            outstanding.pop(key, None)
        elif e == "job_done" and key in outstanding:
            outstanding.pop(key, None)
    for (rank, _inc, job), t in sorted(outstanding.items()):
        violations.append(
            f"F3 rank {rank} job={job}: preempted at t={t:.6f} but "
            "never resumed nor terminal")

    # H1: drains evidence-backed, drained ranks never placement
    # targets — chronological replay per (rank, incarnation) fabric.
    # ``peer`` is the OBSERVED rank (merge stamps ``rank`` with the
    # observer).  Placements without a ``ranks`` gang stamp predate
    # the health plane and are skipped.
    below_seen: Dict[Tuple, set] = defaultdict(set)
    drained: Dict[Tuple, set] = defaultdict(set)
    for ev in events:
        e = ev.get("e")
        if e not in ("health_transition", "health_drain",
                     "health_undrain", "fabric_place"):
            continue
        fab = (ev["rank"], ev.get("inc", 0))
        if e == "health_transition":
            if ev.get("to") != "ok":
                below_seen[fab].add(ev.get("peer"))
            else:
                below_seen[fab].discard(ev.get("peer"))
        elif e == "health_drain":
            peer = ev.get("peer")
            if peer not in below_seen[fab]:
                violations.append(
                    f"H1 rank {ev['rank']} peer={peer}: drained at "
                    f"t={ev['t']:.6f} with no preceding below-threshold "
                    "evidence (no health_transition out of 'ok')")
            score, thr = ev.get("score"), ev.get("thr")
            if score is not None and thr is not None \
                    and float(score) >= float(thr):
                violations.append(
                    f"H1 rank {ev['rank']} peer={peer}: drain score "
                    f"{score} is not below its threshold {thr}")
            drained[fab].add(peer)
        elif e == "health_undrain":
            drained[fab].discard(ev.get("peer"))
        elif e == "fabric_place" and ev.get("ranks") is not None:
            hit = drained[fab] & set(ev.get("ranks") or ())
            if hit:
                violations.append(
                    f"H1 rank {ev['rank']} job={ev.get('job')}: "
                    f"placement targets drained rank(s) {sorted(hit)} "
                    f"at t={ev['t']:.6f}")
    return violations


# ---------------------------------------------------------------------------
# round reconstruction (the --timeline summary + test hook)
# ---------------------------------------------------------------------------

def _round_for(rounds: Dict[Tuple, dict], ev: dict) -> Optional[dict]:
    """The round dict a pool-scoped event belongs to: the event's own
    ``round`` stamp when present, else the pool's nearest round whose
    cut (or latest offer) precedes the event."""
    pool = ev.get("pool")
    if ev.get("round") is not None:
        return rounds.get((pool, ev["round"]))
    cands = [r for r in rounds.values() if r["pool"] == pool]
    if not cands:
        return None

    def anchor(r) -> float:
        if r["cut"] is not None:
            return r["cut"]["t"]
        return max((o["t"] for o in r["offers"]), default=float("inf"))

    before = [r for r in cands if anchor(r) <= ev["t"]]
    return max(before, key=anchor) if before \
        else min(cands, key=anchor)


def skip_rounds(per_rank: Dict[int, List[dict]]) -> List[dict]:
    """Reconstruct each DTD skip-agreement round end-to-end from a
    merged bundle: offers (votes) -> agreed cut -> ghost replay ->
    retirement.  One dict per (pool, round) seen."""
    events = merged_events(per_rank)
    rounds: Dict[Tuple, dict] = {}

    def rec(pool, rnd) -> dict:
        return rounds.setdefault((pool, rnd), {
            "pool": pool, "round": rnd, "offers": [], "cut": None,
            "replays": [], "retired": []})

    for ev in events:
        e = ev.get("e")
        if e == "skip_offer":
            r = rec(ev.get("pool"), ev.get("round"))
            r["offers"].append({"rank": ev.get("src", ev["rank"]),
                                "frontier": ev.get("frontier"),
                                "full": ev.get("full"), "t": ev["t"]})
        elif e == "skip_cut":
            r = rec(ev.get("pool"), ev.get("round"))
            if r["cut"] is None or ev.get("prefix", 0) >= \
                    r["cut"]["prefix"]:
                r["cut"] = {"prefix": int(ev.get("prefix", 0)),
                            "t": ev["t"]}
        elif e == "replay_mode" and ev.get("mode") == "skip":
            # attribute to the EVENT'S round when stamped (r16 emits
            # carry it); otherwise the nearest preceding agreed round
            # — a pool whose first round fell back to full must not
            # report ghost replays in it
            tgt = _round_for(rounds, ev)
            if tgt is not None:
                tgt["replays"].append({"rank": ev["rank"],
                                       "prefix": ev.get("prefix"),
                                       "tasks": ev.get("tasks"),
                                       "t": ev["t"]})
        elif e == "retired":
            # retirement is pool-scoped, not round-scoped: attach to
            # the pool's last round that AGREED a cut before this
            # event (timeline cosmetics only — I4 audits retirement)
            cands = [r for r in rounds.values()
                     if r["pool"] == ev.get("pool")
                     and r["cut"] is not None
                     and r["cut"]["t"] <= ev["t"]]
            if cands:
                tgt = max(cands, key=lambda r: r["cut"]["t"])
                tgt["retired"].append({"rank": ev["rank"],
                                       "t": ev["t"]})
    out = []
    for r in rounds.values():
        # dedup offers per rank (own emit + coordinator's receive)
        seen: Dict[int, dict] = {}
        for o in r["offers"]:
            seen.setdefault(o["rank"], o)
        r["offers"] = [seen[k] for k in sorted(seen)]
        out.append(r)
    return sorted(out, key=lambda r: (str(r["pool"]), r["round"] or 0))


# ---------------------------------------------------------------------------
# renderers
# ---------------------------------------------------------------------------

def render_timeline(per_rank: Dict[int, List[dict]]) -> str:
    from parsec_tpu_torch.prof.journal import format_event
    events = merged_events(per_rank)
    if not events:
        return "(empty journal bundle)"
    t0 = events[0]["t"]
    lines = [f"control-plane timeline: ranks {sorted(per_rank)}, "
             f"{len(events)} events (t0 = first event, rank "
             f"{min(per_rank)}'s clock)"]
    lines.extend(format_event(ev, t0) for ev in events)
    for r in skip_rounds(per_rank):
        if r["cut"] is None and not r["offers"]:
            continue
        offs = ", ".join(
            f"rank {o['rank']}:"
            + (f"full({o['full']})" if o.get("full") is not None
               else str(o.get("frontier")))
            for o in r["offers"])
        cut = r["cut"]["prefix"] if r["cut"] else "none"
        lines.append(
            f"skip round pool={r['pool']} round={r['round']}: "
            f"offers [{offs}] -> agreed cut {cut} -> "
            f"{len(r['replays'])} ghost replay(s) -> "
            f"{len(r['retired'])} retirement(s)")
    return "\n".join(lines)


def write_chrome(per_rank: Dict[int, List[dict]], out_path: str) -> int:
    """Merged journal -> chrome/Perfetto instant events (pid = rank,
    one thread row per rank's control plane) — open alongside the
    trace2chrome --merge view of the same incident bundle; both are on
    the reference rank's clock so the rows line up."""
    events = merged_events(per_rank)
    trace: List[dict] = []
    for r in sorted(per_rank):
        trace.append({"name": "process_name", "ph": "M", "pid": r,
                      "args": {"name": f"rank {r} control plane"}})
    for ev in events:
        args = {k: v for k, v in ev.items()
                if k not in ("e", "t", "rank")}
        trace.append({
            "name": ev.get("e", "?"), "ph": "i", "s": "p",
            "pid": ev["rank"], "tid": 0,
            "ts": ev["t"] * 1e6,       # chrome wants microseconds
            "args": args,
        })
    with open(out_path, "w") as fh:
        json.dump({"traceEvents": trace}, fh)
    return len(events)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="+",
                    help="bundle directory (journal-rank*.jsonl) "
                         "and/or journal files")
    ap.add_argument("--timeline", action="store_true",
                    help="print the merged clock-aligned protocol "
                         "timeline")
    ap.add_argument("--audit", action="store_true",
                    help="run the invariant auditor; exits 1 on any "
                         "violation")
    ap.add_argument("--chrome", metavar="OUT.json", default="",
                    help="write merged instant events for the "
                         "trace2chrome Perfetto view")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    per_rank = load_bundle(args.paths)
    rc = 0
    did = False
    if args.timeline:
        did = True
        if args.json:
            print(json.dumps({"events": merged_events(per_rank),
                              "skip_rounds": skip_rounds(per_rank)}))
        else:
            print(render_timeline(per_rank))
    if args.chrome:
        did = True
        n = write_chrome(per_rank, args.chrome)
        print(f"journal_audit: wrote {n} instant events to "
              f"{args.chrome}", file=sys.stderr)
    if args.audit or not did:
        violations = audit(per_rank)
        if args.json:
            print(json.dumps({"violations": violations,
                              "ranks": sorted(per_rank)}))
        elif violations:
            for v in violations:
                print(f"VIOLATION {v}")
        else:
            nev = sum(len(s.get("events", ()))
                      for snaps in per_rank.values() for s in snaps)
            print(f"journal_audit: {len(per_rank)} rank(s), {nev} "
                  "event(s), zero invariant violations")
        rc = 1 if violations else 0
    return rc


if __name__ == "__main__":
    sys.exit(main())
