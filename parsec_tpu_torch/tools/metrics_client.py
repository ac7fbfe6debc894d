#!/usr/bin/env python
"""Scrape a resident parsec_tpu_torch job server's telemetry plane.

One-shot (prints the Prometheus text exposition, cross-rank aggregated
over TAG_METRICS by the server) or ``--watch`` (re-scrapes on an
interval and prints per-second rates for counter families):

    M="python -m parsec_tpu_torch.tools.metrics_client"
    $M --port 41990
    $M --watch 2
    $M --grep parsec_comm
    $M --job 7                  # one job's series
    $M --status                 # live status doc
    $M --status --watch 2
    curl http://127.0.0.1:41990/metrics        # same data, plain HTTP

The framed requests are ``{"op": "metrics"}`` and ``{"op": "status"}``
(service/server.py); ``--status`` prints the live attribution document
(per-job progress, exec/queue/comm/idle split, stragglers, dagsim ETA
— prof/liveattr.py).  Pass ``--local`` to skip the cross-rank pull and
read only the server rank's registry.

The port of the JAX package's tools/metrics_client.py, over the port's
``service.server.request``; nothing differs but the package it imports.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from parsec_tpu_torch.service.server import request
from parsec_tpu_torch.utils.mca import params


def scrape(host: str, port: int, aggregate: bool = True,
           timeout: float = 10.0) -> str:
    reply = request(host, port, {"op": "metrics", "aggregate": aggregate},
                    timeout=timeout)
    if not reply.get("ok"):
        raise RuntimeError(f"scrape failed: {reply.get('error')}")
    return reply["text"]


def scrape_status(host: str, port: int, aggregate: bool = True,
                  timeout: float = 10.0) -> dict:
    reply = request(host, port, {"op": "status", "aggregate": aggregate},
                    timeout=timeout)
    if not reply.get("ok"):
        raise RuntimeError(f"status failed: {reply.get('error')}")
    return reply["status"]


def _parse_counters(text: str):
    """name{labels} -> value for counter-typed series (rate display)."""
    out = {}
    typ = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _h, _t, name, kind = line.split()
            typ[name] = kind
            continue
        if line.startswith("#") or not line.strip():
            continue
        try:
            key, val = line.rsplit(" ", 1)
            base = key.split("{", 1)[0]
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix):
                    base = base[:-len(suffix)]
            if typ.get(base) == "counter":   # labeled series included
                out[key] = float(val)
        except ValueError:
            continue
    return out


def render_health_table(doc: dict) -> str:
    """Per-rank health table from the status document's ``health``
    block (prof/health.py): smoothed score, raw last fold, trend
    arrow, state, time in state, and which rank's view won the
    pessimistic merge."""
    health = doc.get("health") or {}
    ranks = health.get("ranks") or {}
    if not ranks:
        return "(health plane disarmed or no observations yet)"
    hdr = (f"{'rank':>5} {'score':>7} {'last':>7} {'tr':>3} "
           f"{'state':<9} {'for':>7} {'src':>4}")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(ranks, key=lambda x: int(x)):
        ent = ranks[r] or {}
        t = float(ent.get("trend", 0.0) or 0.0)
        arrow = "↑" if t > 0.02 else "↓" if t < -0.02 else "→"
        lines.append(
            f"{r:>5} {float(ent.get('ewma', 1.0)):>7.3f} "
            f"{float(ent.get('score', 1.0)):>7.3f} {arrow:>3} "
            f"{str(ent.get('state', 'ok'))[:9]:<9} "
            f"{float(ent.get('since_s', 0.0)):>6.1f}s "
            f"{ent.get('src', '-'):>4}")
    lines.append(f"folds={health.get('folds', 0)} "
                 f"transitions={health.get('transitions', 0)}")
    return "\n".join(lines)


def _status_filtered(doc: dict, job: int | None) -> dict:
    if job is None:
        return doc
    return {**doc,
            "jobs": [j for j in doc.get("jobs", [])
                     if j.get("job") == job],
            "stragglers": [e for e in doc.get("stragglers", [])
                           if e.get("job") == job]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None,
                    help="job-server port (default: the registered "
                         "service_port knob, 41990)")
    ap.add_argument("--watch", type=float, metavar="SECONDS", default=0.0,
                    help="re-scrape on this interval; counter families "
                         "print per-second rates alongside totals")
    ap.add_argument("--grep", default="",
                    help="only print lines containing this substring")
    ap.add_argument("--job", type=int, default=None,
                    help="filter to one job: metric series carrying "
                         'its job="<id>" label, or its entry in the '
                         "--status document")
    ap.add_argument("--status", action="store_true",
                    help="print the live job-status document (per-job "
                         "progress, attribution split, stragglers, "
                         "ETA) instead of the Prometheus exposition")
    ap.add_argument("--health", action="store_true",
                    help="render the per-rank health table (smoothed "
                         "score, trend, state, time-in-state) from the "
                         "status document's health block instead of "
                         "raw JSON")
    ap.add_argument("--local", action="store_true",
                    help="server rank only (skip the TAG_METRICS "
                         "cross-rank pull)")
    args = ap.parse_args(argv)
    port = args.port
    if port is None:
        port = int(params.get("service_port", 41990))

    if args.status or args.health:
        while True:
            doc = _status_filtered(
                scrape_status(args.host, port,
                              aggregate=not args.local), args.job)
            if args.watch > 0:
                print(f"--- status @ {time.strftime('%H:%M:%S')} ---")
            if args.health:
                print(render_health_table(doc))
            else:
                print(json.dumps(doc, indent=2, sort_keys=True))
            if args.watch <= 0:
                return 0
            try:
                time.sleep(args.watch)
            except KeyboardInterrupt:
                return 0

    job_tag = None if args.job is None else f'job="{args.job}"'

    def emit(text: str) -> None:
        for line in text.splitlines():
            if args.grep and args.grep not in line:
                continue
            if job_tag and job_tag not in line:
                continue
            print(line)

    if args.watch <= 0:
        emit(scrape(args.host, port, aggregate=not args.local))
        return 0

    prev = None
    prev_t = None
    while True:
        text = scrape(args.host, port, aggregate=not args.local)
        now = time.monotonic()
        print(f"--- scrape @ {time.strftime('%H:%M:%S')} ---")
        emit(text)
        cur = _parse_counters(text)
        if prev is not None and now > prev_t:
            dt = now - prev_t
            rates = [(k, (v - prev.get(k, 0.0)) / dt)
                     for k, v in sorted(cur.items())
                     if v != prev.get(k, 0.0)]
            if rates:
                print("--- rates (per second) ---")
                for k, r in rates:
                    if args.grep and args.grep not in k:
                        continue
                    if job_tag and job_tag not in k:
                        continue
                    print(f"{k} {r:.1f}/s")
        prev, prev_t = cur, now
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
