#!/usr/bin/env python
"""Live runtime viewer: terminal dashboard over a running job server.

Two modes:

* **remote scrape** (default): poll a resident JobServer's plain-HTTP
  ``GET /status`` + ``GET /metrics`` surface (service/server.py — the
  same port the framed protocol rides) and render the per-job table
  in place: progress, the online exec/queue/comm/idle attribution
  split, stragglers, and the dagsim ETA (prof/liveattr.py)::

      python -m parsec_tpu_torch.tools.live_view --port 41990 [--interval 1.0]

* **aggregator host** (``--serve``): the original gauge-aggregator
  table (reference: tools/aggregator_visu/basic_gui.py — the GUI end
  of the PAPI-SDE live pipeline); ranks' GaugePublishers publish to
  this process::

      python -m parsec_tpu_torch.tools.live_view --serve --port 21900

The port of the JAX package's tools/live_view.py, over the port's
``prof.aggregator``; nothing differs but the package it imports.
"""

import argparse
import json
import socket
import sys
import time

from parsec_tpu_torch.prof.aggregator import Aggregator, render_table
from parsec_tpu_torch.utils.mca import params


def http_get(host: str, port: int, path: str,
             timeout: float = 10.0) -> bytes:
    """Minimal HTTP/1.0 GET (the server answers one-shot and closes);
    returns the body, raises on a non-200 status."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    status_line = head.split(b"\r\n", 1)[0]
    status = status_line.split()
    if len(status) < 2 or status[1] != b"200":
        raise ConnectionError(
            f"GET {path}: {status_line.decode('latin-1', 'replace')}")
    return body


def _fmt_eta(j: dict) -> str:
    eta = j.get("eta_s")
    if eta is None:
        return "-"
    return f"{eta:.2f}s" if eta < 120 else f"{eta / 60:.1f}m"


def _fmt_split(att: dict) -> str:
    e = att.get("elapsed", 0.0) or 0.0
    if e <= 0:
        return "-"
    return "/".join(f"{att.get(k, 0.0) / e:4.0%}"
                    for k in ("exec", "queue", "comm", "idle"))


def _trend_arrow(trend: float) -> str:
    return "↑" if trend > 0.02 else "↓" if trend < -0.02 else "→"


def render_health(doc: dict) -> str:
    """One-line per-rank health strip from the status document's
    ``health`` block (prof/health.py merge_health): smoothed score,
    trend arrow, and — when a rank left 'ok' — its state and how long
    it has been there.  Empty string when the plane is disarmed."""
    ranks = (doc.get("health") or {}).get("ranks") or {}
    if not ranks:
        return ""
    cells = []
    for r in sorted(ranks, key=lambda x: int(x)):
        ent = ranks[r] or {}
        score = float(ent.get("ewma", ent.get("score", 1.0)) or 1.0)
        cell = (f"r{r} {score:.2f}"
                f"{_trend_arrow(float(ent.get('trend', 0.0) or 0.0))}")
        state = str(ent.get("state", "ok"))
        if state != "ok":
            cell += f" {state.upper()} {float(ent.get('since_s', 0)):.0f}s"
        cells.append(cell)
    out = "health: " + "   ".join(cells)
    tr = int((doc.get("health") or {}).get("transitions", 0) or 0)
    if tr:
        out += f"   ({tr} transition{'s' if tr != 1 else ''})"
    return out


def render_status(doc: dict, metrics: dict) -> str:
    lines = []
    svc = doc.get("service") or {}
    lines.append(
        f"parsec_tpu_torch live view — ranks {doc.get('ranks')}  "
        f"pending={svc.get('pending', '-')} "
        f"running={svc.get('running', '-')} "
        f"degraded={svc.get('degraded', '-')}  "
        f"stragglers={doc.get('stragglers_total', 0)}")
    health = render_health(doc)
    if health:
        lines.append(health)
    hdr = (f"{'job':>5} {'name':<16} {'status':<9} {'done':>7} "
           f"{'left':>7} {'exec/queue/comm/idle':<24} {'eta':>8}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for j in doc.get("jobs", []):
        prog = j.get("progress") or {}
        lines.append(
            f"{j.get('job', '?'):>5} {str(j.get('name', ''))[:16]:<16} "
            f"{str(j.get('status', '?'))[:9]:<9} "
            f"{prog.get('done', 0):>7} "
            f"{prog.get('remaining', 0):>7} "
            f"{_fmt_split(j.get('attribution') or {}):<24} "
            f"{_fmt_eta(j):>8}")
    if not doc.get("jobs"):
        lines.append("  (no jobs)")
    agg = doc.get("aggregate") or {}
    lines.append("")
    lines.append(f"aggregate: {agg.get('done', 0)} tasks done, split "
                 f"{_fmt_split(agg.get('attribution') or {})}")
    strag = doc.get("stragglers") or []
    if strag:
        lines.append("recent stragglers:")
        for ev in strag[-5:]:
            lines.append(
                f"  {ev.get('cls')} job={ev.get('job')} "
                f"{ev.get('kind')} {ev.get('latency_s', 0) * 1e3:.1f}ms "
                f"(> {ev.get('threshold_s', 0) * 1e3:.1f}ms) "
                f"{ev.get('task', '')}")
    if metrics:
        lines.append("")
        lines.append("  ".join(f"{k}={metrics[k]:g}"
                               for k in sorted(metrics)))
    return "\n".join(lines)


def _pick_metrics(text: str) -> dict:
    """A few headline families off the /metrics exposition."""
    want = ("parsec_tasks_retired_total", "parsec_pending_tasks",
            "parsec_jobs_slo_breached_total", "parsec_comm_dead_peers")
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        key = line.split("{", 1)[0].split(" ", 1)[0]
        if key in want:
            try:
                out[key] = out.get(key, 0.0) + float(line.rsplit(
                    " ", 1)[1])
            except (ValueError, IndexError):
                continue
    return out


def watch_remote(args) -> None:
    while True:
        try:
            doc = json.loads(http_get(args.host, args.port, "/status"))
            metrics = _pick_metrics(http_get(
                args.host, args.port, "/metrics").decode(
                    "utf-8", "replace"))
            out = render_status(doc, metrics)
        except (OSError, ValueError, ConnectionError) as exc:
            out = f"scrape failed: {exc}"
        if args.once:
            print(out)
            return
        sys.stdout.write("\x1b[2J\x1b[H" + out + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=None,
                    help="job-server port (remote mode; default: the "
                         "registered service_port knob) or aggregator "
                         "port (--serve; default 21900)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--serve", action="store_true",
                    help="host the gauge aggregator here instead of "
                         "scraping a job server (ranks publish to "
                         "this process)")
    ap.add_argument("--once", action="store_true",
                    help="print one table and exit (scripting)")
    args = ap.parse_args(argv)
    if not args.serve:
        if args.port is None:
            args.port = int(params.get("service_port", 41990))
        try:
            watch_remote(args)
        except KeyboardInterrupt:
            pass
        return
    agg = Aggregator(host=args.host,
                     port=args.port if args.port is not None else 21900)
    print(f"aggregating on {args.host}:{agg.port}", file=sys.stderr)
    try:
        while True:
            out = render_table(agg.table(), agg.totals())
            if args.once:
                print(out)
                return
            sys.stdout.write("\x1b[2J\x1b[H" + out + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        agg.close()


if __name__ == "__main__":
    main()
