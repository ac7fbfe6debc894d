#!/usr/bin/env python
"""CLI client for the resident job server (service/server.py).

Submit named app jobs to a warm runtime from another process:

    # in one terminal: the resident server
    python -m parsec_tpu_torch.service.server --port 41990 --cores 4

    # from anywhere else
    J="python -m parsec_tpu_torch.tools.job_client"
    $J submit gemm --set n=512 --set nb=128 \
        --priority 5 --wait

    # serving-fabric tenancy (server started with --fabric): declare a
    # completion SLO, ask for an exclusive 2-device subset elastic to
    # 4, opt into preemption; the reply prints the quoted makespan and
    # the admission verdict
    $J submit gemm --set n=512 --slo 30 \
        --devices 2 --devices-max 4 --resumable

    $J status 1
    $J result 1
    $J cancel 1
    $J jobs
    $J stats
    $J gauges

The wire is the framed-JSON protocol of service/server.py (magic +
version header, comm/engine.py framing discipline).

The port of the JAX package's tools/job_client.py, over the port's
``service.server.request``.  A catalog job's ``device`` param defaults
to ``"cuda"`` on the port's server: a submitted job runs its device
bodies on the card unless ``--set device=cpu`` asks for the CPU, and a
server without a card fails the job rather than falling back.
"""

from __future__ import annotations

import argparse
import json
import sys

from parsec_tpu_torch.service.server import request


def _num(v: str):
    try:
        return int(v, 0)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=41990)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("submit", help="submit a named app job")
    p.add_argument("app", help="gemm | potrf | stencil (see 'apps')")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="app parameter, e.g. --set n=512 --set nb=128")
    p.add_argument("--priority", type=int, default=0)
    p.add_argument("--deadline", type=float, default=None,
                   help="seconds from submission before the job is "
                        "cancelled (TIMEOUT)")
    p.add_argument("--client", default="job_client")
    p.add_argument("--name", default="")
    p.add_argument("--block", action="store_true",
                   help="backpressure-wait for queue room instead of "
                        "failing when the pending queue is full")
    p.add_argument("--slo", type=float, default=None,
                   help="fabric: declared completion SLO in seconds "
                        "from submission; the server quotes a makespan "
                        "and queues/deprioritizes/rejects against it")
    p.add_argument("--devices", type=int, default=None,
                   help="fabric: exclusive accelerator subset to carve "
                        "(0 = temporal sharing of the remainder)")
    p.add_argument("--devices-max", type=int, default=0,
                   help="fabric: elastic ceiling the subset may grow "
                        "to when devices free up")
    p.add_argument("--resumable", action="store_true",
                   help="fabric: allow mid-DAG preemption; the job is "
                        "re-queued and resumed from its materialized "
                        "tiles")
    p.add_argument("--slo-policy", default="",
                   choices=("", "queue", "deprioritize", "reject"),
                   help="fabric: override the server's over-SLO policy "
                        "for this submit")
    p.add_argument("--wait", action="store_true",
                   help="block for and print the job result")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="result wait budget with --wait")

    for name, with_timeout in (("status", False), ("result", True),
                               ("cancel", False)):
        q = sub.add_parser(name)
        q.add_argument("job", type=int)
        if with_timeout:
            q.add_argument("--timeout", type=float, default=600.0)

    sub.add_parser("jobs", help="list all jobs the server has seen")
    sub.add_parser("stats", help="service queue/admission counters")
    sub.add_parser("gauges", help="per-job gauge snapshot")
    sub.add_parser("apps", help="list the server's named apps")

    args = ap.parse_args(argv)

    def rpc(obj, timeout=120.0):
        return request(args.host, args.port, obj, timeout=timeout)

    if args.cmd == "submit":
        params = {}
        for kv in args.set:
            if "=" not in kv:
                ap.error(f"--set wants K=V, got {kv!r}")
            k, v = kv.split("=", 1)
            params[k.strip()] = _num(v.strip())
        req = {"op": "submit", "app": args.app, "params": params,
               "priority": args.priority, "deadline": args.deadline,
               "client": args.client, "name": args.name,
               "block": args.block}
        # fabric admission fields (ignored by a plain JobService front)
        if args.slo is not None:
            req["slo"] = args.slo
        if args.devices is not None:
            req["devices"] = args.devices
        if args.devices_max:
            req["devices_max"] = args.devices_max
        if args.resumable:
            req["resumable"] = True
        if args.slo_policy:
            req["slo_policy"] = args.slo_policy
        if args.block:
            # bound the server-side backpressure wait: an unbounded wait
            # outlives the client's socket timeout and admits a job no
            # one is watching
            req["timeout"] = args.timeout
        reply = rpc(req, timeout=args.timeout + 10.0)
        print(json.dumps(reply, indent=2))
        if reply.get("verdict") is not None or reply.get("rejected"):
            eta = reply.get("quote_eta")
            print(f"quote: eta="
                  f"{'n/a' if eta is None else f'{eta:.3f}s'} "
                  f"verdict={reply.get('verdict') or 'reject'}",
                  file=sys.stderr)
        if not reply.get("ok"):
            return 1
        if args.wait:
            reply = rpc({"op": "result", "job": reply["job"],
                         "timeout": args.timeout},
                        timeout=args.timeout + 10.0)
            print(json.dumps(reply, indent=2))
            return 0 if reply.get("ok") else 1
        return 0

    req = {"op": args.cmd}
    if args.cmd in ("status", "result", "cancel"):
        req["job"] = args.job
    if args.cmd == "result":
        req["timeout"] = args.timeout
        reply = rpc(req, timeout=args.timeout + 10.0)
    else:
        reply = rpc(req)
    print(json.dumps(reply, indent=2))
    if args.cmd == "status" and reply.get("queue_position") is not None:
        print(f"queue position: {reply['queue_position']}",
              file=sys.stderr)
    return 0 if reply.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
