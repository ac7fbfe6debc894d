"""Socket front end for the job service: external processes submit jobs.

A small TCP server in front of a JobService so a resident runtime can be
fed from other processes (tools/job_client.py is the CLI).  The wire
reuses the framing discipline of comm/engine.py — a fixed struct header
carrying magic + protocol version + payload length, rejected on
mismatch — with JSON payloads (requests are control-plane sized, not
tile data):

    !4sII header: (b"PTJS", version, length) then <length> bytes of JSON

Requests are one JSON object; every request gets one JSON reply with an
``ok`` flag.  Ops:

    {"op": "submit", "app": "gemm", "params": {...}, "priority": 5,
     "deadline": 30.0, "client": "cli"}      -> {"ok": true, "job": 7}
                      (under a ServingFabric front the request may also
                       carry "slo", "devices", "devices_max",
                       "resumable" and "slo_policy"; the reply then
                       adds the admission quote: "quote_eta",
                       "verdict" — see service/fabric.py)
    {"op": "status", "job": 7}               -> {"ok": true, "info": {...},
                                                 "queue_position": n|null}
    {"op": "status"}                         -> {"ok": true, "status": {...}}
                      (the LIVE surface: per-job progress, online
                       exec/queue/comm/idle split, stragglers, dagsim
                       ETA — prof/liveattr.py, cross-rank aggregated)
    {"op": "result", "job": 7, "timeout": 60}-> {"ok": true, "result": {...}}
    {"op": "cancel", "job": 7}               -> {"ok": true, "cancelled": b}
    {"op": "jobs"} / {"op": "stats"} / {"op": "gauges"} / {"op": "apps"}
    {"op": "metrics"}  -> {"ok": true, "text": <Prometheus exposition>,
                           "ranks": [...]}   (cross-rank via TAG_METRICS)
    {"op": "journal"}  -> {"ok": true, "ranks": {rank: journal snapshot}}
                      (the control-plane black box, cross-rank — audit
                       with tools/journal_audit.py)

The same port also answers plain HTTP ``GET /metrics`` (Prometheus
text) and ``GET /status`` (the live job-status JSON) — the first four
bytes disambiguate: framed requests lead with the PTJS magic — so a
stock Prometheus scraper or curl needs no client library.

Named apps (the multi-tenant demo catalog) build small self-contained
problems from JSON params and return JSON-able result summaries — the
server never ships tiles over this socket.

The port's copy of the JAX package's service/server.py.  Its deliberate
differences, each commented where it is made:

* the catalog's ``device`` default is ``"cuda"`` (the JAX package's is
  ``"cpu"``), so a job's device bodies run on the card unless its params
  say ``"cpu"``;
* the potrf factory forms its SPD operand, and every result is reduced,
  with torch on the job's device (the card for a ``"cuda"`` job) from the
  same seeded numpy operands: at card sizes host BLAS would cost seconds
  a job;
* each result also carries its own check against the app's plain
  version on that device (GEMM ``rel_err``, stencil ``max_err``; potrf's
  ``residual`` is one already), so a client over the wire can hold a
  served result to it, and the stencil takes a ``fuse`` param;
* the apps are imported with this module, not in each factory;
* the service ``serve`` brings up runs on the card unless
  ``device="cpu"``/``"cpu:N"`` is passed (``--mca device cpu`` on the
  command line).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

# the apps are imported here, not in the factories as the JAX package
# does: factories run on concurrent launch threads, and two first imports
# of the apps package racing each other can see a module half-initialized
from parsec_tpu_torch.apps.cuda_kernels import gemm_tile_reference
from parsec_tpu_torch.apps.gemm import gemm_taskpool
from parsec_tpu_torch.apps.potrf import potrf_taskpool
from parsec_tpu_torch.apps.stencil import stencil_reference, \
    stencil_taskpool
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic, \
    VectorTwoDimCyclic
from parsec_tpu_torch.service.fabric import ServingFabric
from parsec_tpu_torch.service.job import AdmissionError, JobError
from parsec_tpu_torch.service.service import JobService
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import warning

_HDR = struct.Struct("!4sII")      # (magic, proto version, payload bytes)
_MAGIC = b"PTJS"
_VERSION = 1
_MAX_PAYLOAD = 1 << 20             # control plane: 1 MiB is already huge

params.register("service_port", 41990, "job-server default TCP port")


# ---------------------------------------------------------------------------
# framing (shared by server and client)
# ---------------------------------------------------------------------------

def send_msg(conn: socket.socket, obj: Dict[str, Any]) -> None:
    payload = json.dumps(obj).encode()
    conn.sendall(_HDR.pack(_MAGIC, _VERSION, len(payload)) + payload)


def recv_msg(conn: socket.socket,
             pre: bytes = b"") -> Optional[Dict[str, Any]]:
    """Read one framed request.  ``pre`` is bytes the caller already
    consumed while sniffing the protocol (the HTTP-vs-framed dispatch
    in JobServer._serve_conn)."""
    rest = _recv_exact(conn, _HDR.size - len(pre))
    hdr = pre + rest if rest is not None else None
    if hdr is None:
        return None
    magic, ver, n = _HDR.unpack(hdr)
    if magic != _MAGIC or ver != _VERSION or n > _MAX_PAYLOAD:
        raise ConnectionError(
            f"bad job-wire header (magic={magic!r} version={ver} len={n})")
    payload = _recv_exact(conn, n)
    if payload is None:
        return None
    return json.loads(payload)


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except socket.timeout:
            # distinguish "server is slow" from "server closed" for
            # clients with a socket timeout (request()); the server's
            # own sockets are blocking and never hit this
            raise TimeoutError("job-server reply timed out")
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


# ---------------------------------------------------------------------------
# named app catalog
# ---------------------------------------------------------------------------

def _job_device(device: str) -> torch.device:
    """Where a job's operands are formed and its result reduced: the card
    for a "cuda"/"gpu" job when this process sees one, else the host —
    where a CPU-backed device module keeps its tensors (a Context asked
    for "cuda" on a host without a card has raised already)."""
    if device in ("cuda", "gpu") and torch.cuda.is_available():
        return torch.device("cuda")
    return torch.device("cpu")


def _gemm_factory(p: Dict[str, Any]) -> Callable:
    n = int(p.get("n", 256))
    nb = int(p.get("nb", 64))
    seed = int(p.get("seed", 0))
    # deliberate difference: the card by default (the JAX package: cpu)
    device = str(p.get("device", "cuda"))

    def factory():
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((n, n)).astype(np.float32)
        b = rng.standard_normal((n, n)).astype(np.float32)
        A = TwoDimBlockCyclic(mb=nb, nb=nb, lm=n, ln=n).from_array(a)
        B = TwoDimBlockCyclic(mb=nb, nb=nb, lm=n, ln=n).from_array(b)
        C = TwoDimBlockCyclic(mb=nb, nb=nb, lm=n, ln=n).from_array(
            np.zeros((n, n), np.float32))
        tp = gemm_taskpool(A, B, C, beta=0.0, device=device)

        def result():
            # reduced on the job's device and held to the plain product
            # there (deliberate differences, see the module docstring)
            tdev = _job_device(device)
            out = C.to_array().to(tdev)
            want = gemm_tile_reference(torch.from_numpy(a).to(tdev),
                                       torch.from_numpy(b).to(tdev),
                                       torch.zeros_like(out), 1.0)
            return {"app": "gemm", "n": n,
                    "fro_norm": float(torch.linalg.norm(out)),
                    "rel_err": float((out - want).abs().max()
                                     / want.abs().max().clamp(min=1.0))}
        return tp, result
    return factory


def _potrf_factory(p: Dict[str, Any]) -> Callable:
    n = int(p.get("n", 128))
    nb = int(p.get("nb", 32))
    seed = int(p.get("seed", 0))
    device = str(p.get("device", "cuda"))

    def factory():
        rng = np.random.default_rng(seed)
        b = rng.standard_normal((n, n)).astype(np.float32)
        # b @ b.T + n*I with torch on the job's device, from the same
        # seeded b (deliberate difference: host BLAS at card sizes)
        tdev = _job_device(device)
        bt = torch.from_numpy(b).to(tdev)
        spd = bt @ bt.T + n * torch.eye(n, device=tdev)
        # a private host copy: the collection aliases and overwrites it
        A = TwoDimBlockCyclic(mb=nb, nb=nb, lm=n, ln=n).from_array(
            spd.to("cpu", copy=True))
        tp = potrf_taskpool(A, device=device)

        def result():
            L = torch.tril(A.to_array().to(tdev))
            err = float((L @ L.T - spd).abs().max() / spd.abs().max())
            return {"app": "potrf", "n": n, "residual": err}
        return tp, result
    return factory


def _stencil_factory(p: Dict[str, Any]) -> Callable:
    n = int(p.get("n", 256))
    nb = int(p.get("nb", 64))
    steps = int(p.get("steps", 8))
    seed = int(p.get("seed", 0))
    device = str(p.get("device", "cuda"))
    # deliberate difference: the fused-sweep variant is servable too
    fuse = int(p.get("fuse", 1))

    def factory():
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(n).astype(np.float32)
        # a private copy: the collection aliases and overwrites it
        V = VectorTwoDimCyclic(mb=nb, lm=n).from_array(x.copy())
        tp = stencil_taskpool(V, steps, device=device, fuse=fuse)

        def result():
            tdev = _job_device(device)
            v = V.to_array().to(tdev)
            want = stencil_reference(torch.from_numpy(x).to(tdev), steps)
            return {"app": "stencil", "n": n, "steps": steps,
                    "norm": float(torch.linalg.norm(v)),
                    "max_err": float((v.double() - want).abs().max())}
        return tp, result
    return factory


#: name -> params-dict -> taskpool factory
APPS: Dict[str, Callable[[Dict[str, Any]], Callable]] = {
    "gemm": _gemm_factory,
    "potrf": _potrf_factory,
    "stencil": _stencil_factory,
}


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class JobServer:
    """TCP front end over a JobService; one handler thread per client
    connection, requests served sequentially per connection."""

    def __init__(self, service: JobService, host: str = "127.0.0.1",
                 port: Optional[int] = None):
        self.service = service
        self._stop = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port if port is not None
                        else int(params.get("service_port", 41990))))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()[:2]
        # selector-driven accept (comm/engine.py event-loop discipline):
        # a nonblocking listener + a self-pipe instead of a 0.2s accept
        # timeout poll — close() interrupts the wait instantly and an
        # idle server makes zero wakeups
        self._srv.setblocking(False)
        self._wake_r, self._wake_w = socket.socketpair()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="job-server", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        import selectors
        sel = selectors.DefaultSelector()
        sel.register(self._srv, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        try:
            while not self._stop:
                try:
                    events = sel.select()
                except OSError:
                    return       # close() raced us and closed the fds
                for key, _mask in events:
                    if key.data != "accept":
                        return                       # close() poked us
                    try:
                        conn, _addr = self._srv.accept()
                    except (BlockingIOError, InterruptedError):
                        continue
                    except OSError:
                        return
                    # accepted sockets may inherit the listener's
                    # nonblocking mode (BSD/macOS): the per-connection
                    # handler's framed recv is written blocking
                    conn.setblocking(True)
                    # request/reply latency discipline of the comm
                    # transport: no Nagle stall on small JSON replies
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    threading.Thread(target=self._serve_conn,
                                     args=(conn,), daemon=True).start()
        finally:
            sel.close()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop:
                # protocol sniff: the framed wire always leads with the
                # PTJS magic, so a plain-HTTP scraper (Prometheus, curl)
                # is recognizable from its first four bytes and served
                # a one-shot text exposition on the SAME port
                try:
                    head = _recv_exact(conn, 4)
                except OSError:
                    return
                if head is None:
                    return
                if head in (b"GET ", b"HEAD"):
                    self._serve_http(conn, head)
                    return
                try:
                    req = recv_msg(conn, pre=head)
                except (ConnectionError, ValueError) as exc:
                    warning("job-server: dropping connection: %s", exc)
                    return
                if req is None:
                    return
                try:
                    reply = self._handle(req)
                except Exception as exc:   # a bad request must not kill
                    reply = {"ok": False,  # the handler thread
                             "error": f"{type(exc).__name__}: {exc}"}
                try:
                    send_msg(conn, reply)
                except OSError:
                    return

    def _serve_http(self, conn: socket.socket, head: bytes) -> None:
        """One-shot HTTP scrape: ``GET /metrics`` answers the Prometheus
        text exposition (cross-rank aggregated); anything else 404s.
        The request head is drained (bounded) so pipelined headers do
        not linger in the kernel buffer past the close; a stalled
        scraper (slow-loris) trips the socket timeout instead of
        pinning this connection thread forever — this path invites
        arbitrary external HTTP clients onto the port."""
        try:
            conn.settimeout(10.0)
        except OSError:
            return
        data = head
        while b"\r\n\r\n" not in data and len(data) < 8192:
            try:
                chunk = conn.recv(1024)
            except OSError:
                return
            if not chunk:
                break
            data += chunk
        line = data.split(b"\r\n", 1)[0].decode("latin-1", "replace")
        parts = line.split()
        path = (parts[1] if len(parts) > 1 else "/").split("?", 1)[0]
        ctype = "text/plain; version=0.0.4; charset=utf-8"
        if path.rstrip("/") == "/metrics" or path == "/":
            from parsec_tpu_torch.prof.metrics import cluster_exposition
            try:
                text, _ranks = cluster_exposition(self.service.context)
            except Exception as exc:   # scrape must answer, not hang up
                text = f"# scrape failed: {exc}\n"
            status, body = "200 OK", text.encode()
        elif path.rstrip("/") == "/status":
            # the live job-status document (same payload as the framed
            # job-less {"op": "status"}), as JSON for curl/dashboards
            from parsec_tpu_torch.prof.liveattr import cluster_status
            try:
                doc = cluster_status(self.service.context, self.service)
                status, body = "200 OK", json.dumps(doc).encode()
            except Exception as exc:
                status = "500 Internal Server Error"
                body = json.dumps(
                    {"error": f"{type(exc).__name__}: {exc}"}).encode()
            ctype = "application/json"
        else:
            status = "404 Not Found"
            body = (b"parsec_tpu_torch job server: scrape GET /metrics or "
                    b"GET /status\n")
        hdrs = (f"HTTP/1.0 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: close\r\n\r\n")
        try:
            conn.sendall(hdrs.encode()
                         + (b"" if head == b"HEAD" else body))
        except OSError:
            pass

    # -- request handling --------------------------------------------------
    def _job_of(self, req: Dict[str, Any]):
        job = self.service.job(int(req["job"]))
        if job is None:
            raise KeyError(f"no such job {req.get('job')!r}")
        return job

    def _handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "submit":
            return self._op_submit(req)
        if op == "status":
            if req.get("job") is not None:
                # per-job record (the original op shape); under a
                # ServingFabric front a PENDING job also learns its
                # 0-based dispatch-order position in the queue
                job = self._job_of(req)
                reply = {"ok": True, "info": job.info()}
                qp = getattr(self.service, "queue_position", None)
                if callable(qp):
                    reply["queue_position"] = qp(job.job_id)
                return reply
            # job-less status: the LIVE streaming surface — per-job DAG
            # progress, the online exec/queue/comm/idle split, straggler
            # list and the dagsim ETA, aggregated cross-rank over the
            # same TAG_METRICS pull as /metrics (prof/liveattr.py)
            from parsec_tpu_torch.prof.liveattr import cluster_status
            doc = cluster_status(
                self.service.context, self.service,
                aggregate=bool(req.get("aggregate", True)),
                timeout=float(req.get("timeout", 2.0)))
            return {"ok": True, "status": doc}
        if op == "result":
            job = self._job_of(req)
            try:
                res = job.result(timeout=req.get("timeout", 60.0))
            except JobError as exc:
                return {"ok": False, "status": job.status().name,
                        "error": str(exc)}
            return {"ok": True, "status": job.status().name,
                    "result": res}
        if op == "cancel":
            job = self._job_of(req)
            return {"ok": True, "cancelled": job.cancel()}
        if op == "jobs":
            return {"ok": True,
                    "jobs": [j.info() for j in self.service.jobs()]}
        if op == "stats":
            return {"ok": True, "stats": self.service.stats()}
        if op == "gauges":
            return {"ok": True, "gauges": self.service.gauges.snapshot()}
        if op == "metrics":
            from parsec_tpu_torch.prof.metrics import cluster_exposition
            text, ranks = cluster_exposition(
                self.service.context,
                aggregate=bool(req.get("aggregate", True)),
                timeout=float(req.get("timeout", 2.0)))
            return {"ok": True, "text": text, "ranks": ranks}
        if op == "journal":
            # the control-plane black box: every rank's protocol
            # journal (recovery rounds, retirement handshakes, rejoin
            # fencing, barrier generations, job lifecycle), pulled
            # cross-rank over the TAG_METRICS control lane — feed the
            # result to tools/journal_audit.py --timeline / --audit
            from parsec_tpu_torch.prof.journal import cluster_journals
            per_rank = cluster_journals(
                self.service.context,
                timeout=float(req.get("timeout", 2.0)))
            return {"ok": True,
                    "ranks": {str(r): snap
                              for r, snap in per_rank.items()}}
        if op == "apps":
            return {"ok": True, "apps": sorted(APPS)}
        raise ValueError(f"unknown op {op!r}")

    def _op_submit(self, req: Dict[str, Any]) -> Dict[str, Any]:
        app = req.get("app")
        maker = APPS.get(app)
        if maker is None:
            raise ValueError(f"unknown app {app!r} (have {sorted(APPS)})")
        factory = maker(dict(req.get("params") or {}))
        # coerce numeric wire fields: a string deadline from a sloppy
        # client must fail THIS request, not poison the deadline sweep
        deadline = req.get("deadline")
        timeout = req.get("timeout")
        kw: Dict[str, Any] = dict(
            priority=int(req.get("priority", 0)),
            deadline=None if deadline is None else float(deadline),
            client=str(req.get("client", "")),
            name=str(req.get("name", "") or f"{app}"),
            block=bool(req.get("block", False)),
            timeout=None if timeout is None else float(timeout))
        if isinstance(self.service, ServingFabric):
            # fabric-only admission fields; a plain JobService front
            # silently ignores them (its submit has no such kwargs)
            slo = req.get("slo")
            devices = req.get("devices")
            kw.update(
                slo=None if slo is None else float(slo),
                devices=None if devices is None else int(devices),
                devices_max=int(req.get("devices_max", 0) or 0),
                resumable=bool(req.get("resumable", False)),
                app=str(app),
                slo_policy=str(req.get("slo_policy", "") or ""))
        try:
            job = self.service.submit(factory, **kw)
        except AdmissionError as exc:
            return {"ok": False, "rejected": True, "error": str(exc)}
        reply = {"ok": True, "job": job.job_id, "name": job.name}
        if getattr(job, "verdict", None) is not None:
            reply["quote_eta"] = job.quote_eta
            reply["verdict"] = job.verdict
        return reply

    def close(self) -> None:
        self._stop = True
        try:
            self._wake_w.send(b"\0")     # interrupt the selector wait
        except OSError:
            pass
        self._thread.join(timeout=2)
        for s in (self._srv, self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# client library (used by tools/job_client.py and tests)
# ---------------------------------------------------------------------------

def request(host: str, port: int, obj: Dict[str, Any],
            timeout: float = 120.0) -> Dict[str, Any]:
    """One request/reply round trip on a fresh connection."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        send_msg(s, obj)
        reply = recv_msg(s)
    if reply is None:
        raise ConnectionError("job server closed the connection")
    return reply


def serve(port: Optional[int] = None, host: str = "127.0.0.1",
          fabric: bool = False,
          **service_kwargs) -> Tuple[JobService, JobServer]:
    """Bring up a resident service + server pair (blocking callers use
    ``serve_forever``).  ``fabric=True`` fronts a ServingFabric —
    mesh carving, SLO quotes, preemption — instead of the plain
    temporally-shared JobService."""
    cls = ServingFabric if fabric else JobService
    service = cls(**service_kwargs)
    server = JobServer(service, host=host, port=port)
    return service, server


def serve_forever(port: Optional[int] = None, host: str = "127.0.0.1",
                  **service_kwargs) -> None:
    import time as _time
    service, server = serve(port=port, host=host, **service_kwargs)
    print(f"parsec_tpu_torch job server on {server.host}:{server.port} "
          f"(apps: {', '.join(sorted(APPS))})", flush=True)
    try:
        while True:
            _time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        service.shutdown(timeout=30.0)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="resident parsec_tpu_torch job server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--cores", type=int, default=None,
                    help="worker streams for the warm context")
    ap.add_argument("--fabric", action="store_true",
                    help="front a ServingFabric (mesh carving, SLO "
                         "quotes, preemption) instead of the plain "
                         "temporally-shared JobService")
    args, rest = ap.parse_known_args(argv)
    if rest:
        params.parse_cmdline(rest)
    kw = {}
    if args.cores is not None:
        kw["nb_cores"] = args.cores
    serve_forever(port=args.port, host=args.host, fabric=args.fabric,
                  **kw)


if __name__ == "__main__":
    main()
