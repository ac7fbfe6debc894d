"""The port's operator tools (parsec_tpu_torch/tools/): trace_info,
trace2chrome, metrics_client, job_client and live_view, on the CPU.

Twins of the JAX package's tool tests (test_prof.py's trace CLI case,
test_critpath.py's ``--merge`` and ``--stats`` cases, test_metrics.py's
one-shot scrape, test_liveattr.py's live view and ``--status`` case,
test_service.py's client round trip), each holding the port's tool
against the JAX package's (tools/ at the root) on the same inputs: the
same trace file read by both tools, the same server answering both
clients, the same status document rendered by both.  Each port tool runs
as ``python -m parsec_tpu_torch.tools.<name>``; the JAX package's runs in
this process through its ``main``.  The chaos harness's twins are in
tests/test_torch_chaos.py.
"""

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys

import pytest

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic
from parsec_tpu_torch.dsl.ptg import DATA, IN, OUT, PTG, Range
from parsec_tpu_torch.prof import install_task_profiler, profiling
from parsec_tpu_torch.prof.reader import intervals, read_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}

TOOLS = ("trace_info", "trace2chrome", "metrics_client", "job_client",
         "live_view", "chaos", "journal_audit")


def port_tool(name, *args, timeout=120):
    """``python -m parsec_tpu_torch.tools.<name> args``: its stdout (a
    non-zero exit fails the test)."""
    r = subprocess.run(
        [sys.executable, "-m", f"parsec_tpu_torch.tools.{name}", *args],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def jax_tool(name, *args):
    """The JAX package's tools/<name>.py ``main(args)`` in this process:
    its stdout."""
    mod = importlib.import_module(f"tools.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(args))
    assert rc == 0, buf.getvalue()
    return buf.getvalue()


def test_tools_import_neither_jax_nor_the_jax_package():
    """Every port tool imports with ``jax`` and ``parsec_tpu`` blocked
    (a None entry in sys.modules makes their import raise)."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'parsec_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for t in {TOOLS!r}:\n"
            "    importlib.import_module('parsec_tpu_torch.tools.' + t)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


# ---------------------------------------------------------------------------
# trace_info / trace2chrome on one rank's trace (test_prof.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four_task_trace(tmp_path_factory):
    """test_prof.py's 4-task PTG (X += 1 on four tiles) traced by the
    port's task profiler."""
    prof = profiling.profiling_init("tools-test")
    V = VectorTwoDimCyclic(mb=2, lm=8)
    for m, _ in V.local_tiles():
        V.data_of(m).copy_on(0).payload[:] = 0.0
    p = PTG("tooltrace", NT=4)
    p.task("T", k=Range(0, 3)) \
        .affinity(lambda k, V=V: V(k)) \
        .flow("X", "RW", IN(DATA(lambda k, V=V: V(k))),
              OUT(DATA(lambda k, V=V: V(k)))) \
        .body(lambda X: X + 1.0)
    with Context(nb_cores=2, device="cpu") as ctx:
        mod = install_task_profiler(ctx, prof)
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
        mod.uninstall(ctx)
    path = prof.dump(str(tmp_path_factory.mktemp("trace") / "tools.ptt"))
    profiling.profiling_fini()
    return path


def _class_stats(text):
    """name -> (count, sum) from either tool's per-class table."""
    out, on = {}, False
    for line in text.splitlines():
        if line.startswith("per-class interval stats"):
            on = True
            continue
        if on:
            f = line.split()
            if len(f) == 6 and f[1].isdigit():
                out[f[0]] = (int(f[1]), float(f[2]))
            elif len(f) > 1 and not line.startswith(" "):
                break
    return out


def _occupancy(text):
    return [ln for ln in text.splitlines() if ln.startswith("  stream ")
            and "intervals" in ln]


def test_trace_info_matches_the_jax_packages_tool(four_task_trace):
    """The same trace through both tools: the headings tests and users
    read, the same per-class counts and sums, the same occupancy lines
    word for word."""
    port = port_tool("trace_info", four_task_trace, "--stats", "--gaps")
    ref = jax_tool("trace_info", four_task_trace, "--stats", "--gaps")
    for heading in ("dictionary", "total events", "per-class interval "
                    "stats", "count", "mean", "per-stream occupancy",
                    "util", "largest gap"):
        assert heading in port and heading in ref
    stats = _class_stats(port)
    assert stats["T"][0] == 4
    assert stats.keys() == _class_stats(ref).keys()
    for name, (n, total) in _class_stats(ref).items():
        assert stats[name][0] == n
        assert stats[name][1] == pytest.approx(total, abs=2e-6)
    assert _occupancy(port) == _occupancy(ref) != []
    head = lambda t: t.split("per-class")[0]  # noqa: E731
    assert head(port) == head(ref)


def test_trace2chrome_matches_the_jax_packages_tool(four_task_trace,
                                                    tmp_path):
    out, ref_out = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    port_tool("trace2chrome", four_task_trace, "-o", out)
    jax_tool("trace2chrome", four_task_trace, "-o", ref_out)
    doc, ref = json.load(open(out)), json.load(open(ref_out))
    assert doc["traceEvents"], "no events exported"
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"])
    key = lambda e: (e["ts"], e["tid"], e["name"])  # noqa: E731
    assert sorted(doc["traceEvents"], key=key) == \
        sorted(ref["traceEvents"], key=key)
    assert doc["otherData"] == ref["otherData"]
    _meta, rows = read_trace(four_task_trace)
    assert len(doc["traceEvents"]) == len(intervals(rows))


# ---------------------------------------------------------------------------
# trace2chrome --merge and trace_info --stats on a 2-rank trace
# (test_critpath.py)
# ---------------------------------------------------------------------------

def test_merge_and_causal_stats_match_the_jax_packages_tools(tmp_path):
    """A 2-rank potrf traced by the port: ``--merge`` gives one flow
    arrow per matched activation (every arrow's two ends), the JAX
    package's tool draws the same arrows and events from the same
    files, and ``--stats`` on rank 1's file prints the queue-wait and
    clock-corrected comm-delay tables, with the JAX package's numbers."""
    import torch_comm_workers as W
    from parsec_tpu_torch.comm.engine import TAG_ACTIVATE
    from parsec_tpu_torch.prof import critpath
    paths = W.run_port(W.traced_potrf, 2, args=(str(tmp_path),),
                       timeout=240)
    out, ref_out = str(tmp_path / "merged.json"), str(tmp_path / "ref.json")
    port_tool("trace2chrome", "--merge", *paths, "-o", out)
    jax_tool("trace2chrome", "--merge", *paths, "-o", ref_out)
    doc, ref = json.load(open(out)), json.load(open(ref_out))
    flows_s = {e["id"] for e in doc["traceEvents"] if e["ph"] == "s"}
    flows_f = {e["id"] for e in doc["traceEvents"] if e["ph"] == "f"}
    assert flows_s == flows_f
    rows, _metas = critpath.merge_traces(paths)
    act = {f"{r['info']['corr'][0]}:{r['info']['corr'][1]}" for r in rows
           if r["name"] == "comm_send"
           and r["info"].get("tag") == TAG_ACTIVATE}
    assert act and act <= flows_s
    assert doc["otherData"]["attribution"]["coverage"] >= 0.95
    assert doc["otherData"]["flow_arrows"] == \
        ref["otherData"]["flow_arrows"] == len(flows_s)
    assert doc["otherData"]["ranks"] == ref["otherData"]["ranks"] == [0, 1]
    def key(e):
        return (e["ph"], e["pid"], e["tid"], e["ts"], e["name"])
    mine = sorted(doc["traceEvents"], key=key)
    theirs = sorted(ref["traceEvents"], key=key)
    assert [key(e) for e in mine] == [key(e) for e in theirs]

    port = port_tool("trace_info", paths[1], "--stats")
    ref_text = jax_tool("trace_info", paths[1], "--stats")
    assert "per-class queue-wait" in port
    assert "comm delay by source rank" in port
    assert "UNCORRECTED" not in port     # offsets were recorded
    delay = re.compile(r"  from rank (\d+): n=(\d+) mean=(\S+) max=(\S+)")
    assert delay.findall(port) == delay.findall(ref_text) != []


# ---------------------------------------------------------------------------
# metrics_client, live_view and job_client against a CPU job server
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_server():
    from parsec_tpu_torch.service.server import JobServer
    from parsec_tpu_torch.service.service import JobService
    svc = JobService(nb_cores=2, device="cpu")
    server = JobServer(svc, port=0)
    try:
        yield svc, server
    finally:
        server.close()
        svc.shutdown(timeout=15)


def _families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def test_metrics_client_one_shot_matches_the_jax_packages(cpu_server):
    """test_metrics.py's one-shot scrape, by the port's client and the
    JAX package's on the same server (one wire protocol): the same
    metric families; the parsing and health-table helpers agree on the
    same inputs."""
    from parsec_tpu_torch.tools import metrics_client as mc
    from tools import metrics_client as ref_mc
    _svc, server = cpu_server
    text = mc.scrape(server.host, server.port)
    assert "parsec_pending_tasks" in text
    assert _families(text) == _families(
        ref_mc.scrape(server.host, server.port))
    assert mc._parse_counters(text).keys() == \
        ref_mc._parse_counters(text).keys()
    doc = {"health": {"ranks": {"0": {"ewma": 0.97, "score": 0.9,
                                      "trend": -0.05, "state": "degraded",
                                      "since_s": 3.5, "src": 0},
                                "1": {}},
                      "folds": 7, "transitions": 1}}
    assert mc.render_health_table(doc) == ref_mc.render_health_table(doc)
    out = port_tool("metrics_client", "--host", server.host, "--port",
                    str(server.port), "--grep", "parsec_pending_tasks")
    assert out and all("parsec_pending_tasks" in ln
                       for ln in out.splitlines())


def test_live_view_and_metrics_client_status(cpu_server):
    """test_liveattr.py's case: ``live_view --once`` and
    ``metrics_client --status --job`` render a finished job of a live
    server; the JAX package's renderer draws the same table from the same
    status document."""
    import parsec_tpu_torch.dsl.ptg as ptg
    from parsec_tpu_torch.tools import live_view as lv
    from tools import live_view as ref_lv
    svc, server = cpu_server

    def factory():
        p = ptg.PTG("jp", NT=60)
        p.task("W", k=ptg.Range(0, 59)).body(lambda: None)
        return p.build(), lambda: None
    job = svc.submit(factory, name="tview")
    assert job.wait(timeout=60)
    out = port_tool("live_view", "--host", server.host, "--port",
                    str(server.port), "--once", timeout=60)
    assert "tview" in out and "exec/queue/comm/idle" in out
    doc = json.loads(port_tool("metrics_client", "--host", server.host,
                               "--port", str(server.port), "--status",
                               "--job", str(job.job_id), timeout=60))
    assert [j["job"] for j in doc["jobs"]] == [job.job_id]
    status = json.loads(lv.http_get(server.host, server.port, "/status"))
    metrics = lv._pick_metrics(lv.http_get(
        server.host, server.port, "/metrics").decode())
    assert metrics == ref_lv._pick_metrics(ref_lv.http_get(
        server.host, server.port, "/metrics").decode())
    mine = lv.render_status(status, metrics).splitlines()
    theirs = ref_lv.render_status(status, metrics).splitlines()
    assert mine[0].replace("parsec_tpu_torch", "parsec_tpu") == theirs[0]
    assert mine[1:] == theirs[1:]


def test_job_client_submit_status_result_roundtrip(cpu_server):
    """test_service.py's round trip through the port's CLI: ``apps``,
    ``submit --wait`` of a stencil job on the CPU (``--set device=cpu``),
    ``status`` and ``result`` of it; the JAX package's client reads the
    same job off the same server alike."""
    _svc, server = cpu_server
    base = ["--host", server.host, "--port", str(server.port)]
    apps = json.loads(port_tool("job_client", *base, "apps"))
    assert apps["ok"] and set(apps["apps"]) >= {"gemm", "potrf", "stencil"}
    out = port_tool("job_client", *base, "submit", "stencil", "--set",
                    "n=32", "--set", "nb=8", "--set", "steps=3", "--set",
                    "device=cpu", "--priority", "1", "--wait")
    dec = json.JSONDecoder()
    sub, end = dec.raw_decode(out)
    res, _ = dec.raw_decode(out[end:].lstrip())
    assert sub["ok"] and res["ok"], out
    assert res["result"]["app"] == "stencil" and res["result"]["norm"] > 0
    jid = str(sub["job"])
    st = json.loads(port_tool("job_client", *base, "status", jid))
    assert st["ok"] and st["info"]["status"] == "DONE"
    again = json.loads(port_tool("job_client", *base, "result", jid))
    assert again["result"] == res["result"]
    ref = json.loads(jax_tool("job_client", *base, "result", jid))
    assert ref["result"] == res["result"]
    ref_st = json.loads(jax_tool("job_client", *base, "status", jid))
    assert ref_st["info"]["status"] == st["info"]["status"]
