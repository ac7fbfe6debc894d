"""The port stands alone: importing every ``parsec_tpu_torch`` module
(and ``chip_smoke.py``) loads neither JAX nor anything of ``parsec_tpu``
nor pandas nor ml_dtypes (the card host has none), no source of the port
imports them, and the ranks of a distributed run load none of them
either."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "parsec_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "parsec_tpu", "pandas", "ml_dtypes")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    names = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        names.append(".".join(parts))
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "importlib.import_module('chip_smoke')\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTHONPATH")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(PKG))
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad
    assert "parsec_tpu_torch.devices.cuda" in loaded
    assert "chip_smoke" in loaded
    comm = {"parsec_tpu_torch.comm." + m for m in
            ("engine", "frames", "launch", "remote_dep", "shm")}
    assert comm <= set(loaded)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            names = [node.args[0].value]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_c_sources_import_only_the_port():
    """The port's C extensions bind to the port's Python modules: every
    module schedext.c imports at run time names ``parsec_tpu_torch``
    (pinsext.c, the trace sink, imports none)."""
    import re
    imports = {}
    for src in sorted((PKG / "native").glob("*.c")):
        names = re.findall(r'PyImport_ImportModule\("([^"]+)"\)',
                           src.read_text())
        imports[src.name] = names
        bad = [n for n in names if not n.startswith("parsec_tpu_torch.")]
        assert not bad, f"{src}: {bad}"
    assert imports["schedext.c"]
    assert imports["pinsext.c"] == []
    assert imports["commext.c"] == []


def _rank_modules(ctx, rank, nranks):
    """The forbidden modules a rank of a distributed run has loaded."""
    import sys as _sys
    return sorted(m for m in _sys.modules if _forbidden(m))


def test_the_ranks_of_a_distributed_run_load_no_jax():
    """A spawned rank imports the port's comm layer, Context and device
    module and nothing of JAX, the JAX package or ml_dtypes."""
    from parsec_tpu_torch.comm.launch import run_distributed
    assert run_distributed(_rank_modules, 2, device="cpu",
                           timeout=120) == [[], []]


_BLOCKED_RUN = r"""
import importlib.abc, json, sys
BLOCK = ("jax", "jaxlib", "parsec_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCK):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, ROOT)
import torch
from parsec_tpu_torch import Context
from parsec_tpu_torch.apps.gemm import gemm_taskpool
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.ptg import DATA, IN, OUT, PTG, Range, TASK
from parsec_tpu_torch.native import load_schedext

se = load_schedext()
A = TwoDimBlockCyclic(1, 1, 1, 1, name="A").from_array(torch.zeros(1, 1))
g = PTG("iso", NB=5)
g.task("E", i=Range(0, 9)).flow("x", "CTL").body(lambda: None)
g.task("S", k=Range(0, 4)).affinity(lambda k: A(0, 0)) \
    .flow("T", "RW",
          IN(DATA(lambda k: A(0, 0)), when=lambda k: k == 0),
          IN(TASK("S", "T", lambda k: dict(k=k - 1)), when=lambda k: k > 0),
          OUT(TASK("S", "T", lambda k: dict(k=k + 1)), when=lambda k: k < 4),
          OUT(DATA(lambda k: A(0, 0)), when=lambda k: k == 4)) \
    .body(lambda T: T + 1.0)
n, mb = 32, 16
mats = [TwoDimBlockCyclic(mb, mb, n, n, name=nm).from_array(torch.ones(n, n))
        for nm in "XYZ"]
b0 = dict(se.bailout_stats())
with Context(nb_cores=2, device="cpu") as ctx:
    name = ctx.scheduler.name
    ctx.add_taskpool(g.build())
    ctx.add_taskpool(gemm_taskpool(*mats))
    ctx.wait(timeout=60)
b1 = se.bailout_stats()
print(json.dumps({
    "sched": name, "value": float(A.to_array()[0, 0]),
    "gemm": float(mats[2].to_array()[0, 0]),
    "bail": {k: b1[k] - b0[k] for k in b1 if b1[k] != b0[k]},
    "bad": sorted(m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCK))}))
"""


def test_a_port_dag_runs_the_native_path_with_jax_and_reference_refused():
    """ensure_runtime's C-side imports (core.task, utils.faultinject,
    core.scheduling, core.engine, utils.output, data.data) resolve inside
    the port: a DAG runs the C chain with jax and parsec_tpu refused by
    the import system."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTHONPATH")}
    code = f"ROOT = {str(ROOT)!r}\n" + _BLOCKED_RUN
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, env=env, cwd=str(PKG))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["sched"] == "native"
    assert out["value"] == 5.0
    assert out["gemm"] == 1.0 + 32.0          # C + A@B over ones
    assert out["bad"] == []
    # the RW chain's last task writes back (a static bailout), the device
    # GEMMs pop back as non_trivial; the CTL tasks and the rest of the
    # chain stay on the C chain
    assert set(out["bail"]) == {"non_trivial"}, out["bail"]


_BOTH = r"""
import json, re, sys
sys.path.insert(0, ROOT)
import parsec_tpu.core.task as ref_task
import parsec_tpu.native as ref_native
import parsec_tpu_torch.core.task as port_task
from parsec_tpu_torch.native import load_schedext
from parsec_tpu_torch.core.task import TaskClass
from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool

ref_se = ref_native.load_schedext()
if ref_se is None:
    print(json.dumps({"mods": [None]}))
    sys.exit(0)
port_se = load_schedext()
seq = lambda m: int(re.match(r"count\((\d+)", repr(m._task_seq)).group(1))
ref0, port0 = seq(ref_task), seq(port_task)
tp = ParameterizedTaskpool("both")
tc = tp.add_task_class(TaskClass("C", params=[("i", lambda g, l: range(3))],
                                 body=lambda es, task: None))
ts = tc.native_vt().build_range("i", 0, 3, 1)
print(json.dumps({
    "mods": [ref_se.__name__, port_se.__name__],
    "files": [ref_se.__file__, port_se.__file__],
    "port_type": type(ts[0]) is port_se.TaskCore,
    "ref_type": type(ts[0]) is ref_se.TaskCore,
    "seqs": [t.seq for t in ts], "port0": port0,
    "port_after": seq(port_task), "ref_moved": seq(ref_task) - ref0}))
"""


def test_both_packages_extensions_load_in_one_process():
    """The port's schedext has a module name of its own, so it loads
    beside the JAX package's; a port TaskVT builds the port's TaskCore
    and draws from the port's task sequence, never the reference's."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    code = f"ROOT = {str(ROOT)!r}\n" + _BOTH
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, env=env, cwd=str(PKG))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    if out["mods"][0] is None:
        pytest.skip("the JAX package's schedext did not build")
    assert out["mods"] == ["schedext", "parsec_tpu_torch_schedext"]
    assert out["files"][0] != out["files"][1]
    assert out["port_type"] and not out["ref_type"]
    assert out["seqs"] == [out["port0"] + i for i in range(3)]
    assert out["port_after"] == out["port0"] + 3
    assert out["ref_moved"] == 0


_TRACED_RUN = r"""
import importlib, importlib.abc, json, os, sys, tempfile
BLOCK = ("jax", "jaxlib", "parsec_tpu", "pandas")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCK):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, ROOT)
for name in MODULES:
    importlib.import_module(name)
import torch
from parsec_tpu_torch import Context
from parsec_tpu_torch.apps.potrf import potrf_taskpool
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.prof import critpath, profiling
from parsec_tpu_torch.prof.causal import install_causal_tracer
from parsec_tpu_torch.prof.pins import install_task_profiler

n, mb = 32, 8
g = torch.Generator().manual_seed(4)
a = torch.randn(n, n, generator=g)
A = TwoDimBlockCyclic(mb, mb, n, n).from_array(a @ a.T + n * torch.eye(n))
prof = profiling.profiling_init("iso")
with Context(nb_cores=2, device="cpu") as ctx:
    armed = [type(ctx.metrics).__name__, ctx.metrics.liveattr is not None,
             ctx.metrics.health is not None, ctx.journal is not None,
             ctx._ready_stamp]
    mods = [install_task_profiler(ctx, prof),
            install_causal_tracer(ctx, prof)]
    ctx.add_taskpool(potrf_taskpool(A))
    ctx.wait(timeout=120)
    for m in mods:
        m.uninstall(ctx)
    samples = ctx.metrics.samples()
path = profiling.profiling_fini(os.path.join(tempfile.mkdtemp(), "t.ptt"))
att = critpath.attribution([path])
print(json.dumps({
    "armed": armed, "ntasks": att["ntasks"], "overlap": att["overlap"],
    "sum": sum(att["buckets"].values()), "makespan": att["makespan"],
    "retired": [s["v"] for s in samples
                if s["n"] == "parsec_device_tasks_total"],
    "bad": sorted(m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCK))}))
"""


def test_the_telemetry_plane_and_tracer_run_with_pandas_refused():
    """Every module of the port imports with jax, parsec_tpu and pandas
    refused by the import system; a potrf run with the telemetry plane at
    its defaults, the task profiler and the causal tracer armed leaves a
    trace that critpath attributes without pandas."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTHONPATH")}
    code = (f"ROOT = {str(ROOT)!r}\nMODULES = {_module_names()!r}\n"
            + _TRACED_RUN)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, env=env, cwd=str(PKG))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["armed"] == ["RuntimeMetrics", True, True, True, True]
    assert out["ntasks"] == 20                    # nt=4 potrf
    assert out["retired"] == [20]
    # the buckets sum to the makespan plus the critical path's overlap
    # (tests/test_torch_critpath.py::_check_buckets), to their rounding
    assert abs(out["sum"] - out["makespan"] - out["overlap"]) <= 1e-5
    assert out["bad"] == []
