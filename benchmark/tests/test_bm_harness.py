"""The harness: discovery by name, the window's arithmetic, the trace
reduction, the import guard, the operands and the result's shape."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import guard, operands, readers, spec
from benchmark import trace as tr
from benchmark.harness import run_cell
from benchmark.tests.tiny import GEMM, POTRF, cells, tiny_cell
from benchmark.window import Pass, check_peak, run_window, window_rate

ROOT = Path(spec.ROOT)


# -- discovery -----------------------------------------------------------------

def test_manifest_names_files_that_exist():
    m = spec.load_json(spec.MANIFEST)
    assert m["paths"] == ["benchmark"]
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/configs/")
    for metric in m["end_to_end"] + m["per_layer"]:
        assert (spec.HERE / "metrics" / f"{metric['name']}.py").is_file()
        spec.check_name(metric["name"])
    for w in m["workloads"]:
        assert (spec.HERE / "workloads" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1


@pytest.mark.parametrize("name", cells())
def test_cell_is_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert spec.problem_module(cell.problem).Problem
    assert spec.reference_module(cell.problem).check
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]))
    assert set(cell.limits) == set(
        spec.reference_module(cell.problem).NUMBERS)


def test_a_cell_is_found_only_through_its_own_file():
    m = spec.load_json(spec.MANIFEST)
    name = "potrf_mp.n147456.nb2048"
    m["workloads"].append({"name": name, "config": "potrf_mp_n147456",
                           "traffic": "closed1.tile2048", "chips": 1,
                           "why": "x"})
    with pytest.raises(FileNotFoundError):
        spec.load_cell(name, manifest=m)


def test_names_are_checked():
    for bad in ("../x", "a b", "", "a/b", "x" * 65):
        with pytest.raises(ValueError):
            spec.check_name(bad)
    spec.check_name("k1_roofline.potrf")


# -- the window ----------------------------------------------------------------

def test_window_rate_over_the_whole_window():
    passes = [Pass(10.0, 12.0, False), Pass(12.5, 14.0, False),
              Pass(14.0, 16.0, True)]
    rate, window, good = window_rate(passes, 3e12)
    assert window == 6.0 and good == 2
    assert rate == 2 * 3e12 / 6.0


def test_run_window_ends_with_the_pass_that_started_in_time():
    t = [0.0]

    def clock():
        return t[0]

    def one_pass():
        t[0] += 0.4
        return False
    passes = run_window(one_pass, 1.0, clock=clock)
    # passes start at 0, 0.4, 0.8; the one starting at 1.2 is not run
    assert [round(p.start, 3) for p in passes] == [0.0, 0.4, 0.8]
    assert passes[-1].end == pytest.approx(1.2)
    assert len(run_window(one_pass, 0.0, clock=clock)) == 1


def test_a_pass_faster_than_the_peak_fails_the_run():
    check_peak(Pass(0.0, 1.0, False), 989e12, 989e12)
    with pytest.raises(RuntimeError):
        check_peak(Pass(0.0, 0.5, False), 989e12, 989e12)


# -- the trace -----------------------------------------------------------------

def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    spans = [("bm.pass", 100, 200), ("bm.restore", 100, 110),
             ("bm.wait", 110, 195), ("bm.pass", 200, 300),
             ("bm.wait", 200, 300)]
    events = [
        _ev("void gemm_tile_wgmma_kernel<float, 8>(WgArgs<float, 8>, int)",
            "kernel", 120, 30),
        _ev("void at::native::(anonymous namespace)::cat_kernel<int>()",
            "kernel", 140, 20),          # overlaps the K1 kernel
        _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 102, 6),
        _ev("cusolver_potrf", "kernel", 250, 40),
        _ev("outside", "kernel", 400, 50),
        {"ph": "i", "name": "marker", "cat": "kernel", "ts": 150},
    ]
    return events, spans


def test_spans_in_the_trace_clock():
    assert tr.to_trace_clock([("bm.pass", 5_000_000, 9_000_000)],
                             1_000_000) == [("bm.pass", 4000.0, 8000.0)]


def test_trace_summary_busy_idle_and_gaps():
    s = tr.summarize(*_trace())
    assert (s.t0, s.t1, s.passes) == (100, 300, 2)
    # busy: 102-108, 120-160, 250-290 -> 86 us of 200
    assert s.busy_s == pytest.approx(86e-6)
    assert s.window_s == pytest.approx(200e-6)
    obs = readers.Observation(problem=None, setup_s=1.0, trace=s)
    assert readers.device_idle(obs) == pytest.approx(100 * (1 - 86 / 200))
    # not the port's own: cat_kernel 140-160 and cusolver 250-290 -> 60
    assert readers.library_share(obs) == pytest.approx(100 * 60 / 86)
    gaps = tr.top_gaps(s)
    assert gaps[0][0] == "bm.wait"
    assert gaps[0][1] == pytest.approx(90e-6)       # 160 -> 250
    assert [g[0] for g in gaps].count("bm.restore") == 1
    ops = dict(tr.top_ops(s))
    assert set(ops) == {"gemm_tile_wgmma_kernel", "at::native::anon::cat_kernel",
                        "Memcpy DtoD ", "cusolver_potrf"}
    assert ops["cusolver_potrf"] == pytest.approx(40e-6)


def test_k1_roofline_counts_the_classes_work():
    class P:
        k1_dtype = "bfloat16"

        def k1_tasks_per_pass(self):
            return {"GEMM": 2}

        def k1_work(self, cls):
            return 989e12 * 15e-6, 1.0     # 15 us at the peak a task
    s = tr.summarize(*_trace())
    obs = readers.Observation(problem=P(), setup_s=1.0, trace=s,
                              peaks={"bfloat16": 989e12, "bytes": 3.35e12})
    # 2 passes x 2 tasks x 15 us over K1's 30 us of device time
    assert readers.k1_roofline(obs) == pytest.approx(200.0)


def test_counter_readers():
    obs = readers.Observation(problem=None, setup_s=2.5, rate_flops=3e14,
                              counters={"executed_tasks": 100,
                                        "fused_launches": 10,
                                        "fused_tasks": 40},
                              smi_mhz=[1400.0, 1500.0])
    assert readers.wave_width(obs) == pytest.approx(100 / 70)
    assert readers.sm_clock_mhz(obs) == 1450.0
    assert readers.window_tflops(obs) == 300.0
    assert readers.setup_seconds(obs) == 2.5
    empty = readers.Observation(problem=None, setup_s=1.0)
    for f in (readers.device_idle, readers.library_share,
              readers.k1_roofline, readers.sm_clock_mhz):
        assert f(empty) is None


# -- the import guard ----------------------------------------------------------

def test_guard_compares_whole_top_level_names():
    names = ["parsec_tpu_torch", "parsec_tpu_torch.apps.potrf", "jaxtyping",
             "parsec_tpu", "parsec_tpu.core", "jax.numpy", "flax", "jaxlib"]
    assert guard.forbidden_loaded(names) == [
        "flax", "jax.numpy", "jaxlib", "parsec_tpu", "parsec_tpu.core"]
    assert guard.forbidden_loaded(["parsec_tpu_torch.x", "jaxtyping"]) == []


def test_a_run_loads_no_jax():
    code = ("import sys; sys.argv=['x'];"
            "from benchmark.tests.tiny import tiny_cell, GEMM;"
            "from benchmark.harness import run_cell;"
            "from benchmark import guard;"
            "run_cell(tiny_cell(GEMM), 7, 0.0, False,"
            " device='cpu', out=lambda s: None);"
            "print(guard.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- operands ------------------------------------------------------------------

def test_operands_do_not_depend_on_a_full_size_tile():
    assert operands.panel_rows(6144) == operands.panel_rows(12288) == 1024
    assert operands.panel_rows(16) == 16
    n = 2048
    a = operands.spd_lower_tiles(n, 1024, torch.bfloat16, 5, "cpu", n)
    b = operands.spd_lower_tiles(n, 2048, torch.bfloat16, 5, "cpu", n)
    full_a = torch.zeros(n, n)
    full_b = torch.zeros(n, n)
    for tiles, full, mb in ((a, full_a, 1024), (b, full_b, 2048)):
        for (m, k), t in tiles.items():
            full[m * mb:(m + 1) * mb, k * mb:(k + 1) * mb] = t.float()
    lo_a, lo_b = torch.tril(full_a), torch.tril(full_b)
    assert torch.equal(lo_a, lo_b)
    # symmetric diagonal tiles, diagonal n + U[-0.5, 0.5), entries in range
    for k in range(2):
        t = a[(k, k)].float()
        assert torch.equal(t, t.mT)
    off = torch.tril(full_a, -1)
    assert off.abs().max() <= 0.5 and off.abs().max() > 0.4
    g1 = operands.gaussian_tiles(32, 48, 16, torch.float32, 3, 1, "cpu")
    g2 = operands.gaussian_matrix(32, 48, torch.float32, 3, 1, "cpu", 16)
    assert torch.equal(g1[(1, 2)], g2[16:32, 32:48])
    g3 = operands.gaussian_matrix(32, 48, torch.float32, 4, 1, "cpu", 16)
    assert not torch.equal(g2, g3)


def test_large_seeds_are_taken():
    g = operands.generator(2 ** 31 + 12345, 3, "cpu")
    h = operands.generator(2 ** 40, 3, "cpu")
    assert not torch.equal(torch.rand(4, generator=g),
                           torch.rand(4, generator=h))


# -- the result ----------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
def test_result_shape(trace):
    cell = tiny_cell(POTRF)
    lines = []
    r = run_cell(cell, 2 ** 31 + 99, 0.2, trace, device="cpu",
                 out=lines.append)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in r) == trace
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 2
    assert set(r["checks"]) == set(cell.limits)
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    d = r["device"]
    assert d["count"] == cell.chips == 1
    assert d["memory_peak_bytes_by_card"] == [d["memory_peak_bytes"]]
    assert r["counters"]["executed_tasks"] > 0
    assert r["counters_by_card"] == [r["counters"]]
    if trace:
        assert {"busy_s", "window_s", "busy_s_by_card"} <= set(d)
        assert d["busy_s_by_card"] == [d["busy_s"]]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "busy_s_by_card" not in d
        assert set(r["metrics"]) == {"potrf_tflops", "setup_s"}
        for m in r["metrics"].values():
            assert set(m) == {"value", "unit"}
    json.dumps(r)
    assert any(s.startswith("pass 0 ") for s in lines)


def test_cli_without_a_card_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this test is of a machine without a card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         GEMM, "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
