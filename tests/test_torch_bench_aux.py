"""Every secondary mode of the port's bench entry
(``python -m parsec_tpu_torch.bench``), and the eff mode end to end, on
the CPU at a small size through the mode's own ``PARSEC_BENCH_*`` (or
``PARSEC_EFF_*``) variables.  Each prints one JSON line with the JAX
package's metric and unit (``bench.py::_AUX_MODES``), a finite value and
the port's identity keys.  The recovery mode, the slowest, has a file of
its own (tests/test_torch_bench_recovery.py).  Last, ``chip_smoke.py``'s
bench phase rehearsed on the CPU (its parsing and limits are tested in
tests/test_torch_chip_smoke.py)."""

import json
import math
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
try:
    import bench as ref_bench
finally:
    sys.path.remove(str(ROOT))

from parsec_tpu_torch import bench as port_bench  # noqa: E402

IDENTITY = {"backend", "card_name", "card_power_limit", "host_cpu"}

#: each mode's size at this test's scale, through its own variables
SIZES = {
    "rtt": {"PARSEC_BENCH_HOPS": "40"},
    "bw": {"PARSEC_BENCH_HOPS": "4"},
    "tasks": {"PARSEC_BENCH_TASKS": "2000"},
    "ntasks": {"PARSEC_BENCH_TASKS": "1200", "PARSEC_BENCH_CHAIN_LEN": "12"},
    "aggregate": {"PARSEC_BENCH_TASKS": "2000", "PARSEC_BENCH_AGG_RANKS": "2"},
    "telemetry": {"PARSEC_BENCH_TASKS": "2000"},
    "journal": {"PARSEC_BENCH_TASKS": "2000"},
    "stencil": {"PARSEC_BENCH_MB": "4096", "PARSEC_BENCH_STEPS": "8"},
    "tracer": {"PARSEC_BENCH_TASKS": "5000"},
    "fabric": {"PARSEC_BENCH_FABRIC_JOBS": "8"},
}


def run_mode(app: str, env: dict, monkeypatch, capsys) -> dict:
    """One line of the port's entry on the CPU, in process; the knobs it
    sets are restored after."""
    from parsec_tpu_torch.utils.mca import params
    monkeypatch.setenv("PARSEC_BENCH_APP", app)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert port_bench.main(["--device", "cpu"]) == 0
    finally:
        params.unset("device")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert IDENTITY <= set(line)
    assert line["backend"] == "cpu"
    assert math.isfinite(line["value"]) and math.isfinite(
        line["vs_baseline"])
    return line


def test_the_modes_are_the_reference_modes():
    assert set(port_bench.AUX_MODES) == set(ref_bench._AUX_MODES)
    assert set(SIZES) | {"recovery"} == set(ref_bench._AUX_MODES)
    for app, (_fn, metric, unit, target, higher) in \
            ref_bench._AUX_MODES.items():
        assert port_bench.AUX_MODES[app][1:] == (metric, unit, target,
                                                 higher), app


@pytest.mark.parametrize("app", sorted(SIZES))
def test_aux_mode_prints_the_reference_metric(app, monkeypatch, capsys):
    line = run_mode(app, SIZES[app], monkeypatch, capsys)
    _fn, metric, unit, _target, _higher = ref_bench._AUX_MODES[app]
    assert (line["metric"], line["unit"]) == (metric, unit)
    assert line["value"] >= 0.0
    if app in ("tasks", "ntasks", "aggregate"):
        assert line["native"]["sched_native"] == 1
        assert line["bailouts"] == {}
    if app in ("rtt", "bw"):
        assert line["protocol"]["act_eager"] > 0
        assert line["value"] > 0
    if app in ("telemetry", "journal"):
        assert line["overhead_us"] >= 0.0 and line["tasks_off"] > 0
    if app == "fabric":
        assert line["fabric"]["audit"] == "clean"
        assert line["fabric"]["jobs"] == 8


def test_eff_mode_end_to_end(monkeypatch, capsys):
    """The measured leg's children (``device="cpu:N"``), the calibration
    and the simulated curve at a small size."""
    line = run_mode("eff", {"PARSEC_EFF_MB": "16", "PARSEC_EFF_NT": "4",
                            "PARSEC_EFF_SIM_MB": "64",
                            "PARSEC_EFF_SIM_NT": "6"}, monkeypatch, capsys)
    assert line["metric"] == "dag_scheduling_efficiency_256"
    assert line["unit"] == "efficiency"
    assert sorted(line["sim_curve"], key=int) == ["8", "16", "32", "64",
                                                  "128", "256"]
    assert set(line["measured_virtual_mesh"]) == {"1", "2", "4", "8"}
    assert line["measured_virtual_mesh"]["1"] == 1.0
    assert set(line["sim_vs_measured_pct"]) == {"cpu_sample1_pct",
                                                "cpu_sample8_pct"}


def test_bench_phase_rehearsal_on_cpu():
    """The bench phase's five lines through ``python -m
    parsec_tpu_torch.bench --device cpu`` at bench.py's CPU sizes (the
    stencil and fabric probes cut through their own variables): each line
    held to the limits, the knob A/B read from two of them."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    out = chip_smoke.phase_bench(device="cpu", extra={
        "stencil": {"PARSEC_BENCH_MB": "4096", "PARSEC_BENCH_STEPS": "8"},
        "fabric": {"PARSEC_BENCH_FABRIC_JOBS": "8"}})
    assert set(out["lines"]) == {label for label, _ in chip_smoke.BENCH_RUNS}
    assert out["launches"] == {"gemm_tile": 0, "gemm_tile_grouped": 0,
                               "gram_tile": 0, "trsm_tile": 0}
    assert out["lines"]["default"]["metric"] == "tiled_gemm_gflops"
    assert out["lines"]["geqrf"]["metric"] == "tiled_geqrf_gflops"
    assert out["knob_ab"]["registered_knobs"]["gflops"] == \
        out["lines"]["potrf registered knobs"]["value"]
