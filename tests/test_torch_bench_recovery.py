"""The port's bench entry's recovery mode on the CPU: the chaos tool's
minimal-vs-full replay A/B on the PTG and DTD chains, each against its
no-fault baseline; the line carries the JAX package's metric and unit
(``bench.py::_AUX_MODES``) and both A/B legs took their intended paths."""

import math

from test_torch_bench_aux import run_mode


def test_recovery_mode_prints_the_reference_metric(monkeypatch, capsys):
    line = run_mode("recovery", {}, monkeypatch, capsys)
    assert (line["metric"], line["unit"]) == ("recovery_makespan_ratio",
                                              "ratio")
    assert line["value"] > 0
    rec = line["recovery"]
    for ab in (rec, rec["dtd"]):
        assert ab["minimal"]["minimal"] >= 1 and ab["minimal"]["full"] == 0
        assert ab["full"]["full"] >= 1
        assert ab["minimal"]["reexec"] < ab["full"]["reexec"]
        assert math.isfinite(ab["baseline_s"]) and ab["baseline_s"] > 0
