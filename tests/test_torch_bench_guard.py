"""The port's bench regression guard (parsec_tpu_torch.tools.bench_guard)
twinned with the JAX package's tools/bench_guard.py: the six cases of
tests/test_bench_guard.py run through both guards on the same inputs
(the reference's artifacts named ``BENCH_r*.json``, the port's
``BENCH_TORCH_r*.json``; each line carries the port's identity keys,
which the reference's flattening drops as strings) and must give the
same verdict.  Then the port's refusals: a pair whose backend or card
differ, and a line without ``backend`` (the JAX package's)."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "tools"))
try:
    import bench_guard as ref_guard
finally:
    sys.path.pop(0)

from parsec_tpu_torch.tools import bench_guard as port_guard  # noqa: E402

CPU = {"backend": "cpu", "card_name": None, "card_power_limit": None,
       "host_cpu": "test host"}
CARD = {"backend": "cuda", "card_name": "NVIDIA H100 80GB HBM3",
        "card_power_limit": "700.00 W", "host_cpu": "test host"}


def _write(tmp_path, name, obj):
    p = tmp_path / name
    p.write_text(json.dumps(obj))
    return str(p)


def _artifact(tmp_path, r, parsed, ident=CPU):
    parsed = dict(parsed, **ident)
    for name in (f"BENCH_r{r:02d}.json", f"BENCH_TORCH_r{r:02d}.json"):
        _write(tmp_path, name, {"n": r, "rc": 0, "tail": "...",
                                "parsed": parsed})


def _new(tmp_path, name, obj, ident=CPU):
    return _write(tmp_path, name, dict(obj, **ident))


def _both(path, tmp_path) -> int:
    """Both guards' verdicts on one input; they must agree."""
    ref = ref_guard.main([path, "--repo", str(tmp_path)])
    port = port_guard.main([path, "--repo", str(tmp_path)])
    assert port == ref, (port, ref)
    return port


def _tasks(value):
    return {"metric": "task_throughput", "value": value, "unit": "tasks/s",
            "vs_baseline": value / 1e4}


def test_pass_when_within_threshold(tmp_path):
    _artifact(tmp_path, 5, _tasks(60000.0))
    assert _both(_new(tmp_path, "new.json", _tasks(55000.0)), tmp_path) == 0


def test_fails_on_throughput_regression(tmp_path):
    _artifact(tmp_path, 5, _tasks(60000.0))
    assert _both(_new(tmp_path, "new.json", _tasks(30000.0)), tmp_path) == 1


def test_latency_metrics_regress_upward(tmp_path):
    _artifact(tmp_path, 4, {"metric": "task_rtt", "value": 600.0,
                            "unit": "us/hop", "vs_baseline": 1.7})
    new = _new(tmp_path, "new.json", {"metric": "task_rtt", "value": 480.0,
                                      "unit": "us/hop", "vs_baseline": 2.1})
    assert _both(new, tmp_path) == 0
    worse = _new(tmp_path, "worse.json",
                 {"metric": "task_rtt", "value": 900.0, "unit": "us/hop",
                  "vs_baseline": 1.1})
    assert _both(worse, tmp_path) == 1


def test_cross_mode_compares_shared_keys_only(tmp_path):
    _artifact(tmp_path, 3, {"metric": "tiled_gemm_gflops",
                            "value": 155191.0, "unit": "GFLOP/s",
                            "vs_baseline": 1.43})
    new = _new(tmp_path, "new.json", {"metric": "task_throughput",
                                      "value": 10.0, "unit": "tasks/s",
                                      "vs_baseline": 0.001})
    assert _both(new, tmp_path) == 0


def test_picks_highest_round_artifact(tmp_path):
    _artifact(tmp_path, 2, _tasks(1.0))
    _artifact(tmp_path, 10, _tasks(60000.0))
    assert _both(_new(tmp_path, "new.json", _tasks(30000.0)), tmp_path) == 1


def test_merged_northstar_keys_compare(tmp_path):
    _artifact(tmp_path, 6, {"metric": "tiled_gemm_gflops",
                            "value": 155000.0, "unit": "GFLOP/s",
                            "vs_baseline": 1.43,
                            "tiled_potrf_mp_gflops": 110.0e3,
                            "potrf_vs_baseline": 1.01}, ident=CARD)
    new = _new(tmp_path, "new.json",
               {"metric": "tiled_gemm_gflops", "value": 154000.0,
                "unit": "GFLOP/s", "vs_baseline": 1.42,
                "tiled_potrf_mp_gflops": 60.0e3,
                "potrf_vs_baseline": 0.55}, ident=CARD)
    assert _both(new, tmp_path) == 1


@pytest.mark.parametrize("prev_ident, new_ident", [
    (CPU, CARD),
    (CARD, dict(CARD, card_name="NVIDIA H100 PCIe")),
    ({}, CPU),
], ids=["backend", "card", "reference line"])
def test_refuses_a_pair_of_other_machines(tmp_path, prev_ident, new_ident):
    """A card line against a CPU line, two cards, or a line without
    ``backend`` (what the JAX package's bench prints) compare nothing:
    refused (exit 2) even where the numbers would pass."""
    prev = _write(tmp_path, "prev.json", dict(_tasks(60000.0),
                                               **prev_ident))
    new = _new(tmp_path, "new.json", _tasks(60000.0), ident=new_ident)
    assert port_guard.main([new, "--prev", prev]) == 2
    same = _new(tmp_path, "same.json", _tasks(60000.0), ident=prev_ident)
    assert port_guard.main([same, "--prev", prev]) == \
        (0 if prev_ident else 2)


def test_default_artifact_is_port_side(tmp_path):
    """Only ``BENCH_TORCH_r*.json`` is a previous line: the JAX package's
    ``BENCH_r*.json`` beside it is never read."""
    _write(tmp_path, "BENCH_r09.json", {"parsed": _tasks(1.0)})
    new = _new(tmp_path, "new.json", _tasks(60000.0))
    with pytest.raises(SystemExit, match="BENCH_TORCH_r"):
        port_guard.main([new, "--repo", str(tmp_path)])
    _artifact(tmp_path, 3, _tasks(60000.0))
    assert port_guard._previous(str(tmp_path)).endswith(
        "BENCH_TORCH_r03.json")
