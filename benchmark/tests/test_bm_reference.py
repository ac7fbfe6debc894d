"""The plain references against the port at tiny sizes on the CPU, the
control (the reference in fp8 in the program's place) and the faults a
cell can have: each must come out as not correct."""

import pytest
import torch

from benchmark import faults, spec
from benchmark.harness import run_cell
from benchmark.reference import round_fp8, worse
from benchmark.tests.tiny import POTRF, cells, tiny_cell

#: (cell, tile at test size)
CASES = [(c, t) for c in cells()
         for t in ((16, 32) if c.startswith("potrf") else (16, 8))]


def _run(cell, seed=2 ** 31 + 17):
    return run_cell(cell, seed, 0.0, False, device="cpu", out=lambda s: None)


@pytest.mark.parametrize("name, tile", CASES)
def test_port_agrees_with_the_reference(name, tile):
    r = _run(tiny_cell(name, tile))
    assert r["correct"], r["checks"]
    for c in r["checks"].values():
        assert c["value"] <= c["limit"] / 3


@pytest.mark.parametrize("name", cells())
def test_control_comes_out_not_correct(name):
    cell = tiny_cell(name)
    ref = spec.reference_module(cell.problem)
    nums = ref.control(cell.config, cell.traffic, 11, [torch.device("cpu")])
    assert set(nums) == set(ref.NUMBERS)
    assert any(nums[k] > cell.limits[k] for k in cell.limits), nums


def test_round_fp8_keeps_three_mantissa_bits():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    y = round_fp8(x)
    assert y is not x and not torch.equal(x, y)
    big = x.abs() > x.abs().max() / 32          # normal e4m3 numbers
    rel = ((y - x).abs() / x.abs())[big]
    assert float(rel.max()) <= 2.0 ** -4 * 1.001
    assert float(rel.mean()) > 2.0 ** -6
    # a power-of-two scale: fp8 values that bf16 holds exactly
    assert torch.equal(y.to(torch.bfloat16).float(), y)
    assert float(x.abs().max()) / 2 <= float(y.abs().max()) \
        <= float(x.abs().max()) * (1 + 2.0 ** -4)


def test_worse_takes_nan_as_the_largest():
    assert worse(1.0, float("nan")) == float("inf")
    assert worse(1.0, 2.0) == 2.0


# -- faults planted in the timed path -------------------------------------------

@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", cells())
def test_a_fault_in_the_timed_path_comes_out_not_correct(name, kind):
    with faults.planted(kind):
        r = _run(tiny_cell(name))
    assert r["correct"] is False, r["checks"]


def test_a_planted_fault_is_taken_out_again():
    import parsec_tpu_torch.apps.potrf as potrf_app
    real = potrf_app.gemm_tile
    with faults.planted("half"):
        assert potrf_app.gemm_tile is not real
    assert potrf_app.gemm_tile is real
    with pytest.raises(ValueError):
        faults.faulty("none", real)


def test_a_failed_factor_counts_as_failed(monkeypatch):
    from benchmark.problems import potrf
    monkeypatch.setattr(potrf.Problem, "pass_failed", lambda self, tp: True)
    r = _run(tiny_cell(POTRF))
    assert r["failed"] == r["attempted"] and r["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_port_agrees_with_the_reference_on_the_card(name, card):
    """At a size a test holds, the port sits closer to the reference than
    the fp8 control does on every number, and far closer on one (the
    cell's limits are set at its own size, where the sound gaps differ)."""
    cell = tiny_cell(name, 256)
    cell.config = dict(cell.config, **({"n": 1024, "diagonal": 1024}
                                       if cell.problem == "potrf" else
                                       {"m": 512, "n": 512, "k": 768}))
    r = run_cell(cell, 5, 0.0, False, device="cuda", out=lambda s: None)
    assert r["failed"] == 0
    ref = spec.reference_module(cell.problem)
    low = ref.control(cell.config, cell.traffic, 5, [card])
    got = {k: c["value"] for k, c in r["checks"].items()}
    assert all(got[k] < low[k] for k in got), (got, low)
    assert any(got[k] * 30 < low[k] for k in got), (got, low)
