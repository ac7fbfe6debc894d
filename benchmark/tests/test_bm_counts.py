"""Flop and byte counts against hand counts for each cell's task mix."""

import pytest

from benchmark import work
from benchmark.problems import gemm, potrf
from benchmark.tests.tiny import cells
from benchmark import spec


def test_potrf_class_counts_match_the_dag():
    # nt=16: 16 POTRF (15 + the last), 120 TRSM, 120 SYRK, 560 GEMM
    c = work.potrf_class_counts(16)
    assert c == {"POTRF": 15, "POTRFL": 1, "TRSM": 120, "SYRK": 120,
                 "GEMM": 560}
    assert sum(c.values()) == 816
    c = work.potrf_class_counts(32)
    assert (c["POTRF"] + c["POTRFL"], c["TRSM"], c["SYRK"], c["GEMM"]) == \
        (32, 496, 496, 4960)
    assert sum(c.values()) == 5984
    assert sum(work.potrf_class_counts(24).values()) == 2600


@pytest.mark.parametrize("tile, tasks", [(12288, 36), (4096, 972),
                                         (6144, 288)])
def test_gemm_class_counts(tile, tasks):
    n = 36864 // tile
    assert work.gemm_class_counts(n, n, 49152 // tile) == {"GEMM": tasks}


def test_potrf_useful_flops_are_n_cubed_over_three():
    assert work.potrf_flops(147456) == 147456 ** 3 / 3
    # the tasks' useful flops add up to n^3/3 up to the lower-order terms
    nt, mb = 24, 6144
    c = work.potrf_class_counts(nt)
    upd = c["SYRK"] * mb * mb * (mb + 1) + c["GEMM"] * 2 * mb ** 3
    assert upd < work.potrf_flops(nt * mb)


def test_k1_task_work_by_hand():
    mb = 6144
    assert work.K1_TASK_WORK["potrf"]["GEMM"](mb, 2, 2) == \
        (2.0 * mb ** 3, 4 * mb * mb * 2)
    assert work.K1_TASK_WORK["potrf"]["SYRK"](mb, 2, 2) == \
        (mb * mb * (mb + 1), 3 * mb * mb * 2)
    # bf16 A and B, f32 C read and written
    assert work.K1_TASK_WORK["gemm"]["GEMM"](4096, 2, 4) == \
        (2.0 * 4096 ** 3, 4096 * 4096 * (2 + 2 + 4 + 4))
    assert work.gemm_flops(36864, 36864, 49152) == \
        2 * 36864 * 36864 * 49152


def test_least_seconds_names_its_bound():
    t, by = work.least_seconds(989e12, 1e9, 989e12, 3.35e12)
    assert (t, by) == (1.0, "operations")
    t, by = work.least_seconds(1.0, 3.35e12, 989e12, 3.35e12)
    assert (t, by) == (1.0, "bytes")


@pytest.mark.parametrize("name", cells())
def test_cells_k1_work_is_compute_bound_at_their_tiles(name):
    cell = spec.load_cell(name)
    mod = {"potrf": potrf, "gemm": gemm}[cell.problem]
    p = mod.Problem(cell.config, cell.traffic, 1, "cpu")
    for cls, count in p.k1_tasks_per_pass().items():
        f, b = p.k1_work(cls)
        assert count > 0
        assert work.least_seconds(f, b, 989e12, 3.35e12)[1] == "operations"
    assert sum(p.tasks_per_pass().values()) == {
        "potrf_mp.n147456.nb6144": 2600,
        "gemm_bf16.n36864.nb12288": 36}[name]
