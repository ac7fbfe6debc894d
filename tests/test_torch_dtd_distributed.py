"""The port's distributed DTD (SPMD insert_task across ranks) against the
JAX package's, on the CPU.

Twins of tests/test_dtd_distributed.py: the same rank functions
(tests/torch_comm_workers.py, ``dtd_*``) run under both packages'
``run_distributed`` — the port's children on ``device="cpu"`` — and each
case must agree on every rank's values, the tasks it executed per class,
its Safra message counts, its pools' termdet counters, and leave no DTD
rendezvous pull or backlogged frame behind.  A spawn costs seconds, so
the cases of one rank count run in turn inside ONE run per package
(``dtd_suite``, a barrier between cases): three runs of each package
cover every case, each bounded by the launcher's ``timeout``.  Past the
twins: the send snapshot of a DTD payload against an in-place write,
eager and by rendezvous, and a lane writer's write-back against a
concurrent payload of another lane.
"""

import functools

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import pytest

import torch_comm_workers as W
from parsec_tpu_torch.comm.launch import run_distributed

T_RUN = 240   # per distributed run, seconds

#: rank count -> the cases run together in one run per package
GROUPS = {
    2: ["dtd_chain", "dtd_war", "dtd_device_chain", "dtd_skip_reader",
        "dtd_skip_writer", "dtd_rdv", "dtd_region_disjoint",
        "dtd_region_barrier", "dtd_region_output_read",
        "dtd_ordering_only"],
    3: ["dtd_broadcast", "dtd_allreduce", "dtd_affinity",
        "dtd_region_three"],
    4: ["dtd_chain", "dtd_war", "dtd_reduce", "dtd_region_quarters"],
}


@functools.lru_cache(maxsize=None)
def _group(nranks):
    return W.run_both(W.dtd_suite, nranks, args=(GROUPS[nranks],),
                      timeout=T_RUN)


def _case(name, nranks):
    """Per-rank results of one case, checked equal across packages;
    returns the port's per-rank values."""
    j, p = _group(nranks)
    vals = []
    for rj, rp in zip(j, p):
        cj, cp = rj[name], rp[name]
        assert cp["vals"] == cj["vals"], (name, cp["vals"], cj["vals"])
        assert cp["done"] == cj["done"], (name, cp["done"], cj["done"])
        assert cp["termdet"] == cj["termdet"], name
        assert cp["pools"] == cj["pools"]
        assert all(c == (0, 0) for c in cp["pools"])
        assert cp["lanes"] == (0, 0)               # no pull, no backlog
        vals.append(cp["vals"])
    # every message a case sent was received somewhere
    assert sum(r[name]["termdet"]["sent"] for r in p) == \
        sum(r[name]["termdet"]["recv"] for r in p)
    return vals


@pytest.mark.parametrize("nranks", [2, 4])
def test_dtd_chain_across_ranks(nranks):
    vals = _case("dtd_chain", nranks)
    assert vals[0]["V0"] == [13.0] * 4


@pytest.mark.parametrize("nranks", [2, 4])
def test_dtd_war_across_ranks(nranks):
    vals = _case("dtd_war", nranks)
    assert all(v["R"] == [7.0] * 4 for v in vals)   # every reader saw v0
    assert vals[0]["V0"] == [100.0] * 4


def test_dtd_broadcast():
    vals = _case("dtd_broadcast", 3)
    assert all(v["R"] == [2.0 * i for i in range(8)] for v in vals)


def test_dtd_reduce():
    vals = _case("dtd_reduce", 4)
    assert vals[0]["acc"] == [10.0] * 4


def test_dtd_allreduce():
    vals = _case("dtd_allreduce", 3)
    assert all(v["S"] == [6.0] * 4 for v in vals)


def test_dtd_affinity_placement():
    vals = _case("dtd_affinity", 3)
    for rank, v in enumerate(vals):
        assert v["local"] == [rank == 0] * 3
        assert v["ran"] == (3 if rank == 0 else 0)
        assert v["V"] == [1.0] * 4        # flushed home to its owner


def test_dtd_distributed_device_chain():
    vals = _case("dtd_device_chain", 2)
    assert vals[0]["V0"] == [256.0] * 8


def test_dtd_skipped_surrogate_reader_order():
    vals = _case("dtd_skip_reader", 2)
    assert vals[1]["R1"] == [1.0] * 4     # the slow reader saw v1
    assert vals[1]["R2"] == [3.0] * 4     # the late reader saw v3
    assert vals[0]["V0"] == [3.0] * 4


def test_dtd_skipped_surrogate_local_writer_order():
    vals = _case("dtd_skip_writer", 2)
    assert vals[1]["R1"] == [1.0] * 4     # reader saw v1, not 50
    assert vals[0]["V0"] == [50.0] * 4


def test_dtd_rendezvous_large_payloads():
    vals = _case("dtd_rdv", 2)
    assert all(v["regions"] == 0 and v["refs_pending"] == 0 for v in vals)
    assert vals[0]["V0"] == [6.0] * 256


def test_dtd_distributed_region_lanes_disjoint_writers():
    vals = _case("dtd_region_disjoint", 2)
    assert all(v["R"] == [5.0] * 4 + [10.0] * 4 for v in vals)


def test_dtd_distributed_region_whole_tile_barrier():
    vals = _case("dtd_region_barrier", 2)
    assert vals[0]["V0"] == [12.0] * 4 + [4.0] * 4


def test_dtd_region_three_rank_disjoint_appliers():
    vals = _case("dtd_region_three", 3)
    assert vals[0]["R0"] == [3.0] * 4 + [4.0] * 4


def test_dtd_region_output_lane_then_whole_read():
    vals = _case("dtd_region_output_read", 2)
    assert vals[1]["R1"] == [9.0] * 4 + [7.0] * 4


def test_dtd_region_four_rank_quarter_lanes():
    vals = _case("dtd_region_quarters", 4)
    want = [v for q in range(4) for v in [3.0 * (q + 1)] * 4]
    assert all(v["R"] == want for v in vals)


def test_dtd_region_ordering_only_across_ranks():
    vals = _case("dtd_ordering_only", 2)
    assert all(v["R"] == [63.0] * 4 for v in vals)


@pytest.mark.parametrize("mb", [64, 32768], ids=["eager", "rendezvous"])
def test_dtd_send_snapshot_precedes_an_in_place_write(mb):
    """The DTD payload of a device producer is frozen when it is encoded
    in the producer's release: rank 0's comm loop is held and the host
    buffer written in place right after the release, and rank 1 still
    reads the producer's bytes (1), not the write's (1001).  32768
    elements (128 KiB) exceed the 64 KiB eager limit: the rendezvous
    path serves a registered copy."""
    res = run_distributed(W.dtd_snapshot, 2, args=("port", mb),
                          device="cpu", timeout=T_RUN)
    assert res[0]["wrote"], res
    assert res[1]["seen"] == 1.0, res


def test_dtd_lane_write_back_keeps_a_concurrent_lane_payload():
    """A region-lane writer writes back its lane's extent only, and a
    lane payload lands in its extent in place: the low lane's payload,
    landing while rank 1's high-lane writer sleeps between reading and
    returning the whole tile, survives the write-back.  (The JAX
    package writes both back whole, so this loses the low lane's write
    there; the port only.)"""
    res = run_distributed(W.dtd_lane_write_back, 2, args=("port",),
                          device="cpu", timeout=T_RUN)
    assert res[1]["R1"] == [1.0] * 4 + [2.0] * 4, res
