"""The port's recovery plane end to end for DTD and dynamic pools, the
PTG minimal-vs-full A/B, the 4-rank multi-death agreement and elastic
rejoin: ranks killed mid-run (or an engine taken down and restarted), on
the CPU (two to four spawned ranks, ``device="cpu"``).

Twins of tests/test_recovery.py's kill and rejoin cases, run on the port
only, as tests/test_torch_recovery_kill.py's are (the JAX package's own
kill runs fail on and off in its test suite).  The rank functions are
the port's chaos tool's workloads (parsec_tpu_torch/tools/chaos.py).
Each case carries its own ``run_distributed`` timeout.  Where the JAX
package's case kills a rank at a wall-clock time (``kill_rank``), the
twin kills it once it has completed a number of its tasks
(``PARSEC_CHAOS_KILL_AFTER``): the death then lands mid-run however
long the run takes under load, where a loaded host could let the pool
outrun a timed kill and the case would see no death.  The fault plan
keeps its delays, and every assert on the victim's death stays.
"""

import os
import time

import pytest

import torch_comm_workers as W
from parsec_tpu_torch.comm.launch import run_distributed

def _run_with_env(fn, nranks, env, timeout=120, tolerate_ranks=()):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return run_distributed(fn, nranks, timeout=timeout, device="cpu",
                               tolerate_ranks=tolerate_ranks)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_kill_close_recovers_dtd_chain():
    """DTD lineage replay: the insert stream re-runs on the survivor
    against the snapshot-restored tile — EXACT final value."""
    res = _run_with_env(
        W.dtd_chain_recover_workload, 2,
        {"PARSEC_MCA_FAULT_PLAN": "seed=7;delay_frame=tag:DTD,p=1,ms=60",
         "PARSEC_CHAOS_KILL_AFTER": "1:6",
         "PARSEC_MCA_RECOVERY_ENABLE": "1",
         "PARSEC_CHAOS_WAIT_S": "30"},
        timeout=90, tolerate_ranks=(1,))
    assert res[0] == "ok" and res[1] is None


def test_kill_during_the_insert_stream_waits_for_its_end():
    """Rank 1 dies while rank 0's application is still inserting (60
    inserts 20 ms apart, the kill after rank 1's fifth task, about ten
    inserts in): the restart waits for the stream's end before its
    replay, so no task is inserted twice and the survivor ends with the
    exact value."""
    res = _run_with_env(
        W.dtd_paced_insert_recover_workload, 2,
        {"PARSEC_MCA_FAULT_PLAN": "seed=9",
         "PARSEC_CHAOS_KILL_AFTER": "1:5",
         "PARSEC_MCA_RECOVERY_ENABLE": "1",
         "PARSEC_CHAOS_WAIT_S": "30"},
        timeout=90, tolerate_ranks=(1,))
    assert res[1] is None and res[0][0] == "ok"
    assert res[0][1] > 0.5     # the stream outlived the death


def test_kill_dtd_chain_skip_minimal_sole_survivor():
    """2-rank DTD chain kill: the sole survivor short-circuits the skip
    agreement to its local view, ghost-replays the completed prefix and
    ends with the exact final value; the counters prove the minimal path
    (full replays 0, one skip agreement concluded)."""
    res = _run_with_env(
        W.dtd_ab_chain_workload, 2,
        {"PARSEC_MCA_FAULT_PLAN":
         "seed=5;delay_dispatch=key~_dtd_chain_step,ms=100",
         "PARSEC_CHAOS_KILL_AFTER": "1:8",
         "PARSEC_MCA_RECOVERY_ENABLE": "1",
         "PARSEC_CHAOS_WAIT_S": "45"},
        timeout=120, tolerate_ranks=(1,))
    surv = res[0]
    assert surv is not None and surv[0] == "ok" and res[1] is None
    assert surv[2] >= 1 and surv[3] == 0    # minimal, never full
    assert surv[4] >= 1                     # skip agreement concluded


def test_kill_recovers_dynamic_taskpool_with_hold():
    """A DynamicTaskpool killed while its distributed termination hold
    is outstanding restarts on the survivor with the hold re-armed and
    finishes with exact values."""
    res = _run_with_env(
        W.dyn_chain_recover_workload, 2,
        {"PARSEC_MCA_FAULT_PLAN":
         "seed=1;"
         "delay_frame=tag:ACT,p=1,ms=150;delay_frame=tag:BATCH,p=1,ms=150",
         "PARSEC_CHAOS_KILL_AFTER": "1:2",
         "PARSEC_MCA_RECOVERY_ENABLE": "1",
         "PARSEC_CHAOS_WAIT_S": "40"},
        timeout=90, tolerate_ranks=(1,))
    assert res[0] == "ok" and res[1] is None


def test_minimal_replay_reexecutes_strictly_fewer():
    """The PTG A/B: on the SAME mid-run kill, recorded-lineage minimal
    replay re-executes strictly fewer tasks than replay-from-restore-
    point, and each leg provably took its path."""
    plan = "seed=11;delay_dispatch=key~W(,ms=100"
    legs = {}
    for mode, knob in (("minimal", "1"), ("full", "0")):
        res = _run_with_env(
            W.ab_chain_recover_workload, 2,
            {"PARSEC_MCA_FAULT_PLAN": plan,
             "PARSEC_MCA_RECOVERY_ENABLE": "1",
             "PARSEC_MCA_RECOVERY_MINIMAL": knob,
             "PARSEC_CHAOS_KILL_AFTER": "1:3",
             "PARSEC_CHAOS_WAIT_S": "45"},
            timeout=120, tolerate_ranks=(1,))
        surv = res[0]
        assert surv is not None and surv[0] == "ok", (mode, res)
        assert res[1] is None, f"{mode} leg outpaced its kill trigger"
        legs[mode] = {"reexec": surv[1], "minimal": surv[2],
                      "full": surv[3]}
    assert legs["minimal"]["minimal"] >= 1 and legs["minimal"]["full"] == 0
    assert legs["full"]["full"] >= 1
    assert legs["minimal"]["reexec"] < legs["full"]["reexec"], legs


def test_multi_death_agreement_converges_survivors():
    """Two near-simultaneous deaths on a 4-rank gang: the TAG_RECOVER
    agreement round lands both survivors on the SAME confirmed dead set
    and the run completes with validated numerics."""
    res = _run_with_env(
        W.potrf_recover_workload, 4,
        {"PARSEC_MCA_FAULT_PLAN":
         "seed=2;"
         "delay_frame=tag:ACT,p=1,ms=400;delay_frame=tag:BATCH,p=1,ms=400",
         "PARSEC_CHAOS_KILL_AFTER": "2:2,3:2",
         "PARSEC_MCA_RECOVERY_ENABLE": "1",
         "PARSEC_MCA_RECOVERY_MAX_ATTEMPTS": "3",
         "PARSEC_CHAOS_WAIT_S": "60"},
        timeout=150, tolerate_ranks=(2, 3))
    assert res[0] == "ok" and res[1] == "ok"
    assert res[2] is None and res[3] is None   # both kills fired


@pytest.mark.parametrize("transport", ["evloop", "shm"])
def test_killed_rank_rejoins_and_serves(transport):
    """Rank 1's engine goes down after a potrf and comes back as
    incarnation 1 (on shm over the rings the survivor re-created); rank 0
    counts one rejoin, the dead set empties, and a second potrf runs on
    the rejoined rank."""
    t0 = time.monotonic()
    res = _run_with_env(
        W.rejoin_workload, 2,
        {"PARSEC_MCA_COMM_TRANSPORT": transport,
         "PARSEC_MCA_RECOVERY_ENABLE": "1"},
        timeout=150)
    assert time.monotonic() - t0 < 150
    assert res[0]["rejoins"] == 1 and res[0]["dead"] == []
    assert res[1]["epoch"] == 1 and res[1]["dead"] == []
    assert {r["transport"] for r in res} == {transport}
