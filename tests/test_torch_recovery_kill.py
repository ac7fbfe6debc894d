"""The port's recovery plane end to end: a rank killed mid-run, on the
CPU (two or three spawned ranks, ``device="cpu"``).

Twins of tests/test_recovery.py's kill cases, run on the port only (the
JAX package's own kill runs fail in its test suite): a 2-rank potrf whose
rank 1 hard-dies completes on rank 0 with validated numbers, adopted
tiles included; killing rank 0 instead makes rank 1 coordinator and ring
root; with recovery off the same death fails the pool with the structured
PeerFailedError.  The rank functions are the port's chaos tool's
workloads (parsec_tpu_torch/tools/chaos.py).  Where the JAX package's
case kills a rank at a wall-clock time (``kill_rank``), the twin kills it
once it has completed three of its tasks (``PARSEC_CHAOS_KILL_AFTER``), so
that the death lands mid-run however long the run takes under load.  The
frame delay is 400 ms where the reference's is 150: the port's pool
outran a kill at 1.0 s under the shorter delay (it finished in ~0.9 s
after the engine came up).
"""

import os
import time

import pytest

import torch_comm_workers as W
from parsec_tpu_torch.comm.launch import run_distributed

_DELAY = "delay_frame=tag:ACT,p=1,ms=400"


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


def test_kill_close_recovers_potrf():
    res = _run_with_env(
        W.potrf_recover_workload, 2,
        {"PARSEC_MCA_FAULT_PLAN":
         f"seed=11;{_DELAY}",
         "PARSEC_CHAOS_KILL_AFTER": "1:3",
         "PARSEC_MCA_RECOVERY_ENABLE": "1",
         "PARSEC_CHAOS_WAIT_S": "45"},
        timeout=90, tolerate_ranks=(1,))
    assert res[0] == "ok" and res[1] is None   # victim actually died


def test_kill_rank_zero_recovers_on_new_root():
    res = _run_with_env(
        W.potrf_recover_workload, 2,
        {"PARSEC_MCA_FAULT_PLAN":
         f"seed=13;{_DELAY}",
         "PARSEC_CHAOS_KILL_AFTER": "0:3",
         "PARSEC_MCA_RECOVERY_ENABLE": "1",
         "PARSEC_CHAOS_WAIT_S": "45"},
        timeout=90, tolerate_ranks=(0,))
    assert res[1] == "ok" and res[0] is None


def test_recovery_disabled_reproduces_containment():
    with pytest.raises(RuntimeError) as ei:
        _run_with_env(
            W.potrf_recover_workload, 2,
            {"PARSEC_MCA_FAULT_PLAN":
             f"seed=11;{_DELAY}",
             "PARSEC_CHAOS_KILL_AFTER": "1:3",
             "PARSEC_MCA_RECOVERY_ENABLE": "0",
             "PARSEC_CHAOS_WAIT_S": "30"},
            timeout=90)
    assert "PeerFailedError" in str(ei.value)


@pytest.mark.slow
def test_three_rank_potrf_survives_midrun_kill():
    env = {"PARSEC_MCA_RECOVERY_ENABLE": "1", "PARSEC_CHAOS_WAIT_S": "60"}
    t0 = time.monotonic()
    res = _run_with_env(
        W.potrf_recover_workload, 3,
        {**env, "PARSEC_MCA_FAULT_PLAN": f"seed=4;{_DELAY}"}, timeout=120)
    base_s = time.monotonic() - t0
    assert res == ["ok", "ok", "ok"]
    t0 = time.monotonic()
    res = _run_with_env(
        W.potrf_recover_workload, 3,
        {**env, "PARSEC_MCA_FAULT_PLAN": f"seed=4;{_DELAY}",
         "PARSEC_CHAOS_KILL_AFTER": "2:3"},
        timeout=180, tolerate_ranks=(2,))
    kill_s = time.monotonic() - t0
    assert res[0] == "ok" and res[1] == "ok"
    ratio = kill_s / max(base_s, 1e-9)
    print(f"3-rank mid-run kill: baseline {base_s:.1f}s, "
          f"killed {kill_s:.1f}s, ratio {ratio:.2f}x")
    assert ratio < 3.0, (base_s, kill_s)
