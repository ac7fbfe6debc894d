"""The port's comm fault directives end to end, on the CPU (two spawned
ranks of each package, the port's on ``device="cpu"``).

Twins of tests/test_fault.py's multi-process cases.  The frame faults
(duplicated activation and GET_REQ frames deduplicated, dropped GET_REP
frames recovered by the rendezvous retry, a truncated frame failing the
pool with a PeerFailedError, every GET_REP dropped ending in the
rendezvous's terminal timeout) run the same 2-rank potrf workload under
the same plan on both packages, each validating its factor (the JAX
package's chaos workload and the port's chaos tool's).  The kill cases
run the port only (the JAX package's own kill runs fail in its test
suite): an armed flight recorder's incident bundle after a ``kill_rank``,
and a kill over the shm transport contained with a PeerFailedError (the
rank killed once it has completed three of its tasks,
``PARSEC_CHAOS_KILL_AFTER``, where the JAX package's case kills it at a
wall-clock time that a pool under load can outrun).
"""

import glob
import os
import sys

import pytest

import torch_comm_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chaos():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import chaos
    return chaos


def _run_with_env(pkg, fn, nranks, env, timeout=120, **kw):
    if pkg == "jax":
        from parsec_tpu.comm.launch import run_distributed
    else:
        from parsec_tpu_torch.comm.launch import run_distributed
        kw["device"] = "cpu"
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return run_distributed(fn, nranks, timeout=timeout, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _potrf(pkg):
    return _chaos().potrf_workload if pkg == "jax" else W.potrf_workload


_RDV = {"PARSEC_MCA_COMM_EAGER_LIMIT": "512",
        "PARSEC_MCA_COMM_ADAPTIVE_EAGER": "0"}


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("case,plan,env", [
    ("dup-potrf",
     "seed=1;dup_frame=tag:ACT,p=0.5;dup_frame=tag:GET_REQ,p=0.5", {}),
    ("drop-getrep", "seed=1;drop_frame=tag:GET_REP,p=0.5,n=3",
     {**_RDV, "PARSEC_MCA_COMM_RDV_RETRY_S": "0.5"}),
], ids=["dup-potrf", "drop-getrep"])
def test_frame_drop_dup_recovery(pkg, case, plan, env):
    """Dropped GET_REP frames recover through the rendezvous retry;
    duplicated activation and GET_REQ frames are deduplicated — both
    complete CORRECTLY (the workload validates its factor)."""
    res = _run_with_env(pkg, _potrf(pkg), 2,
                        {"PARSEC_MCA_FAULT_PLAN": plan,
                         "PARSEC_CHAOS_WAIT_S": "60", **env}, timeout=120)
    assert res == ["ok", "ok"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_trunc_frame_fails_cleanly(pkg):
    """An undecodable frame severs its connection: the pool fails with
    the structured PeerFailedError, no hang."""
    with pytest.raises(RuntimeError) as ei:
        _run_with_env(pkg, _potrf(pkg), 2,
                      {"PARSEC_MCA_FAULT_PLAN":
                       "seed=1;trunc_frame=tag:ACT,n=1",
                       "PARSEC_CHAOS_WAIT_S": "30"}, timeout=90)
    assert "PeerFailedError" in str(ei.value)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rendezvous_terminal_timeout(pkg):
    with pytest.raises(RuntimeError) as ei:
        _run_with_env(pkg, _potrf(pkg), 2,
                      {"PARSEC_MCA_FAULT_PLAN":
                       "seed=5;drop_frame=tag:GET_REP,p=1",
                       **_RDV,
                       "PARSEC_MCA_COMM_RDV_RETRY_S": "0.3",
                       "PARSEC_MCA_COMM_RDV_TIMEOUT_S": "3",
                       "PARSEC_CHAOS_WAIT_S": "30"}, timeout=90)
    text = str(ei.value)
    assert "PeerFailedError" in text and "rendezvous" in text, text


def test_flightrec_kill_rank_yields_merged_bundle(tmp_path):
    """``kill_rank`` with the flight recorder armed: both ranks' rings
    land in ONE bundle directory, and the merged trace (critpath's
    merge_traces, row dicts) pairs comm_send with dep_deliver on the
    same correlation ids."""
    bundle = str(tmp_path / "bundle")
    with pytest.raises(RuntimeError) as ei:
        _run_with_env(
            "port", W.potrf_workload, 2,
            {"PARSEC_MCA_FAULT_PLAN":
             "seed=7;kill_rank=1@t+1.2s,mode=close;"
             "delay_frame=tag:ACT,p=1,ms=250;"
             "delay_frame=tag:BATCH,p=1,ms=250",
             "PARSEC_MCA_FLIGHTREC_ENABLED": "1",
             "PARSEC_MCA_FLIGHTREC_DIR": bundle,
             "PARSEC_CHAOS_WAIT_S": "30"}, timeout=90)
    assert "PeerFailedError" in str(ei.value)
    traces = sorted(glob.glob(os.path.join(bundle, "rank*.ptt")))
    assert len(traces) == 2, traces
    from parsec_tpu_torch.prof.critpath import merge_traces
    from parsec_tpu_torch.prof.flightrec import summarize_bundle
    s = summarize_bundle(bundle)
    assert s["ranks"] == [0, 1]
    assert s["events"] > 0
    assert s["flows"]["matched"] >= 1, s
    assert s["incidents"] and any("PeerFailedError" in i["reason"]
                                  or "error" in i["reason"]
                                  for i in s["incidents"])
    rows, _metas = merge_traces(traces)

    def corrs(name):
        return {tuple(r["info"]["corr"]) for r in rows
                if r["name"] == name and r["info"]
                and r["info"].get("corr")}
    sends, delivers = corrs("comm_send"), corrs("dep_deliver")
    assert sends & delivers, (len(sends), len(delivers))
    assert {0, 1} <= {r["rank"] for r in rows}


@pytest.mark.parametrize("mode", ["close", "hang"])
def test_kill_shm_fails_cleanly(mode):
    """2-rank kills over the shm rings (hard and silent), recovery off:
    structured PeerFailedError containment, no hang."""
    with pytest.raises(RuntimeError) as ei:
        _run_with_env(
            "port", W.potrf_workload, 2,
            {"PARSEC_MCA_FAULT_PLAN":
             "seed=3;delay_frame=tag:ACT,p=1,ms=400",
             "PARSEC_CHAOS_KILL_AFTER": f"1:3:{mode}",
             "PARSEC_MCA_COMM_TRANSPORT": "shm",
             "PARSEC_MCA_COMM_PEER_TIMEOUT_S": "2",
             "PARSEC_CHAOS_WAIT_S": "25"}, timeout=90)
    assert "PeerFailedError" in str(ei.value)
