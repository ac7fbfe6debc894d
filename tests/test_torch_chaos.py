"""The port's chaos harness (parsec_tpu_torch/tools/chaos.py) on the CPU.

Twins of the JAX package's chaos tests (test_fault.py's frame-fault, kill
and shm-kill cases, test_recovery.py's recover catalog, test_journal.py's
audited recover catalog and skip-agreement bundle), run through ``python
-m parsec_tpu_torch.tools.chaos --device cpu``.  The frame-fault cases
run the JAX package's harness (tools/chaos.py) on the same catalog
entries and seeds and compare each case's outcome; the kill cases run the
port only (the JAX package's own kill runs fail on and off in its test
suite), and the catalog itself is held against the JAX package's: the
same entries, workloads and expected outcomes, the same plans but for the
documented delays.  The slow twins are marked slow, as the JAX
package's are.
"""

import os
import re
import subprocess
import sys

import pytest

from parsec_tpu_torch.tools import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}
CASE = re.compile(r"^\[(PASS|FAIL)\] seed=(\d+) (\S+)\s+\[(\S+)\] "
                  r"expect=(\S+) got=(\S+) \(([\d.]+)s\)$", re.M)


def _chaos(only, seeds=1, timeout=300, pkg="port", extra=()):
    cmd = ([sys.executable, "-m", "parsec_tpu_torch.tools.chaos",
            "--device", "cpu"] if pkg == "port"
           else [sys.executable, os.path.join(REPO, "tools", "chaos.py")])
    return subprocess.run(
        cmd + ["--seeds", str(seeds), "--only", only, *extra], cwd=REPO,
        env=ENV, capture_output=True, text=True, timeout=timeout)


def _outcomes(stdout):
    """(status, seed, name, workload, expected, got) of each case."""
    return [m[:6] for m in CASE.findall(stdout)]


def test_chaos_frame_drop_dup_recovery():
    """Dropped GET_REP frames recover through rendezvous retry; dup'd
    activation/DTD frames are deduplicated — both complete CORRECTLY
    (the workloads validate their numbers internally), in both
    packages' harnesses alike."""
    only = "drop-getrep,dup-frames,dup-potrf"
    proc = _chaos(only, seeds=3)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = _chaos(only, seeds=3, pkg="jax")
    assert ref.returncode == 0, ref.stdout + ref.stderr
    got = _outcomes(proc.stdout)
    assert len(got) == 3 and {g[0] for g in got} == {"PASS"}
    assert got == _outcomes(ref.stdout)
    assert "chaos: 3/3 plans held the no-hang invariant" in proc.stdout


def test_chaos_kill_mid_run_fails_cleanly():
    """2-rank kill mid-workload: structured PeerFailedError, no hang,
    well inside the harness deadline."""
    proc = _chaos("kill-close,trunc-act", seeds=2)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [(g[2], g[5]) for g in _outcomes(proc.stdout)] == \
        [("trunc-act", "peer-failed"), ("kill-close", "peer-failed")]


def test_chaos_kill_shm():
    """2-rank shm kills end-to-end (hard + silent) through the chaos
    contract: structured PeerFailedError containment, no hang."""
    proc = _chaos("kill-close-shm,kill-hang-shm", seeds=2)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [g[5] for g in _outcomes(proc.stdout)] == ["peer-failed"] * 2


def test_catalog_is_the_jax_packages():
    """The same entries, workloads, expected outcomes, quick and
    recover subsets and workload names as tools/chaos.py; the plans are
    the same but for the potrf recovery legs' 400 ms delays (150 and,
    in the multi-death entry, 120 ms in the JAX package's)."""
    from tools import chaos as ref
    assert [(n, wl, ex, env) for n, _p, wl, ex, env in chaos.CATALOG] == \
        [(n, wl, ex, env) for n, _p, wl, ex, env in ref.CATALOG]
    assert (chaos._QUICK, chaos._RECOVER) == (ref._QUICK, ref._RECOVER)
    assert chaos.WORKLOADS.keys() == ref.WORKLOADS.keys()
    for (name, plan, *_), (_n, ref_plan, *_r) in zip(chaos.CATALOG,
                                                      ref.CATALOG):
        if plan != ref_plan:
            assert plan == re.sub(r"ms=1[25]0", "ms=400", ref_plan), name
            assert chaos.WORKLOADS[_r[0]] is chaos.potrf_recover_workload


def test_shift_kills_moves_every_kill_rank():
    plan = ("seed=2;kill_rank=2@t+1.0s,mode=close;kill_rank=3@t+1.05s,"
            "mode=close;delay_frame=tag:ACT,p=1,ms=120")
    assert chaos.shift_kills(plan, chaos.START_S) == (
        "seed=2;kill_rank=2@t+3s,mode=close;kill_rank=3@t+3.05s,"
        "mode=close;delay_frame=tag:ACT,p=1,ms=120")
    assert chaos.shift_kills("seed=1;fail_task=p=0.25,n=6", 2.0) == \
        "seed=1;fail_task=p=0.25,n=6"


def test_cuda_run_without_a_card_fails():
    """The harness runs on the card unless told ``--device cpu``; with
    no card it refuses instead of falling back to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "parsec_tpu_torch.tools.chaos", "--only",
         "delay-frames", "--seeds", "1"], cwd=REPO,
        env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr and "PASS" not in proc.stdout


@pytest.mark.slow
def test_chaos_full_catalog():
    """12 seeded plans, zero hangs, zero silent wrong answers (the
    silent-hang kill detected by heartbeat within 2x
    comm_peer_timeout_s)."""
    proc = _chaos("", seeds=12, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.slow
def test_chaos_recover_catalog():
    """The full recovery catalog plus the shm kill->restart->rejoin leg
    through the harness."""
    proc = subprocess.run(
        [sys.executable, "-m", "parsec_tpu_torch.tools.chaos", "--device",
         "cpu", "--recover", "--seeds", "12", "--timeout", "120"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.slow
def test_recover_catalog_journal_audit_clean():
    """The 12-case recover catalog with journaling armed holds every
    auditor invariant (run_case fails a case on any violation, or on a
    silently disarmed journal)."""
    cases = [c for c in chaos.CATALOG if c[0] in chaos._RECOVER]
    assert len(cases) == 12
    failures = []
    for i, (name, plan_t, wl, expect, env) in enumerate(cases):
        ok, outcome, detail = chaos.run_case(
            name, plan_t.format(s=i + 1), wl, expect, env, timeout=120.0,
            audit_journal=True, device="cpu")
        if not ok:
            failures.append((name, outcome, detail[:300]))
    assert not failures, failures


@pytest.mark.slow
def test_skip_agreement_round_reconstructs_from_bundle(tmp_path):
    """The 3-rank kill-dtd-minimal bundle (the tool's workload)
    reconstructs the skip-agreement round: both survivors' offers, the
    agreed cut, the ghost replays and the retirement, in that order on
    one merged clock, with zero violations."""
    from parsec_tpu_torch.comm.launch import run_distributed
    from parsec_tpu_torch.tools import journal_audit
    jdir = str(tmp_path / "bundle")
    plan = ("seed=11;kill_rank=1@t+2.0s,mode=close;"
            "delay_dispatch=key~_dtd_chain_step,ms=100")
    with chaos._Env(plan, {"PARSEC_MCA_JOURNAL_DIR": jdir,
                           "PARSEC_CHAOS_WAIT_S": "45",
                           "PARSEC_MCA_RECOVERY_ENABLE": "1"}):
        res = run_distributed(chaos.WORKLOADS["dtd-minimal"], 3,
                              timeout=120, tolerate_ranks=[1],
                              device="cpu")
    assert res[1] is None, "the kill never fired — nothing recovered"
    per_rank = journal_audit.load_bundle([jdir])
    assert journal_audit.audit(per_rank) == []
    rounds = [r for r in journal_audit.skip_rounds(per_rank)
              if r["cut"] is not None and r["cut"]["prefix"] > 0]
    assert rounds, "no agreed skip cut on the record"
    r = rounds[0]
    assert {0, 2} <= {o["rank"] for o in r["offers"]}
    assert all(r["cut"]["prefix"] <= o["frontier"]
               for o in r["offers"] if o.get("full") is None)
    assert {rep["rank"] for rep in r["replays"]} == {0, 2}
    assert len(r["retired"]) >= 1
    assert max(o["t"] for o in r["offers"]) <= r["cut"]["t"]
    assert r["cut"]["t"] <= min(rep["t"] for rep in r["replays"])
