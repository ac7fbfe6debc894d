"""The port's fault plan (utils/faultinject.py) and the transient retry
path of core/scheduling.py, on both scheduler paths.  Twins of the
single-rank task-fault tests of tests/test_fault.py; the comm directives
and the multi-rank cases are in tests/test_torch_fault.py."""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.errors import FaultInjected, TaskRetryExhausted
from parsec_tpu_torch.native import load_schedext
from parsec_tpu_torch.utils import faultinject
from parsec_tpu_torch.utils.mca import params

se = load_schedext()

_SPEC = ("seed=9;fail_task=key~POTRF(k=0),n=2;"
         "delay_dispatch=ms=5,p=0.1;delay_dispatch=key~GEMM,ms=1.5")


def test_fault_plan_parsing():
    plan = faultinject.FaultPlan(_SPEC)
    assert plan.seed == 9
    kinds = [d.kind for d in plan.directives]
    assert kinds == ["fail_task", "delay_dispatch", "delay_dispatch"]
    ftask, disp, keyed = plan.directives
    assert ftask.key == "POTRF(k=0)" and ftask.n == 2
    assert disp.ms == 5.0 and disp.p == 0.1 and disp.key is None
    assert keyed.key == "GEMM" and keyed.ms == 1.5
    # the comm and health directives parse as the JAX package's do
    # (their hooks: comm/engine.py, comm/shm.py; tests/test_torch_fault.py)
    drop, kill, degrade = (
        faultinject.FaultPlan(spec).directives[0]
        for spec in ("seed=1;drop_frame=tag:ACT,p=0.25",
                     "kill_rank=1@t+2.5s,mode=hang", "degrade=rank=0,ms=5"))
    assert (drop.kind, drop.tag, drop.p) == ("drop_frame", 1, 0.25)
    assert (kill.rank, kill.at_s, kill.mode) == (1, 2.5, "hang")
    assert (degrade.rank, degrade.ms) == (0, 5.0)
    with pytest.raises(ValueError, match="unknown fault-plan field"):
        faultinject.FaultPlan("fail_task=bogus=1")


def test_fault_plan_parses_as_the_jax_package_does():
    from parsec_tpu.utils import faultinject as ref
    fields = ("kind", "p", "n", "ms", "key")
    ours = faultinject.FaultPlan(_SPEC)
    theirs = ref.FaultPlan(_SPEC)
    assert ours.seed == theirs.seed
    assert [[getattr(d, f) for f in fields] for d in ours.directives] == \
        [[getattr(d, f) for f in fields] for d in theirs.directives]


def test_fault_plan_take_counts_and_determinism():
    faultinject.arm("seed=3;fail_task=key~S(k=1),n=2")
    try:
        hits = [faultinject.task_fault("S(k=1)") for _ in range(5)]
        assert hits == [True, True, False, False, False]
        assert not faultinject.task_fault("T(k=1)")   # key gate
        # seeded determinism: the same plan replays the decision stream,
        # and the JAX package's runtime view (same seed) draws the same
        from parsec_tpu.utils import faultinject as ref
        streams = []
        for _ in range(2):
            faultinject.arm("seed=3;fail_task=p=0.5")
            # rank 0, as the JAX package's view below: the module keeps
            # the rank the last armed transport reported, which an
            # earlier test in this process may have left at 1
            faultinject.runtime(0)
            streams.append([faultinject.task_fault("S(k=0)")
                            for _ in range(32)])
        ref.arm("seed=3;fail_task=p=0.5")
        ref.runtime(0)   # rank 0, as the port's single-rank view
        try:
            streams.append([ref.task_fault("S(k=0)") for _ in range(32)])
        finally:
            ref.disarm()
        assert streams[0] == streams[1] == streams[2]
        assert 0 < sum(streams[0]) < 32
    finally:
        faultinject.disarm()
    assert not faultinject.ARMED


def test_unarmed_hooks_are_inert():
    assert faultinject.runtime() is None
    assert not faultinject.task_fault("S(k=0)")
    faultinject.device_delay()
    faultinject.task_delay("S(k=0)")


def _chain(nt, body):
    """An NT-long RW chain over one 4x4 tile (the test_service idiom)."""
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg import DATA, IN, OUT, PTG, Range, TASK
    A = TwoDimBlockCyclic(4, 4, 4, 4, name="A").from_array(
        torch.full((4, 4), 7.0))
    p = PTG("retry", NT=nt)
    p.task("S", k=Range(0, nt - 1)) \
        .affinity(lambda k: A(0, 0)) \
        .flow("T", "RW",
              IN(DATA(lambda k: A(0, 0)), when=lambda k: k == 0),
              IN(TASK("S", "T", lambda k: dict(k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("S", "T", lambda k: dict(k=k + 1)),
                  when=lambda k, NT=nt: k < NT - 1),
              OUT(DATA(lambda k: A(0, 0)),
                  when=lambda k, NT=nt: k == NT - 1)) \
        .body(body)
    return p.build(), A


def test_retry_snapshot_clones_host_tensors_only():
    """The write-flow snapshot clones a host tile and skips a tile that
    lives off the host (a device task's card tensor; a ``meta`` tensor
    stands in for it here), as the JAX package skips device arrays."""
    from types import SimpleNamespace as NS
    from parsec_tpu_torch.core.scheduling import _snapshot_write_flows
    from parsec_tpu_torch.data.data import ACCESS_READ, ACCESS_WRITE
    host = torch.arange(4.0)
    flows = [NS(name="H", access=ACCESS_READ | ACCESS_WRITE),
             NS(name="D", access=ACCESS_READ | ACCESS_WRITE),
             NS(name="R", access=ACCESS_READ)]
    task = NS(task_class=NS(flows=flows), retry_snap=None,
              data={"H": NS(payload=host),
                    "D": NS(payload=torch.empty(4, device="meta")),
                    "R": NS(payload=torch.ones(4))})
    _snapshot_write_flows(task)
    assert set(task.retry_snap) == {"H"}
    snap = task.retry_snap["H"]
    assert torch.equal(snap, host) and snap.data_ptr() != host.data_ptr()


@pytest.mark.parametrize("native", [1, 0])
def test_task_retry_transient_then_success(native):
    """A transiently-failing idempotent body retries against PRISTINE
    inputs (the write-flow snapshot clones the tensor) and the pool
    completes correctly."""
    from parsec_tpu_torch.core.context import Context
    attempts = []

    def flaky(T, k):
        attempts.append((k, T.clone()))
        if k == 1 and sum(1 for a in attempts if a[0] == 1) == 1:
            T[:] = -1.0          # corrupt in place...
            raise RuntimeError("transient glitch")
        return T * 2.0

    params.set("task_retry_max", 2)
    params.set("sched_native", native)
    try:
        tp, A = _chain(3, flaky)
        with Context(nb_cores=2, device="cpu") as ctx:
            assert ctx._retry_max == 2
            assert (ctx.scheduler.name == "native") == bool(native)
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
    finally:
        params.unset("task_retry_max")
        params.unset("sched_native")
    ks = [k for k, _ in attempts]
    assert ks == [0, 1, 1, 2]
    # the retry saw the ORIGINAL value, not the corruption
    torch.testing.assert_close(attempts[2][1], torch.full((4, 4), 14.0))
    torch.testing.assert_close(A.to_array(), torch.full((4, 4), 56.0))


@pytest.mark.parametrize("native", [1, 0])
def test_task_retry_exhausted_is_structured(native):
    from parsec_tpu_torch.core.context import Context
    calls = []

    def always_fails(T):
        calls.append(1)
        raise FaultInjected("injected, forever")

    params.set("task_retry_max", 1)
    params.set("sched_native", native)
    try:
        tp, _ = _chain(1, always_fails)
        with Context(nb_cores=2, device="cpu") as ctx:
            ctx.add_taskpool(tp)
            with pytest.raises(RuntimeError):
                ctx.wait(timeout=30)
            assert len(calls) == 2       # first try + one retry
            exc = ctx._errors[0][0]
            assert isinstance(exc, TaskRetryExhausted)
            assert exc.attempts == 2
            assert isinstance(exc.__cause__, FaultInjected)
    finally:
        params.unset("task_retry_max")
        params.unset("sched_native")


def test_fail_task_plan_retries_through_the_c_chain_gate():
    """An armed plan's fail_task raises a transient fault in the matching
    body; the C chain hands every task of an armed run back to Python
    (counted as fault_armed) and the retry recovers it."""
    from parsec_tpu_torch.core.context import Context
    params.set("task_retry_max", 1)
    faultinject.arm("seed=1;fail_task=key~S(k=1),n=1")
    try:
        tp, A = _chain(3, lambda T: T + 1.0)
        b0 = dict(se.bailout_stats())
        with Context(nb_cores=2, device="cpu") as ctx:
            assert ctx.scheduler.name == "native"
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        b1 = se.bailout_stats()
    finally:
        faultinject.disarm()
        params.unset("task_retry_max")
    torch.testing.assert_close(A.to_array(), torch.full((4, 4), 10.0))
    # 3 tasks, one retried: 4 pops, each handed back while armed
    assert b1["fault_armed"] - b0["fault_armed"] == 4


def test_device_delay_hook_runs_before_a_wave():
    """delay_dispatch arms the device module's pre-launch hook."""
    from parsec_tpu_torch.apps.gemm import gemm_taskpool
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    n, mb = 32, 16
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((n, n)).astype(np.float32)
            for _ in range(2))
    mats = [TwoDimBlockCyclic(mb, mb, n, n, name=nm).from_array(
        torch.from_numpy(x)) for nm, x in
        (("A", a), ("B", b), ("C", np.zeros((n, n), np.float32)))]
    plan = faultinject.arm("seed=2;delay_dispatch=ms=1")
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            ctx.add_taskpool(gemm_taskpool(*mats))
            ctx.wait(timeout=60)
    finally:
        faultinject.disarm()
    (disp,) = plan.directives
    assert disp.fired >= 1
    np.testing.assert_allclose(mats[2].to_array().numpy(), a @ b,
                               rtol=1e-4, atol=1e-4)


def test_geqrf_chain_under_dispatch_delay():
    """The QR slice's chained panel dispatch (device_fuse_panel=1, the
    default) under seeded delay_dispatch perturbation of the device
    manager keeps R correct, on the native scheduler."""
    from parsec_tpu_torch.apps.qr import qr_taskpool
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

    faultinject.arm("seed=31;delay_dispatch=ms=4,p=0.3")
    try:
        for i in range(2):
            rng = np.random.default_rng(2)
            mb, nt = 16, 4
            n = mb * nt
            a = rng.standard_normal((n, n)).astype(np.float32)
            Q = TwoDimBlockCyclic(mb, mb, n, n, name=f"Aqr_f{i}") \
                .from_array(torch.from_numpy(a.copy()))
            with Context(nb_cores=4, device="cpu") as ctx:
                assert ctx.scheduler.name == "native"
                ctx.add_taskpool(qr_taskpool(Q))
                ctx.wait(timeout=300)
            out = Q.to_array().double().numpy()
            ata = a.astype(np.float64).T @ a
            R = np.triu(out)
            qerr = np.abs(R.T @ R - ata).max() / np.abs(ata).max()
            assert qerr < 1e-4, f"iter {i}: wrong R (qerr={qerr:.3e})"
    finally:
        faultinject.disarm()
