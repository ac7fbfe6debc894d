"""The port's own rules for the fault-tolerance planes, on the CPU.

A Context starts with the flight recorder and with the recovery plane
armed; with recovery on it registers DTD and dynamic pools with their
recovery specs as it does PTG pools; the drain
before a restore empties the device module (``device="cpu:1"``, the
CPU-backed module that runs the card's pipeline), so no queued kernel of
the torn generation lands on restored bytes; and ``set_init`` with
potrf's bench operand remakes the tiles ``bench_operand`` made.
"""

import time

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.utils import faultinject
from parsec_tpu_torch.utils.mca import params


@pytest.mark.parametrize("knob,attr", [("flightrec_enabled", "_flightrec"),
                                       ("recovery_enable", "recovery")])
def test_fault_tolerance_plane_knob_installs(knob, attr, tmp_path):
    params.set(knob, 1)
    params.set("flightrec_dir", str(tmp_path))
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            assert getattr(ctx, attr) is not None
    finally:
        params.unset(knob)
        params.unset("flightrec_dir")
    with Context(nb_cores=1, device="cpu") as ctx:
        assert ctx._flightrec is None and ctx.recovery is None


def _dtd_pool(V):
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    tp = DTDTaskpool("dtd")
    tp.recovery_collections = [V]
    tp.recovery_replay = lambda pool: None
    return tp


def _dynamic_pool(V):
    from parsec_tpu_torch.core.taskpool import DynamicTaskpool
    tp = DynamicTaskpool("dyn")
    tp.recovery_collections = [V]
    return tp


@pytest.mark.parametrize("make", [_dtd_pool, _dynamic_pool],
                         ids=["dtd", "dynamic"])
def test_recovery_registers_dtd_and_dynamic_pools(make):
    """Under ``recovery_enable`` an insert-driven or dynamic pool with a
    recovery spec registers like a PTG pool: its spec (collections, and
    the DTD pool's replay callable) is recorded, its local tiles are
    snapshotted and its lineage ring is armed, so a peer death restarts
    it (the DTD skip agreement, the dynamic pool's re-armed hold)."""
    from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic
    params.set("recovery_enable", 1)
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            V = VectorTwoDimCyclic(mb=4, lm=8, nodes=1, myrank=0, name="V")
            tp = make(V)
            ctx.add_taskpool(tp)
            spec = ctx.recovery._specs[tp.taskpool_id]
            assert spec["collections"] == [V]
            assert spec["replay"] is tp.recovery_replay
            assert tp._lineage is not None
            assert set(ctx.recovery._snaps[id(V)]) == {(0, 0), (1, 0)}
            tp.cancel()
            ctx.wait(timeout=10)
    finally:
        params.unset("recovery_enable")


def stale_launch_case(device: str, mb: int, on_launch=None) -> None:
    """Two in-place GEMM tasks (C tiles f32, A and B bf16) reach the
    device module, the first held in its manager by a dispatch delay,
    the second queued behind it, when the restart bumps the pool's epoch.
    The drain lets the launched one finish and completes the queued one
    through the fence without launching it (its tile's version is
    tainted); after the restore nothing of the torn generation launches,
    and the restored bytes stay.  ``on_launch()`` returns the kernel
    launches so far (the card's K1 counter), checked to move once."""
    from parsec_tpu_torch.apps.gemm import gemm_taskpool
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((mb, mb)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((mb, 2 * mb))
                         .astype(np.float32))
    params.set("recovery_enable", 1)
    params.set("device_fuse", 1)
    faultinject.arm("seed=1;delay_dispatch=ms=400")
    try:
        with Context(nb_cores=2, device=device) as ctx:
            (dev,) = ctx.device_registry.accelerators
            A = TwoDimBlockCyclic(mb, mb, mb, mb, dtype=torch.bfloat16,
                                  name="A").from_array(a)
            B = TwoDimBlockCyclic(mb, mb, mb, 2 * mb, dtype=torch.bfloat16,
                                  name="B").from_array(b)
            C = TwoDimBlockCyclic(mb, mb, mb, 2 * mb, name="C").from_array(
                torch.zeros(mb, 2 * mb))
            launches0 = on_launch() if on_launch is not None else 0
            tp = gemm_taskpool(A, B, C, device="cuda")
            ctx.add_taskpool(tp)
            ctx.start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with dev._cond:
                    if dev._launching and len(dev._pending) == 1:
                        break
                time.sleep(0.005)
            with dev._cond:
                assert dev._launching == 1 and len(dev._pending) == 1
                queued = dev._pending[0][0]
            qtile = C.data_of(queued.locals["m"], queued.locals["n"])
            v0 = qtile.newest_version()
            tp.run_epoch += 1                      # the restart's fence
            ctx.recovery._drain_inflight(tp)
            with dev._cond:
                assert not dev._pending and dev._launching == 0 \
                    and not dev._inflight
            assert dev.stats.executed_tasks == 1   # the queued one: never
            assert qtile.newest_version() > v0     # fenced, tile tainted
            if on_launch is not None:
                assert on_launch() - launches0 == 1
            restored = torch.full((mb, mb), -7.0)
            for n in range(2):
                C.data_of(0, n).overwrite_host(restored)
            time.sleep(0.6)                        # past another delay
            assert dev.stats.executed_tasks == 1
            if on_launch is not None:
                assert on_launch() - launches0 == 1
            for n in range(2):
                got = C.data_of(0, n).pull_to_host().payload
                assert torch.equal(got, restored)
            tp.cancel()
            ctx.wait(timeout=10)
    finally:
        faultinject.disarm()
        params.unset("device_fuse")
        params.unset("recovery_enable")


def test_stale_device_task_never_lands_on_restored_bytes():
    """Twin of test_stale_body_discard_taints_tile_versions on the
    CPU-backed device module (``stale_launch_case``; the card runs the
    same case in tests/test_torch_cuda.py)."""
    stale_launch_case("cpu:1", 16)


def test_bench_operand_is_a_re_runnable_source():
    """``A.set_init(bench_operand(...))``: the tile recovery remakes for an
    adopted index equals, bit for bit, the one the operand put there
    before the run (bf16 storage, as on the card)."""
    from parsec_tpu_torch.apps.potrf import bench_operand
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    n, mb = 128, 32
    make = bench_operand(n, mb, torch.bfloat16, torch.device("cpu"))
    A = TwoDimBlockCyclic(mb, mb, n, n, nodes=2, myrank=0, P=2,
                          dtype=torch.bfloat16, name="A")
    A.set_init(bench_operand(n, mb, torch.bfloat16, torch.device("cpu")))
    A.set_rank_translation({1: 0})
    try:
        for m, k in A.local_tiles():
            assert torch.equal(A.init_fn(m, k), make(m, k))
        assert make(1, 1)[0, 1] != make(1, 0)[0, 1]   # seeded per tile
    finally:
        A.set_rank_translation(None)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_minimal_plan_sees_desc_tiles_without_records(pkg):
    """A kill before the pool's first completion leaves no lineage record;
    a stale body fenced at the restart may still have written a tile in
    place (its version tainted).  The port's planner sees every desc-read
    tile's live version and refuses the minimal plan (the mutated tile has
    no recorded writer: the full replay restores it).  The JAX package's
    planner sees only the tiles its records name, takes the tile as
    external and returns a plan with no rewind: the pending task then
    re-runs over the mutated bytes (a fault kept by the reference, fixed
    in the port)."""
    import importlib
    root = "parsec_tpu" if pkg == "jax" else "parsec_tpu_torch"
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    P = mod("utils.mca").params
    P.set("recovery_enable", 1)
    try:
        Ctx = mod("core.context").Context
        ctx = Ctx(nb_cores=1) if pkg == "jax" else \
            Ctx(nb_cores=1, device="cpu")
        try:
            A = mod("data.matrix").TwoDimBlockCyclic(
                mb=4, nb=4, lm=16, ln=16, nodes=2, myrank=0, P=2, name="A")
            for m, k in A.local_tiles():
                A.data_of(m, k)
            tp = mod("apps.potrf").potrf_taskpool(A, device="cpu")
            ctx.add_taskpool(tp)                   # snapshot, not started
            rec = ctx.recovery
            A.data_of(0, 0).complete_write(0)      # the stale in-place write
            A.set_rank_translation({1: 0})
            with rec._lock:
                spec = rec._specs[tp.taskpool_id]
            R = mod("core.recovery")
            if pkg == "port":
                with pytest.raises(R.RecoveryUnsupported, match="writer"):
                    rec._compute_minimal(tp, spec, {1}, set())
            else:
                plan = rec._compute_minimal(tp, spec, {1}, set())
                assert ("POTRF", 0) in plan.tasks and not plan.base
            A.set_rank_translation(None)
            tp.cancel()
        finally:
            ctx.fini()
    finally:
        P.unset("recovery_enable")


def test_a_dropped_stale_dtd_task_claims_no_landed_write():
    """The drain's ``drop_stale`` completes a queued stale DTD task
    without launching it (``complete_execution(..., ran=False)``): its
    insert position must not count as completed nor its tile's applied
    version advance, or the skip agreement would take its write as
    landed.  The task already in the manager runs, and does count."""
    from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic
    from parsec_tpu_torch.dsl.dtd import INOUT, DTDTaskpool
    params.set("recovery_enable", 1)
    params.set("device_fuse", 1)
    faultinject.arm("seed=1;delay_dispatch=ms=400")
    try:
        with Context(nb_cores=2, device="cpu:1") as ctx:
            (dev,) = ctx.device_registry.accelerators
            V = VectorTwoDimCyclic(mb=4, lm=8, nodes=1, myrank=0,
                                   name="Vst")
            for m in range(2):
                V.data_of(m).copy_on(0).payload[:] = 0.0
            tp = DTDTaskpool("stale-dtd")
            tp.recovery_collections = [V]
            tp.recovery_replay = lambda pool: None
            ctx.add_taskpool(tp)
            ctx.start()

            def inc(T):
                return T + 1.0
            for m in range(2):
                tp.insert_task(inc, (tp.tile_of(V, m), INOUT),
                               device="cuda")
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                with dev._cond:
                    if dev._launching and len(dev._pending) == 1:
                        break
                time.sleep(0.005)
            with dev._cond:
                assert dev._launching == 1 and len(dev._pending) == 1
                queued = dev._pending[0][0].dtd
            (qtile, _v, _r), = queued.local_writes
            tp.run_epoch += 1                      # the restart's fence
            ctx.recovery._drain_inflight(tp)
            assert queued.insert_pos not in tp._pos_done
            assert qtile.applied_ver == 0
            assert tp._pos_done == {1 - queued.insert_pos}
            tp.cancel()
            ctx.wait(timeout=10)
    finally:
        faultinject.disarm()
        params.unset("device_fuse")
        params.unset("recovery_enable")
