"""``chip_smoke.py`` off the card: it must refuse to run without a CUDA
device, and refuse to run outside the repository; its drivers
(``drive_gemm``, ``drive_qr``, ``drive_potrf``, the front-end, host, traced
and 2-rank phases, and ``phase_serving``'s checks) are rehearsed here at a
tiny size on the port's CPU-backed device module."""

import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(cwd, script):
    return subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                          capture_output=True, text=True, timeout=120)


def test_refuses_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    res = _run(ROOT, ROOT / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_refuses_outside_the_repository(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    res = _run(tmp_path, script)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


NO_LAUNCHES = {"gemm_tile": 0, "gemm_tile_grouped": 0, "gram_tile": 0,
               "trsm_tile": 0}


@pytest.mark.parametrize("max_faults", [1, 3])
def test_refuses_degraded_mode(max_faults):
    """The measured paths run with degraded mode off: a device_max_faults
    set in the MCA environment stops the script before any path runs."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.utils.mca import params
    chip_smoke.check_no_degraded_mode()          # the default, 0
    params.set("device_max_faults", max_faults)
    try:
        with pytest.raises(AssertionError, match="degraded mode off"):
            chip_smoke.check_no_degraded_mode()
    finally:
        params.unset("device_max_faults")


@pytest.mark.parametrize("mb,t", [(24, 2), (8, 4)])
def test_gemm_driver_rehearsal_on_cpu(mb, t):
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=2, device="cpu") as ctx:
        res = chip_smoke.drive_gemm(ctx, mb, t, t, t + 1, passes=1,
                                    gen=torch.Generator().manual_seed(3),
                                    label="rehearsal")
    assert res["ntasks"] == t * t * (t + 1)
    # CPU tensors: the plain versions ran
    assert res["launches"] == NO_LAUNCHES


@pytest.mark.parametrize("dtype,mb,nt,ib", [
    (torch.bfloat16, 32, 3, 16), (torch.float32, 16, 4, 0)],
    ids=["bf16-blocked", "f32-unblocked"])
def test_qr_driver_rehearsal_on_cpu(dtype, mb, nt, ib):
    """The QR path's driver end to end at a tiny size: regenerated tiles,
    per-class incarnation counts, zero lower tiles, the residual and the
    least-squares ladder within the limits the card run holds."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.utils.mca import params
    params.set("qr_ib", ib)
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            res = chip_smoke.drive_qr(ctx, mb, nt, dtype, passes=1,
                                      label="rehearsal")
    finally:
        params.unset("qr_ib")
    assert res["ntasks"] == sum(chip_smoke.qr_task_counts(nt).values())
    assert res["launches"] == NO_LAUNCHES
    assert res["fallbacks"] == 0
    assert res["residual"] <= chip_smoke.QR_RESIDUAL_TOL
    assert min(res["ladder"]) <= chip_smoke.QR_LADDER_TOL


def test_bench_operand_defeats_the_ladder_and_the_conditioned_one_not():
    """The ladder contracts only while cond^2 * eps_bf16 < 1: the geqrf
    bench operand's structure (0.05 * N(0, 1) + I in every tile) breaks
    that bound by orders of magnitude already at n = 384, nt = 8, and the
    conditioned operand keeps it (qr_operand_cond.py prints the values at
    larger n)."""
    sys.path.insert(0, str(ROOT))
    try:
        import qr_operand_cond
    finally:
        sys.path.remove(str(ROOT))
    eps = qr_operand_cond.EPS_BF16
    assert qr_operand_cond.operand_cond(48, 8, False) ** 2 * eps > 1e3
    assert qr_operand_cond.operand_cond(48, 8, True) ** 2 * eps < 0.1


def test_qr_task_counts_at_the_bench_geometry():
    assert _chip_smoke().qr_task_counts(8) == {
        "GEQRT": 8, "UNMQR": 28, "TSQRT": 28, "TSMQR": 140}


@pytest.mark.parametrize("dtype,mb,nt", [
    (torch.bfloat16, 32, 3), (torch.float32, 16, 4), (torch.bfloat16, 16, 1)],
    ids=["bf16", "f32", "one-tile"])
def test_potrf_path_rehearsal_on_cpu(dtype, mb, nt):
    """The potrf path end to end at a tiny size: regenerated lower
    tiles, per-class incarnation counts, the Cholesky flag, the backward
    error and the refinement ladder within the limits the card run
    holds."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=2, device="cpu") as ctx:
        res = chip_smoke.drive_potrf(ctx, mb, nt, dtype, passes=2,
                                     label="rehearsal")
    assert res["ntasks"] == sum(chip_smoke.potrf_task_counts(nt).values())
    assert res["launches"] == NO_LAUNCHES
    assert len(res["times"]) == 2
    assert res["backward_error"] <= chip_smoke.POTRF_BWD_TOL
    assert res["ir"][-1] <= chip_smoke.POTRF_IR_TOL


def test_potrf_task_counts_at_the_bench_geometry():
    counts = _chip_smoke().potrf_task_counts(16)
    assert counts == {"POTRF": 15, "POTRFL": 1, "TRSM": 120, "SYRK": 120,
                      "GEMM": 560}
    assert sum(counts.values()) == 816


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_potrf_operand_is_the_bench_operand(dtype):
    """The card's per-tile generator gives bench.py's potrf operand bit for
    bit (``_tile_generator``, seeded by the tile's index in
    ``local_tiles()``, n on the diagonal tiles), in either storage type."""
    import ml_dtypes
    import numpy as np
    import types
    sys.path.insert(0, str(ROOT))
    try:
        import bench
    finally:
        sys.path.remove(str(ROOT))
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    mb, nt = 48, 3
    A = TwoDimBlockCyclic(mb, mb, mb * nt, mb * nt, dtype=dtype)
    tile = chip_smoke.potrf_tile_maker(A, torch.device("cpu"))
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    gen = bench._tile_generator(types.SimpleNamespace(mb=mb, nb=mb,
                                                      dtype=np_dtype))
    for i, (m, k) in enumerate(A.local_tiles()):
        want = np.asarray(gen(float(i), float(A.lm) if m == k else 0.0))
        got = tile(m, k)
        assert got.dtype == A.dtype
        assert np.array_equal(got.float().numpy(), want.astype(np.float32)), \
            (m, k)


@pytest.mark.parametrize("kind", ["tasks", "ntasks"])
@pytest.mark.parametrize("sched_native", [1, 0])
def test_host_probe_rehearsal_on_cpu(kind, sched_native):
    """The host phase's probes at a small size on both scheduler paths:
    the chains' results are checked inside, and on the native path
    neither probe hands a task back to Python."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.host_probe(kind, sched_native, n=400, nc=20, nb=6,
                                cores=2)
    assert res["sched"] == ("native" if sched_native else "lfq")
    assert res["tasks"] == (400 if kind == "tasks" else 120)
    assert res["tasks_per_s"] > 0
    assert res["bailouts"] == {}


def test_host_phase_rehearsal_on_cpu():
    chip_smoke = _chip_smoke()
    out = chip_smoke.phase_host("rehearsal card", rounds=1, n=200, nc=10,
                                nb=4, cores=2)
    assert set(out["best"]) == {f"{k} sched_native={f}"
                                for k in ("tasks", "ntasks") for f in (1, 0)}
    assert "cores" in out["cpu"]
    assert set(out["overhead"]) == {"telemetry", "journal", "tracer"}


@pytest.mark.parametrize("kind", ["telemetry", "journal", "tracer"])
def test_overhead_probe_rehearsal_on_cpu(kind):
    """Each overhead probe runs its pairs armed and off (the plane's
    presence and the task count checked inside) and reports the minimum
    pair ratio and us per task against the JAX package's CPU gate."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.overhead_probe(kind, n=300, pairs=2, cores=2)
    assert len(res["pairs"]) == 2
    assert res["ratio"] == min(res["pairs"]) >= 0.0
    assert res["us_per_task"] >= 0.0
    assert res["gate_us"] == chip_smoke.OVERHEAD_GATES_US[kind]
    assert res["verdict"] in ("within", "over")


def test_span_union():
    span_union = _chip_smoke().span_union
    assert span_union([]) == 0.0
    assert span_union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == 3.0
    assert span_union([(2.0, 3.0), (0.0, 5.0), (1.0, 2.0)]) == 5.0


@pytest.mark.parametrize("app", ["gemm", "potrf"])
def test_traced_pass_and_telemetry_rehearsal_on_cpu(app):
    """The traced pass (one exec and one dev: span per task, the buckets'
    sum) and the telemetry line (the registry held to
    the path's own counts, the traced pass's samples out of the latency
    histogram) at a tiny size on the CPU-backed device module."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    bail0 = chip_smoke.bailouts()
    with Context(nb_cores=2, device="cpu") as ctx:
        if app == "gemm":
            res = chip_smoke.drive_gemm(
                ctx, 8, 3, 3, 4, passes=1,
                gen=torch.Generator().manual_seed(5), label="rehearsal",
                traced=True)
            ntasks = 36
        else:
            res = chip_smoke.drive_potrf(ctx, 16, 4, torch.float32,
                                         passes=1, label="rehearsal",
                                         traced=True)
            ntasks = 20
        tr = res["trace"]
        tel = chip_smoke.report_telemetry("rehearsal", ctx, bail0,
                                          tr["sampled"])
    assert tr["dev_spans"] == ntasks
    # the buckets exceed the makespan by the critical path's overlap, to
    # their 1e-6 s rounding (the 5% check of the sum is the card's)
    assert abs(sum(tr["buckets_ms"].values()) - tr["makespan_ms"]
               - tr["overlap_ms"]) <= 1e-2
    assert 0.0 < tr["inflight_share"] <= 1.0 + 1e-9
    assert tel["tasks"] == ntasks * 3     # warm, timed, traced
    assert tel["pushes"] == tel["pops"] == tel["tasks"]
    # every task reached Python as a C chain bailout (a device class:
    # non_trivial) or as a probe pop, exactly
    assert set(tel["bailouts"]) <= {"non_trivial"}
    assert sum(tel["bailouts"].values()) + tel["probe_pops"] \
        == tel["tasks"]
    assert tel["latency_count"] == tel["sampled"] - tr["sampled"]


@pytest.mark.parametrize("fronts", [("dtd",), ("ptg", "dtd"),
                                    ("ptg", "jdf")],
                         ids=["dtd", "dtd-ptg", "jdf-ptg"])
def test_front_end_paths_rehearsal_on_cpu(fronts):
    """``drive_gemm`` of the DTD and JDF GEMM paths at a tiny size: every
    front's passes checked (tasks, incarnations), C against the plain
    product and bit for bit between front-ends, the per-front numbers,
    the scheduler line and the telemetry line with bailouts plus probe
    pops equal to the tasks."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    bail0 = chip_smoke.bailouts()
    keep = {}
    with Context(nb_cores=2, device="cpu") as ctx:
        res = chip_smoke.drive_gemm(
            ctx, 16, 3, 3, 4, passes=1,
            gen=torch.Generator().manual_seed(7), label="rehearsal",
            fronts=fronts, seeded=len(fronts) > 1, keep=keep)
        sched = chip_smoke.report_scheduler("rehearsal", ctx, bail0)
        tel = chip_smoke.report_telemetry("rehearsal", ctx, bail0)
    assert res["launches"] == NO_LAUNCHES
    assert set(res["fronts"]) == set(fronts) and len(keep) == 9
    assert tel["tasks"] == 36 * 2 * len(fronts)     # warm + timed
    assert set(sched["bailouts"]) <= {"non_trivial"}
    assert sum(tel["bailouts"].values()) + tel["probe_pops"] \
        == tel["tasks"]
    for f, r in res["fronts"].items():
        assert r["best_s"] > 0 and r["host_us_per_task"] > 0
        assert 0 <= r["submit_cpu_us_per_task"] < float("inf")
        assert r["mean_wave_width"] >= 1.0 and r["window_stalls"] == 0


def test_two_rank_dtd_gemm_rehearsal_on_cpu():
    """The 2-rank DTD GEMM rank function at a tiny size on two CPU ranks:
    C bit-identical to the single-rank DTD run on the same seeded
    operands, the other rank's B tiles pulled once a pass, no DTD pull or
    backlogged frame left."""
    import torch_comm_workers as W
    from parsec_tpu_torch.comm.launch import run_distributed
    from parsec_tpu_torch.core.context import Context
    chip_smoke = _chip_smoke()
    mb, t = 16, 4
    keep = {}
    with Context(nb_cores=2, device="cpu") as ctx:
        chip_smoke.drive_gemm(ctx, mb, t, t, t, passes=1, gen=None,
                              label="rehearsal", fronts=("dtd",),
                              seeded=True, keep=keep)
    res = run_distributed(W.chip_dtd_gemm, 2,
                          args=("port", mb, t, 1, keep), device="cpu",
                          timeout=180)
    assert all(r["tiles"]["bit_identical"] for r in res)
    assert sum(r["tiles"]["count"] for r in res) == t * t
    assert all(r["dtd_lanes"] == {"refs_pending": 0, "backlog": 0}
               for r in res)
    for p in range(2):
        classes = {}
        for r in res:
            for c, v in r["passes"][p]["classes"].items():
                classes[c] = classes.get(c, 0) + v
        assert classes == {"GEMM": t ** 3, "_dtd_recv": t * t}
    # each rank pulled its t*t/2 remote B tiles a pass, by rendezvous
    assert all(r["comm"]["frames_recv"] > 0 for r in res)


def test_report_telemetry_refuses_a_disarmed_plane():
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.utils.mca import params
    params.set("metrics_enabled", 0)
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            with pytest.raises(AssertionError, match="not all armed"):
                chip_smoke.report_telemetry("rehearsal", ctx, {})
    finally:
        params.unset("metrics_enabled")


def test_report_scheduler_holds_the_native_default():
    """A path must run on the native scheduler while sched_native is on;
    its queue counters and bailout histogram are reported."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.bench import empty_pool
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.utils.mca import params
    bail0 = chip_smoke.bailouts()
    with Context(nb_cores=1, device="cpu") as ctx:
        ctx.add_taskpool(empty_pool(16))
        ctx.wait(timeout=30)
        rep = chip_smoke.report_scheduler("rehearsal", ctx, bail0)
    assert rep["name"] == "native" and rep["bailouts"] == {}
    assert rep["queue"]["pops"] == rep["queue"]["pushes"] == 16
    with Context(nb_cores=1, device="cpu", scheduler="lfq") as ctx:
        with pytest.raises(AssertionError, match="not the native"):
            chip_smoke.report_scheduler("rehearsal", ctx, bail0)
    params.set("sched_native", 0)
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            assert chip_smoke.report_scheduler(
                "rehearsal", ctx, bail0)["queue"] is None
    finally:
        params.unset("sched_native")


SERVING_SMALL = {"gemm": (64, 16), "potrf": (64, 16),
                 "stencil": (256, 32, 8), "fuse": 4, "fabric_gemm": (64, 32),
                 "fabric_jobs": 8, "fabric_nt": 4}


def test_serving_phase_rehearsal_on_cpu():
    """The serving path's checks on the CPU-backed device module at a
    small size: every job's result within its limit, the per-job
    retired counts equal to the pools' tasks, jobs_done counted, the
    wire's replies, the fabric's lease, quote and clean audit, and the
    latency fields; CPU tensors launch no kernel."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.phase_serving("cpu", SERVING_SMALL)
    assert res["launches"] == NO_LAUNCHES
    inproc = res["in_process"]
    assert inproc["jobs"] == 10 and inproc["jobs_done_total"] == 10
    assert all(r == t for _j, _a, r, t in inproc["retired_vs_tasks"])
    assert sorted(len(w) for w in inproc["wall_s"].values()) == [2, 4, 4]
    assert 0 < inproc["p50_s"] <= inproc["p99_s"] <= inproc["seconds"]
    assert inproc["jobs_per_s"] > 0
    assert res["wire"]["jobs"] == 3
    fab = res["fabric"]
    assert fab["audit"] == "clean" and fab["quote_eta_s"] is not None
    assert 0 < fab["p50_s"] <= fab["p99_s"] and fab["jobs_per_s"] > 0


@pytest.mark.parametrize("app,params", [
    ("gemm", {"n": 64, "nb": 16}), ("gemm", {"n": 8192, "nb": 2048}),
    ("potrf", {"n": 64, "nb": 16}), ("potrf", {"n": 8192, "nb": 2048}),
    ("stencil", {"n": 256, "nb": 32, "steps": 8}),
    ("stencil", {"n": 1 << 23, "nb": 1 << 20, "steps": 64, "fuse": 16})])
def test_serving_task_counts_match_the_pools(app, params):
    """The per-job task counts the serving path holds the gauges to
    agree with the pools' own enumeration (liveattr.class_totals), at
    the card sizes too."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.apps.gemm import gemm_taskpool
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    from parsec_tpu_torch.apps.stencil import stencil_taskpool
    from parsec_tpu_torch.data.matrix import (TwoDimBlockCyclic,
                                              VectorTwoDimCyclic)
    from parsec_tpu_torch.prof.liveattr import class_totals
    n, nb = params["n"], params["nb"]
    if app == "stencil":
        tp = stencil_taskpool(VectorTwoDimCyclic(mb=nb, lm=n),
                              params["steps"], fuse=params.get("fuse", 1))
    else:
        mats = [TwoDimBlockCyclic(mb=nb, nb=nb, lm=n, ln=n)
                for _ in range(3)]
        tp = gemm_taskpool(*mats, beta=0.0) if app == "gemm" else \
            potrf_taskpool(mats[0])
    assert sum(class_totals(tp).values()) == \
        chip_smoke.serving_tasks(app, params)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_path_rehearsal_on_cpu(causal):
    """The ring-attention path's driver at a tiny size: every pass's
    tasks and visit classes, no kernel of csrc/ launched, the output
    within the JAX test's tolerance of the float64 dense reference."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    P, T, d = 4, 16, 8
    with Context(nb_cores=2, device="cpu") as ctx:
        res = chip_smoke.drive_ring_attention(
            ctx, P, T, d, causal, passes=1,
            gen=torch.Generator().manual_seed(5), label="rehearsal")
    assert res["launches"] == NO_LAUNCHES
    assert res["visits"] == ({2: 6, 1: 4, 0: 6} if causal else {None: 16})
    assert res["max_abs_err"] <= chip_smoke.ATTN_ATOL + \
        chip_smoke.ATTN_RTOL * 10
    assert res["device"]["faults"] == 0


def test_recursive_potrf_path_rehearsal_on_cpu():
    """The recursive potrf's driver at a tiny size: the inner pool's 20
    tasks on the device module a pass, FACT and CHECK on the CPU, the
    float64 residual, and CHECK's reading equal to the committed
    factor."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=2, device="cpu") as ctx:
        res = chip_smoke.drive_recursive_potrf(
            ctx, 64, 16, passes=1, gen=torch.Generator().manual_seed(2),
            label="rehearsal")
    assert res["launches"] == NO_LAUNCHES
    assert res["residual"] <= chip_smoke.RECURSIVE_POTRF_TOL
    assert res["cpu_tasks"] == 4 and len(res["times"]) == 1


def test_wave_path_rehearsal_on_cpu():
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=2, device="cpu") as ctx:
        res = chip_smoke.drive_wave(ctx, 8, 4, passes=2, label="rehearsal")
    assert res["launches"] == NO_LAUNCHES
    assert res["cpu_tasks"] == 3 and len(res["times"]) == 2
    assert res["device"]["faults"] == 0


def test_two_rank_pingpong_rehearsal_on_cpu():
    """The 2-rank pingpong rank function on two CPU ranks: both legs
    move their payload hop by hop (eager for the pinned bandwidth leg),
    and the report holds every leg to its activations."""
    import torch_comm_workers as W
    from parsec_tpu_torch.comm.launch import run_distributed
    chip_smoke = _chip_smoke()
    res = run_distributed(W.chip_pingpong, 2,
                          args=("port", (8, 40), (1 << 16, 8)),
                          device="cpu", timeout=180)
    out = chip_smoke.report_pingpong(res)
    assert out["launches"] == NO_LAUNCHES
    assert out["rtt"]["hops"] == 40 and out["bw"]["bytes"] == 1 << 16
    for r in res:
        assert r["pingpong"]["bw"]["comm"]["act_rdv"] == 0
        assert r["pingpong"]["rtt"]["s_per_hop"] > 0


def test_checkpoint_grapher_path_rehearsal_on_cpu():
    """The checkpoint + grapher path at a tiny size: the DOT holds the
    pass's t^3 task nodes and t^2 (t - 1) edges, and C restores into a
    fresh collection bit for bit."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=2, device="cpu") as ctx:
        res = chip_smoke.drive_checkpoint_grapher(ctx, 16, 4, "rehearsal")
    assert res["launches"] == NO_LAUNCHES
    assert (res["dot_nodes"], res["dot_edges"]) == (64, 48)
    assert res["bit_identical"] and res["checkpoint_bytes"] > 16 * 16 * 16 * 4


def test_fault_tolerance_path_rehearsal_on_cpu():
    """The fault-tolerance path on two CPU ranks at a tiny size (its pass
    stretched by frame delays; rank 1 kills itself after its share of the
    pool's tasks given by kill_at, so the kill lands inside the pass
    however loaded the host is): rank 1 dies,
    rank 0 recovers and completes, its factor holds the card's limits
    against the single-rank run's, and the flight-recorder bundle holds
    rank 0's recovery-start incident."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    refs = {}
    with Context(nb_cores=2, device="cpu") as ctx:
        chip_smoke.drive_potrf(ctx, 32, 4, torch.bfloat16, passes=1,
                               label="rehearsal", keep=refs)
    sys.path.insert(0, str(ROOT))   # the spawned ranks import chip_smoke
    try:
        out = chip_smoke.phase_recovery(
            refs, nofault_s=2.0, size=(32, 4), setup_s=3.0, kill_at=0.4,
            extra_plan="delay_frame=tag:ACT,p=1,ms=300", device="cpu")
    finally:
        sys.path.remove(str(ROOT))
    assert out["recovery"]["started"] == 1
    assert out["recovery"]["failed"] == 0
    assert out["recovery"]["restored_tiles"]["init"] > 0
    assert out["worst_rel_fro"] <= chip_smoke.POTRF_DIST_TOL
    assert out["backward_error"] <= chip_smoke.POTRF_BWD_TOL
    assert out["launches"] == NO_LAUNCHES


def test_rejoin_and_dtd_recovery_legs_rehearsal_on_cpu():
    """The rejoin and DTD-recovery legs on two CPU ranks over shm at a
    tiny size (rank 1's restarted incarnation stalls each dispatch and
    kills itself after its share of the DTD pool's tasks given by
    kill_at, so the kill lands inside the pass however loaded the host
    is): rank 1 rejoins, both GEMM passes and
    the service's degraded -> healthy check hold, then rank 1 dies in the
    DTD GEMM and rank 0 recovers it with C checked."""
    chip_smoke = _chip_smoke()
    sys.path.insert(0, str(ROOT))   # the spawned ranks import chip_smoke
    try:
        out = chip_smoke.phase_rejoin_dtd(
            dtd_nofault_s=2.0, size=(32, 4), setup_s=5.0, kill_at=0.4,
            extra_plan="delay_dispatch=ms=100", device="cpu")
    finally:
        sys.path.remove(str(ROOT))
    assert out["rejoin"]["up_to_ack_s"] < chip_smoke.FT_REJOIN_TIMEOUT_S
    assert tuple(out["rejoin"]["service"][-1]) == ("healthy", "rejoin")
    assert out["dtd"]["worst_rel"] <= chip_smoke.GEMM_DIST_TOL
    assert out["dtd"]["bit_identical"] is True
    assert out["dtd"]["recovery"]["tasks_reexecuted"] > 0
    assert out["launches"] == NO_LAUNCHES


def test_multi_module_phase_rehearsal_on_cpu():
    """The several-modules phase on ``cpu:8`` at a tiny size: every path
    (GEMM with panel broadcasts, potrf, geqrf, the permute wave, the zig
    chain, ring attention, the SPMD trio) runs its checks, each fires the
    ICI engine where it must, and each reports its IciStats and eight
    module ledger peaks."""
    chip_smoke = _chip_smoke()
    out = chip_smoke.phase_multi_module(
        device="cpu:8", gen=torch.Generator().manual_seed(5),
        sizes={"gemm": (32, 4), "potrf": (32, 4), "qr": (32, 3),
               "wave": (8, 16), "zig": 16, "attn": (8, 16, 8),
               "spmd": 64, "halo": 1 << 10})
    assert len(out) == 7
    for path, res in out.items():
        assert res["launches"] == NO_LAUNCHES, path
        assert len(res["module_peak_gib"]) == 8, path
    assert out["GEMM, cpu:8"]["ici"]["bcasts"] > 0
    zig = out["zig chain, cpu:8"]["ici"]
    assert zig["puts"] + zig["permute_edges"] > 0
    assert out["SPMD trio, cpu:8"]["spmd"]["summa"]["excess"] <= 0


@pytest.mark.parametrize("app", ["gemm", "potrf"])
def test_trace_tools_checks_on_a_cpu_trace(app, tmp_path):
    """The tools phase's trace checks on a traced pass kept in a
    directory (``trace_dir``) on the CPU-backed module: ``trace_info``'s
    per-class counts add up to the pass's tasks (exec and dev: spans),
    ``trace2chrome``'s X events are the trace's intervals; a count that
    is not the pass's fails the check."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=2, device="cpu") as ctx:
        if app == "gemm":
            res = chip_smoke.drive_gemm(
                ctx, 8, 3, 3, 4, passes=1,
                gen=torch.Generator().manual_seed(5), label="rehearsal",
                traced=True, trace_dir=str(tmp_path))
        else:
            res = chip_smoke.drive_potrf(ctx, 16, 4, torch.float32,
                                         passes=1, label="rehearsal",
                                         traced=True, trace_dir=str(tmp_path))
    tr = res["trace"]
    assert tr["ptt"] == str(tmp_path / "rehearsal.ptt")
    out = chip_smoke.check_trace_tools(tr["ptt"], tr["ntasks"], app,
                                       str(tmp_path))
    assert out["exec_spans"] == out["dev_spans"] == tr["ntasks"] == \
        {"gemm": 36, "potrf": 20}[app]
    assert out["x_events"] >= 2 * tr["ntasks"]     # exec, dev: and waits
    with pytest.raises(AssertionError, match="exec and"):
        chip_smoke.check_trace_tools(tr["ptt"], tr["ntasks"] + 1, app,
                                     str(tmp_path))


def test_trace_counts_read_the_per_class_table():
    text = ("total events: 9\nper-class interval stats (seconds):\n"
            "                 count         sum\nname\n"
            "GEMM                 4    0.1 0.1 0.1 0.1\n"
            "dev:GEMM             4    0.1 0.1 0.1 0.1\n"
            "queue_wait           5    0.1 0.1 0.1 0.1\n"
            "per-class queue-wait (seconds, ready -> selected):\n"
            "GEMM                 4    0.1 0.1 0.1 0.1\n")
    assert _chip_smoke().trace_info_counts(text) == {
        "GEMM": 4, "dev:GEMM": 4, "queue_wait": 5}


def test_merge_check_on_two_cpu_rank_traces(tmp_path):
    """``trace2chrome --merge`` of a 2-rank potrf's traces: arrows, both
    ends of each, ranks 0 and 1, the merged intervals as X events."""
    import torch_comm_workers as W
    paths = W.run_port(W.traced_potrf, 2, args=(str(tmp_path),),
                       timeout=240)
    out = _chip_smoke().check_merge(paths, "rehearsal", str(tmp_path))
    assert out["flow_arrows"] > 0


def test_chaos_command_and_run_on_cpu():
    """The chaos tool's command line carries ``--device`` and runs each
    case once; one case on two CPU ranks through ``run_chaos``, and an
    unknown case fails the run."""
    chip_smoke = _chip_smoke()
    assert chip_smoke.chaos_command("cuda") == [
        "--device", "cuda", "--only", "kill-close-recover", "--seeds", "1"]
    assert chip_smoke.chaos_command("cpu", ("delay-frames", "kill-close")) \
        == ["--device", "cpu", "--only", "delay-frames,kill-close",
            "--seeds", "2"]
    out = chip_smoke.run_chaos("cpu", ("delay-frames",))
    assert out["cases"]["delay-frames"]["got"] == "complete"
    with pytest.raises(AssertionError, match="unknown catalog entries"):
        chip_smoke.run_chaos("cpu", ("delay-frames", "no-such-case"))


def test_lint_step_on_cpu():
    """The tools phase's lint step: the port's parseclint over the
    package in a process of its own, clean, with its one baselined
    divergence; the status line's counts parse in both of its forms."""
    chip_smoke = _chip_smoke()
    out = chip_smoke.run_lint()
    assert out["new"] == 0 and out["baselined"] == 1
    assert out["files"] > 100 and out["seconds"] > 0
    m = chip_smoke.LINT_STATUS.search(
        "x\nparseclint: 2 finding(s), 1 baselined (106 files)\n")
    assert (m[1], m[2], m[3]) == ("2", "1", "106")
    m = chip_smoke.LINT_STATUS.search("parseclint: clean (3 files)")
    assert (m[1], m[2], m[3]) == (None, None, "3")


def test_serving_clients_rehearsal_on_cpu():
    """The client tools against a JobServer over a CPU JobService: one
    GEMM job through ``job_client submit --wait``, its result within its
    limit, one more job done in ``metrics_client``'s scrape, the job in
    ``--status`` and in ``live_view``'s table."""
    chip_smoke = _chip_smoke()
    from parsec_tpu_torch.service import JobService
    with JobService(device="cpu", nb_cores=2) as svc:
        out = chip_smoke.serving_clients(svc, "cpu", (64, 16), "rehearsal")
    assert out["jobs_done"] == 1 and out["k1_fma"] == 0
    assert out["rel_err"] <= chip_smoke.GEMM_JOB_TOL
    assert set(out["seconds"]) == {"metrics_client", "job_client",
                                   "metrics_client --status", "live_view"}


def _bench_default_line(**over):
    line = {"metric": "tiled_gemm_gflops", "value": 828745.2,
            "unit": "GFLOP/s", "vs_baseline": 1.5236,
            "tiled_potrf_mp_gflops": 181802.3,
            "potrf_rep_band_gflops": [179305.7, 182275.8],
            "potrf_best_gflops": 182275.8,
            "potrf_protocol": "median-of-5",
            "potrf_backward_error": 2.9705e-3,
            "potrf_ir_residuals": [2.962e-3, 8.774e-6, 5.878e-8, 2.935e-8],
            "potrf_storage": "bfloat16", "potrf_fuse_panel": True,
            "potrf_vs_baseline": 0.3342, "backend": "cuda",
            "card_name": "NVIDIA H100 80GB HBM3",
            "card_power_limit": "700.00 W", "host_cpu": "test host"}
    line.update(over)
    return line


def _bench_geqrf_line(**over):
    line = {"metric": "tiled_geqrf_mp_gflops", "value": 85824.9,
            "unit": "GFLOP/s", "vs_baseline": 0.1578,
            "factorization_residual": 8.926e-3,
            "ls_refine_errors": [1.319e-2, 3.911e-4, 1.632e-5, 8.151e-7,
                                 1.305e-7],
            "backend": "cuda", "card_name": "NVIDIA H100 80GB HBM3",
            "card_power_limit": "700.00 W", "host_cpu": "test host"}
    line.update(over)
    return line


def test_parse_bench_reads_the_last_line_and_the_launches():
    import json
    chip_smoke = _chip_smoke()
    line = _bench_default_line()
    launches = {"gemm_tile": 1253, "gemm_tile_grouped": 694,
                "gram_tile": 0}
    stdout = "noise\n" + json.dumps(line) + "\n"
    stderr = ("rep 0: 163.9 ms\nbench kernel launches "
              + json.dumps(launches) + "\nscheduler stats: ...\n")
    assert chip_smoke.parse_bench(stdout, stderr) == (line, launches)
    with pytest.raises(AssertionError, match="launch"):
        chip_smoke.parse_bench(stdout, "rep 0: 163.9 ms\n")
    with pytest.raises(AssertionError, match="standard output"):
        chip_smoke.parse_bench("", stderr)


@pytest.mark.parametrize("line, fault", [
    (_bench_default_line(), None),
    (_bench_geqrf_line(), None),
    (_bench_default_line(potrf_backward_error=6e-2), "backward error"),
    (_bench_default_line(potrf_ir_residuals=[3e-3, 2e-5]), "IR"),
    (_bench_default_line(potrf_error="RuntimeError('x')"), "potrf leg"),
    (_bench_default_line(potrf_protocol="median-of-3"), "protocol"),
    (_bench_default_line(value=float("nan")), "value"),
    (_bench_default_line(backend="cpu"), "identity"),
    (_bench_geqrf_line(factorization_residual=4e-2), "residual"),
    (_bench_geqrf_line(ls_refine_errors=[1e-2, 1e-6, 2e-5]), "ladder"),
    ({k: v for k, v in _bench_geqrf_line().items() if k != "host_cpu"},
     "identity"),
], ids=["default", "geqrf", "bwd", "ir", "potrf_error", "protocol",
        "value", "backend", "residual", "ladder", "identity"])
def test_bench_lines_are_held_to_the_path_limits(line, fault):
    """The bench phase's limits: the potrf legs' backward error <= 5e-2
    and last IR residual <= 1e-5, the geqrf residual <= 3e-2 and last
    ladder error <= 1e-5, the north-star leg present, the identity keys
    of the card."""
    chip_smoke = _chip_smoke()
    if fault is None:
        chip_smoke.check_bench_line("t", line, "cuda")
    else:
        with pytest.raises(AssertionError, match=fault):
            chip_smoke.check_bench_line("t", line, "cuda")

