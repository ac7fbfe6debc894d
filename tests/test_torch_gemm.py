"""The whole slice: the port's tiled GEMM against the JAX package's.

The same seeded operands go through ``from_reference_arrays`` into the
port's collections and straight into the JAX package's; the JAX side runs
``gemm_taskpool`` on its CPU XLA devices with ``--mca gemm_pallas 1`` (the
blocked Pallas kernel in interpret mode), the port runs it on its
CPU-backed device module (the kernel's plain version).  n = 256 with
128-tiles, alpha/beta in {(1, 1), (2, 0.5)}, panel broadcast on and off,
A and B in f32 and in bf16, C in f32.  Both packages run on one device
(``device_max`` 1 on the JAX side), either at their device modules'
defaults (wave fusion, chain fusion, buffer donation) or at one launch per
task (``JAX_ONE_LAUNCH_PER_TASK`` and ``PORT_ONE_LAUNCH_PER_TASK``).

Tolerance, as max|port - jax| / max(1, max|jax|): 1e-5 with f32 panels
and 1e-3 with bf16 panels (bf16 products are exact in f32, so in both
cases only the order of the f32 summation differs; the bf16 bound is the
tests/test_pallas.py one).  The GEMM task counts must agree too: every
GEMM task (and SCALE task, when beta != 1) runs on the device; at the
defaults the port writes every GEMM's C tile in place (donation: nothing
else reads a C tile, so the DAG decides it), at one launch per task neither
package fuses and the port donates nothing.  Whether a GEMM wave forms at
the defaults depends on timing alone (no GEMM class is chain-held), so it
is not asserted here: ``tests/test_torch_fusion.py`` forces a queue to
build and asserts it there.

A second case runs the port under a 1 MiB device copy-cache budget
(``device_mem_mb``, two launches in flight) at n = 512, about three times
the budget in tiles (at its defaults, donating its C tiles), so its device
module evicts least-recently-used tiles and writes authoritative ones back
to the host in the middle of the run.  The JAX package gives the reference
values at one launch per task without a budget: under that budget on a
loaded host its own run can find every resident tile pinned for the 30 s
it waits, and fail.
"""

import collections
import threading

import ml_dtypes
import numpy as np
import pytest

from parsec_tpu.apps import gemm as jax_gemm
from parsec_tpu.core.context import Context as JaxContext
from parsec_tpu.data.matrix import TwoDimBlockCyclic as JaxMatrix
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.apps import cuda_kernels
from parsec_tpu_torch.apps.gemm import gemm_taskpool
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.carry import (Layout, from_reference_arrays,
                                         to_reference_arrays)
from parsec_tpu_torch.utils.mca import params as port_params

N, MB = 256, 128
TOL = {"f32": 1e-5, "bf16": 1e-3}
#: launches in flight under a memory budget: each pins its three tiles, so
#: a small window leaves unpinned tiles to evict
INFLIGHT_UNDER_BUDGET = 2
JAX_ONE_LAUNCH_PER_TASK = (("device_fuse", 1), ("device_fuse_panel", 0),
                           ("device_dispatchers", 1))
#: the port's A/B line: PARSEC_MCA_DEVICE_FUSE=1 PARSEC_MCA_DEVICE_FUSE_PANEL=0
#: PARSEC_MCA_DEVICE_DONATE=0
PORT_ONE_LAUNCH_PER_TASK = (("device_fuse", 1), ("device_fuse_panel", 0),
                            ("device_donate", 0))
#: (JAX knobs, port knobs) of each device-module setting.  At its defaults
#: the JAX package compiles a fused width in the background and launches
#: singles until it is ready, which on a loaded host can outlast this
#: small DAG: its fused widths compile on first use here instead
#: (``device_fuse_bg`` 0), so a wave that forms runs fused
SETTINGS = {"defaults": ((("device_fuse_bg", 0),), ()),
            "one_launch_per_task": (JAX_ONE_LAUNCH_PER_TASK,
                                    PORT_ONE_LAUNCH_PER_TASK)}


def _fusions(stats) -> int:
    """Launches that fused a wave or ran a held chain."""
    return sum(s.fused_launches + s.chained_launches for s in stats)


def _operands(kind, seed, n=N):
    rng = np.random.default_rng(seed)
    a, b, c = (rng.standard_normal((n, n)).astype(np.float32)
               for _ in range(3))
    if kind == "bf16":
        a, b = a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return {"A": a, "B": b, "C": c}


def _counter(ctx):
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1
    ctx.pins_register("complete_exec", count)
    return done


def _run_jax(arrays, alpha, beta, panel_bcast, knobs=JAX_ONE_LAUNCH_PER_TASK):
    n = arrays["C"].shape[0]
    mats = {k: JaxMatrix(MB, MB, n, n, dtype=v.dtype, name=k).from_array(
        v.copy()) for k, v in arrays.items()}
    jax_params.set("gemm_pallas", 1)
    # one device, as the port's CPU-backed module is one: the waves queue
    # there and can fuse
    jax_params.set("device_max", 1)
    for knob, value in knobs:
        jax_params.set(knob, value)
    jax_gemm._kernels.clear()
    try:
        with JaxContext(nb_cores=2) as ctx:
            done = _counter(ctx)
            ctx.add_taskpool(jax_gemm.gemm_taskpool(
                mats["A"], mats["B"], mats["C"], alpha=alpha, beta=beta,
                device="tpu", panel_bcast=panel_bcast))
            ctx.wait(timeout=300)
            stats = [d.stats for d in ctx.device_registry.accelerators]
        assert any(isinstance(k, tuple) and k and k[0] == "pallas"
                   for k in jax_gemm._kernels)
    finally:
        jax_params.unset("gemm_pallas")
        jax_params.unset("device_max")
        for knob, _ in knobs:
            jax_params.unset(knob)
        jax_gemm._kernels.clear()
    return np.asarray(mats["C"].to_array(), np.float32), dict(done), stats


def _run_port(arrays, kind, alpha, beta, panel_bcast, mem_mb=0, knobs=()):
    panel = "bfloat16" if kind == "bf16" else "float32"
    mats = from_reference_arrays(arrays, {"A": Layout(MB, MB, panel),
                                          "B": Layout(MB, MB, panel),
                                          "C": Layout(MB, MB, "float32")})
    cuda_kernels.gemm_tile_launches.reset()
    cuda_kernels.gemm_tile_grouped_launches.reset()
    if mem_mb:
        port_params.set("device_mem_mb", mem_mb)
        port_params.set("device_inflight_depth", INFLIGHT_UNDER_BUDGET)
    for knob, value in knobs:
        port_params.set(knob, value)
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            done = _counter(ctx)
            ctx.add_taskpool(gemm_taskpool(mats["A"], mats["B"], mats["C"],
                                           alpha=alpha, beta=beta,
                                           panel_bcast=panel_bcast))
            ctx.wait(timeout=300)
            stats = [d.stats for d in ctx.device_registry.accelerators]
    finally:
        port_params.unset("device_mem_mb")
        port_params.unset("device_inflight_depth")
        for knob, _ in knobs:
            port_params.unset(knob)
    # CPU tensors: the plain versions ran, no kernel was ever launched
    assert cuda_kernels.gemm_tile_launches.value == 0
    assert cuda_kernels.gemm_tile_grouped_launches.value == 0
    return to_reference_arrays(mats)["C"], dict(done), stats


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("panel_bcast", [False, True],
                         ids=["direct", "panel_bcast"])
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (2.0, 0.5)])
def test_port_gemm_matches_jax_gemm(kind, panel_bcast, alpha, beta,
                                    setting):
    jax_knobs, port_knobs = SETTINGS[setting]
    arrays = _operands(kind, seed=21)
    ref, ref_done, ref_stats = _run_jax(arrays, alpha, beta, panel_bcast,
                                        knobs=jax_knobs)
    got, got_done, stats = _run_port(arrays, kind, alpha, beta, panel_bcast,
                                     knobs=port_knobs)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err < TOL[kind], err
    kt = N // MB
    assert got_done == ref_done
    assert got_done["GEMM"] == (N // MB) ** 2 * kt
    device_tasks = got_done["GEMM"] + got_done.get("SCALE", 0)
    assert sum(s.executed_tasks for s in stats) == \
        sum(s.executed_tasks for s in ref_stats) == device_tasks
    if setting == "defaults":
        assert sum(s.donated_tasks for s in stats) == got_done["GEMM"]
    else:
        assert _fusions(stats) == _fusions(ref_stats) == 0
        assert sum(s.donated_tasks for s in stats) == 0


@pytest.mark.parametrize("kind,panel_bcast", [("f32", False),
                                              ("bf16", True)],
                         ids=["f32-direct", "bf16-panel_bcast"])
def test_port_gemm_under_memory_budget_matches_jax_gemm(kind, panel_bcast):
    n, mem_mb = 512, 1          # 48 tiles of 32-64 KiB against 1 MiB
    arrays = _operands(kind, seed=23, n=n)
    ref, ref_done, ref_stats = _run_jax(arrays, 2.0, 0.5, panel_bcast)
    got, got_done, stats = _run_port(arrays, kind, 2.0, 0.5, panel_bcast,
                                     mem_mb=mem_mb)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err < TOL[kind], err
    assert got_done == ref_done
    assert got_done["GEMM"] == (n // MB) ** 3
    assert sum(s.executed_tasks for s in stats) == \
        sum(s.executed_tasks for s in ref_stats) == \
        got_done["GEMM"] + got_done["SCALE"]
    # the budget was binding: tiles were evicted mid-run, and C tiles
    # written on the device went home through the writeback path
    assert sum(s.evictions for s in stats) > 0
    assert sum(s.bytes_out for s in stats) > 0


def test_carry_round_trip_is_exact_for_bf16():
    arrays = _operands("bf16", seed=22)
    mats = from_reference_arrays(arrays, Layout(MB, MB, "bfloat16"))
    back = to_reference_arrays(mats)
    for name, arr in arrays.items():
        want = np.asarray(arr, np.float32).astype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(back[name],
                                      want.astype(np.float32))
    # the carry copies: the caller's array is never aliased
    mats["C"].to_array()[0, 0] = 1e9
    assert arrays["C"][0, 0] != 1e9
