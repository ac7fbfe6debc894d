"""The potrf slice: the port's tiled Cholesky and its numerics checks
against the JAX package's.

The same seeded inputs (numpy) go through both packages.  The JAX side
runs its task bodies and ``potrf_taskpool(device="tpu")`` on its CPU XLA
devices (plain ``jnp`` bodies: the reference has no Pallas kernel on this
path); the port runs its bodies on CPU tensors (``gemm_tile``'s plain
version for SYRK and GEMM) and its taskpool on the CPU-backed device
module.  The whole slice runs both packages at their device modules'
defaults (wave fusion, POTRF -> TRSM chain fusion, donation) and at one
launch per task (``SETTINGS``).

Tolerances, as max|port - jax| / max(1, max|jax|):
  * f32 tiles: 1e-5 for a body and for the factor after the whole slice
    (both packages run true f32 arithmetic, in another order);
  * bf16 tiles, one body: 1e-2 — a sum that lands next to a bf16 rounding
    boundary rounds one bf16 ulp apart (2^-8 to 2^-7 relative);
  * bf16 tiles, the factor after the slice: 1e-2 per tile (a rounding
    flip, one bf16 ulp, may enter the trailing matrix; measured 0: the two
    factors are bit-identical at these sizes), and LL^T against A within
    the JAX package's own 3e-2
    (tests/test_apps_drivers.py::test_potrf_bf16_panels_mixed_precision).
The numerics checks on one carried factor agree: the backward error to
1e-5 relative where it measures a bf16 factor (measured 1.3e-6; f32
factors leave it at the check's own rounding, ~5e-8, where two summation
orders differ by 1%: both must then stay under 1e-6), and the refinement
history to 1e-2 relative per step (measured up to 8e-4), or both under the
f32 floor of 1e-6.
"""

import collections
import pathlib
import sys
import threading
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.apps import potrf as jax_potrf
from parsec_tpu.apps import potrf_check as jax_check
from parsec_tpu.core.context import Context as JaxContext
from parsec_tpu.data.matrix import TwoDimBlockCyclic as JaxMatrix
from parsec_tpu_torch.apps import cuda_kernels, potrf
from parsec_tpu_torch.apps.potrf_check import backward_error, refine_solve
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.carry import (Layout, from_reference_arrays,
                                         to_reference_arrays)
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.utils.mca import params as port_params
from parsec_tpu.utils.mca import params as jax_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: (JAX knobs, port knobs) of each device-module setting: the defaults, and
#: one launch per task (the port's A/B line PARSEC_MCA_DEVICE_FUSE=1
#: PARSEC_MCA_DEVICE_FUSE_PANEL=0 PARSEC_MCA_DEVICE_DONATE=0)
SETTINGS = {"defaults": ((), ()),
            "one_launch_per_task": (
                (("device_fuse", 1), ("device_fuse_panel", 0),
                 ("device_dispatchers", 1)),
                (("device_fuse", 1), ("device_fuse_panel", 0),
                 ("device_donate", 0)))}


def _fusions(stats) -> int:
    """Launches that fused a wave or ran a held chain."""
    return sum(s.fused_launches + s.chained_launches for s in stats)


def _chains(stats) -> int:
    return sum(s.chained_launches for s in stats)

TOL_BODY = {"f32": 1e-5, "bf16": 1e-2}
TOL_TILE = {"f32": 1e-5, "bf16": 1e-2}
STORAGE = {"f32": (np.float32, "float32"),
           "bf16": (ml_dtypes.bfloat16, "bfloat16")}


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _spd(n, seed):
    B = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    return (B @ B.T + n * np.eye(n)).astype(np.float32)


def _bench_operand(mb, nt):
    """The JAX bench's potrf operand (bench.py::_tile_generator staged by
    run_potrf_bench) at a small size, from bench.py's own generator: its
    diagonal tiles are not symmetric."""
    sys.path.insert(0, str(ROOT))
    try:
        import bench
    finally:
        sys.path.remove(str(ROOT))
    n = mb * nt
    gen = bench._tile_generator(types.SimpleNamespace(mb=mb, nb=mb,
                                                      dtype=np.float32))
    a = np.zeros((n, n), np.float32)
    for i, (m, k) in enumerate((m, k) for m in range(nt) for k in range(nt)):
        a[m * mb:(m + 1) * mb, k * mb:(k + 1) * mb] = np.asarray(
            gen(float(i), float(n) if m == k else 0.0))
    return a


def _store(x, kind):
    """f32 numpy -> the storage type, as numpy (JAX) and as a tensor."""
    if kind == "bf16":
        xb = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
        return xb, torch.from_numpy(xb.astype(np.float32)).bfloat16()
    x = np.asarray(x, np.float32)
    return x, torch.from_numpy(x.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- task bodies --------------------------------------------------------------

def _tiles(mb, symmetric_diag):
    """A diagonal tile T (SPD, or SPD plus an upper-triangle perturbation
    that leaves it non-symmetric, as the bench operand's are), a panel
    tile C, and the rest of a trailing update."""
    rng = np.random.default_rng(21)
    T = _spd(mb, 22)
    if not symmetric_diag:
        T = T + np.triu(rng.standard_normal((mb, mb)), 1).astype(np.float32)
    C, R, L = (rng.standard_normal((mb, mb)).astype(np.float32)
               for _ in range(3))
    return T, C, R, L


def _inputs(name, kind, T, C, R, L):
    """A body's arguments as (numpy for JAX, tensor for the port): tiles in
    the storage type, the f32 arena W (POTRF's fresh one, or the inverse
    of a Cholesky factor for TRSM) in f32."""
    mb = T.shape[0]
    zero_w = np.zeros((mb, mb), np.float32)
    W = np.linalg.inv(np.linalg.cholesky(_spd(mb, 23))).astype(np.float32)
    tiles, arena = {"POTRF": ((T,), (zero_w,)), "POTRFL": ((T,), ()),
                    "TRSM": ((), (W,)), "SYRK": ((T, R), ()),
                    "GEMM": ((C, L, R), ())}[name]
    f32 = [(x, torch.from_numpy(x.copy())) for x in arena]
    ins = [_store(x, kind) for x in tiles]
    if name == "TRSM":
        return f32 + [_store(C, kind)]
    return ins + f32


BODIES = ["POTRF", "POTRF-nonsymmetric", "POTRFL", "POTRFL-nonsymmetric",
          "TRSM", "SYRK", "GEMM"]


def _jax_body(name, ins):
    fn = {"POTRF": jax_potrf._k_potrf, "POTRFL": jax_potrf._k_potrf_last,
          "TRSM": jax_potrf._k_trsm, "SYRK": jax_potrf._k_syrk,
          "GEMM": jax_potrf._k_gemm}[name](None)
    out = fn(*(jnp.asarray(x) for x in ins))
    return out if isinstance(out, dict) else {"out": out}


def _port_body(name, ins, check):
    fn = {"POTRF": potrf._mk_potrf(check),
          "POTRFL": potrf._mk_potrf_last(check), "TRSM": potrf._k_trsm,
          "SYRK": potrf._k_syrk, "GEMM": potrf._k_gemm}[name]
    out = fn(*ins)
    return out if isinstance(out, dict) else {"out": out}


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("body", BODIES)
def test_device_body_matches_jax(body, kind):
    """Each device body against the JAX package's, on the same tiles.  The
    non-symmetric diagonal tile holds the port's POTRF to the reference's
    symmetrizing ``jnp.linalg.cholesky``; W stays f32 in both."""
    name = body.split("-")[0]
    mb = 64
    T, C, R, L = _tiles(mb, symmetric_diag=not body.endswith("nonsymmetric"))
    stored = _inputs(name, kind, T, C, R, L)
    ref = _jax_body(name, [j for j, _ in stored])
    check = potrf.CholeskyCheck()
    cuda_kernels.gemm_tile_launches.reset()
    got = _port_body(name, [t for _, t in stored], check)
    assert cuda_kernels.gemm_tile_launches.value == 0    # CPU: plain version
    assert not check.failed()
    assert set(got) == set(ref)
    # the written tile keeps its storage type (TRSM writes C, the others
    # their first argument); the arena W is f32
    tile = stored[1 if name == "TRSM" else 0][1]
    for k in ref:
        assert got[k].dtype == (torch.float32 if k == "W" else tile.dtype)
        assert _rel(_f32(got[k]), _f32(ref[k])) < TOL_BODY[kind], k


def test_nonsymmetric_diagonal_tile_separates_device_and_cpu_potrf():
    """On a diagonal tile that is not symmetric, the device POTRF (like
    ``jnp.linalg.cholesky``) factors (T + T^T)/2, the CPU POTRF (like
    ``np.linalg.cholesky``) the lower triangle mirrored: both are right for
    their own reference, and they differ."""
    T, *_ = _tiles(32, symmetric_diag=False)
    w = torch.zeros(32, 32)
    dev = potrf._mk_potrf(potrf.CholeskyCheck())(torch.from_numpy(T), w)
    cpu = potrf._cpu_potrf(torch.from_numpy(T), w)
    assert _rel(_f32(cpu["T"]), np.linalg.cholesky(T)) < 1e-5
    sym = (T + T.T) / 2
    assert _rel(_f32(dev["T"]), np.linalg.cholesky(sym)) < 1e-5
    assert _rel(_f32(dev["T"]), _f32(cpu["T"])) > 1e-3


def _jax_cpu_body(name):
    """The JAX package's own CPU body of a task class (numpy and scipy),
    from a pool built with device="cpu"."""
    tp = jax_potrf.potrf_taskpool(JaxMatrix(8, 8, 16, 16), device="cpu")
    (_dev, hook), = tp.task_classes[name].incarnations
    return hook.__ptg_fn__


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["POTRF", "POTRFL", "TRSM", "SYRK",
                                  "GEMM"])
def test_cpu_body_matches_the_reference_cpu_body(name, kind):
    T, C, R, L = _tiles(48, symmetric_diag=False)   # both read the lower
    stored = _inputs(name, kind, T, C, R, L)
    ref = _jax_cpu_body(name)(*[j for j, _ in stored])
    got = {"POTRF": potrf._cpu_potrf, "POTRFL": potrf._cpu_potrf_last,
           "TRSM": potrf._cpu_trsm, "SYRK": potrf._cpu_syrk,
           "GEMM": potrf._cpu_gemm}[name](*[t for _, t in stored])
    if not isinstance(ref, dict):
        ref, got = {"out": ref}, {"out": got}
    for k in ref:
        assert _rel(_f32(got[k]), _f32(ref[k])) < TOL_BODY[kind], k


def test_failed_factor_sets_the_flag_on_the_device_and_raises_on_the_cpu():
    """A tile that is not positive definite: the device POTRF records it
    in the pool's flag without raising (``cholesky_ex``), the CPU POTRF
    raises as numpy's Cholesky does; a clean factor leaves the flag
    clear."""
    bad = torch.from_numpy(-_spd(16, 25))
    check = potrf.CholeskyCheck()
    potrf._mk_potrf_last(check)(torch.from_numpy(_spd(16, 26)))
    assert not check.failed()
    potrf._mk_potrf(check)(bad, torch.zeros(16, 16))
    assert check.failed()
    potrf._mk_potrf_last(check)(torch.from_numpy(_spd(16, 26)))
    assert check.failed()                      # the flag only accumulates
    with pytest.raises(torch.linalg.LinAlgError):
        potrf._cpu_potrf(bad, torch.zeros(16, 16))


def test_failed_factor_in_a_pool_is_reported_after_the_run():
    mb, nt = 16, 3
    a = _spd(mb * nt, 27)
    a[-mb:, -mb:] = -a[-mb:, -mb:]             # the last diagonal tile
    mats = from_reference_arrays({"A": a}, Layout(mb, mb))
    with Context(nb_cores=2, device="cpu") as ctx:
        tp = potrf.potrf_taskpool(mats["A"])
        ctx.add_taskpool(tp)
        ctx.wait(timeout=300)
    assert tp.cholesky_check.failed()


# -- the whole slice ------------------------------------------------------------

def _counter(ctx):
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1
    ctx.pins_register("complete_exec", count)
    return done


def _run_jax(a, mb, kind, knobs=()):
    dt = STORAGE[kind][0]
    A = JaxMatrix(mb, mb, a.shape[0], a.shape[1], dtype=dt,
                  name="A").from_array(a.astype(dt))
    for knob, value in knobs:
        jax_params.set(knob, value)
    try:
        with JaxContext(nb_cores=2) as ctx:
            done = _counter(ctx)
            ctx.add_taskpool(jax_potrf.potrf_taskpool(A, device="tpu"))
            ctx.wait(timeout=300)
            stats = [d.stats for d in ctx.device_registry.accelerators]
    finally:
        for knob, _ in knobs:
            jax_params.unset(knob)
    return A, np.asarray(A.to_array(), np.float32), dict(done), stats


def _run_port(a, mb, kind, device="cuda", knobs=()):
    mats = from_reference_arrays({"A": a}, Layout(mb, mb, STORAGE[kind][1]))
    for knob, value in knobs:
        port_params.set(knob, value)
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            done = _counter(ctx)
            tp = potrf.potrf_taskpool(mats["A"], device=device)
            ctx.add_taskpool(tp)
            ctx.wait(timeout=300)
            stats = [d.stats for d in ctx.device_registry.accelerators]
    finally:
        for knob, _ in knobs:
            port_params.unset(knob)
    assert not tp.cholesky_check.failed()
    return mats["A"], to_reference_arrays(mats)["A"], dict(done), stats


def _counts(nt):
    panel = nt * (nt - 1) // 2
    want = {"POTRF": nt - 1, "POTRFL": 1, "TRSM": panel, "SYRK": panel,
            "GEMM": sum(n * (nt - 1 - n) for n in range(1, nt - 1))}
    return {c: v for c, v in want.items() if v}


def _llt_err(out, a, mb, nt):
    """||L L^T - A_eff||_max / ||A_eff||_max, A_eff the symmetric matrix
    the device factorizations see: the lower tiles, mirrored, with each
    diagonal tile symmetrized as (T + T^T)/2."""
    eff = np.zeros(a.shape, np.float64)
    for i in range(nt):
        for j in range(i + 1):
            t = a[i * mb:(i + 1) * mb, j * mb:(j + 1) * mb].astype(np.float64)
            if i == j:
                t = (t + t.T) / 2
            eff[i * mb:(i + 1) * mb, j * mb:(j + 1) * mb] = t
            eff[j * mb:(j + 1) * mb, i * mb:(i + 1) * mb] = t.T
    L = np.tril(out).astype(np.float64)
    return np.abs(L @ L.T - eff).max() / np.abs(eff).max()


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("operand", ["spd", "bench"])
@pytest.mark.parametrize("nt", [1, 2, 5])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_potrf_slice_matches_jax(kind, nt, operand, setting):
    """mb=32: per-class task counts (nt=5: POTRF 4, POTRFL 1, TRSM 10,
    SYRK 10, GEMM 10), every task run on the device, and the lower tiles
    against the JAX package's.  The bench operand's diagonal tiles are not
    symmetric, so its LL^T is held against the symmetrized matrix both
    device factorizations see.  At the defaults both packages chain panels
    (nt > 1: POTRF(k) is the only POTRF ready, so it reaches the device
    alone and is held — the DAG decides it; whether a wave fuses depends
    on timing and is not asserted), at one launch per task neither fuses
    nor chains."""
    mb = 32
    jax_knobs, port_knobs = SETTINGS[setting]
    a = _spd(mb * nt, 28) if operand == "spd" else _bench_operand(mb, nt)
    _, ref, ref_done, ref_stats = _run_jax(a, mb, kind, jax_knobs)
    cuda_kernels.gemm_tile_launches.reset()
    cuda_kernels.gemm_tile_grouped_launches.reset()
    _, got, got_done, stats = _run_port(a, mb, kind, knobs=port_knobs)
    # CPU: the plain versions ran
    assert cuda_kernels.gemm_tile_launches.value == 0
    assert cuda_kernels.gemm_tile_grouped_launches.value == 0
    assert got_done == ref_done == _counts(nt)
    assert sum(s.executed_tasks for s in stats) == sum(got_done.values())
    if setting == "defaults":
        if nt > 1:
            assert _chains(stats) > 0 and _chains(ref_stats) > 0
    else:
        assert _fusions(stats) == _fusions(ref_stats) == 0
        assert sum(s.executed_tasks for s in ref_stats) == \
            sum(ref_done.values())
    for i in range(nt):
        for j in range(i + 1):
            blk = np.s_[i * mb:(i + 1) * mb, j * mb:(j + 1) * mb]
            g, r = (np.tril(x[blk]) if i == j else x[blk] for x in (got, ref))
            assert _rel(g, r) < TOL_TILE[kind], (i, j)
    ar = a.astype(STORAGE[kind][0]).astype(np.float32)
    for out in (got, ref):
        err = _llt_err(out, ar, mb, nt)
        assert err < (1e-5 if kind == "f32" else 3e-2), err


@pytest.mark.parametrize("nt", [1, 3])
def test_potrf_cpu_bodies_match_numpy(nt):
    """The CPU incarnations alone, as the reference's
    tests/test_apps_drivers.py holds its own: LL^T against A in f32."""
    mb = 16
    a = _spd(mb * nt, 0)
    _, out, done, stats = _run_port(a, mb, "f32", device="cpu")
    assert sum(s.executed_tasks for s in stats) == 0
    assert done == _counts(nt)
    L = np.tril(out).astype(np.float64)
    assert np.abs(L @ L.T - a).max() / np.abs(a).max() < 1e-4


# -- numerics checks ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_checks_match_jax_on_a_carried_factor(kind):
    """The JAX package factors; its tiles are carried across with
    data/carry.py; both packages' backward_error and refine_solve then read
    the same factor and the same regenerated operand tiles (f32: both at
    the f32 floor; bf16: the error at bf16 epsilon, the ladder reaching
    f32 class, as tests/test_potrf_check.py holds the reference)."""
    mb, nt = 16, 4
    n = mb * nt
    a = _spd(n, 29)
    dt = STORAGE[kind][0]
    A, full, _, _ = _run_jax(a, mb, kind)
    stored = a.astype(dt)
    blk = lambda i, j: np.s_[i * mb:(i + 1) * mb, j * mb:(j + 1) * mb]  # noqa: E731
    ref_err = jax_check.backward_error(A, lambda i, j: stored[blk(i, j)])
    ref_ir = jax_check.refine_solve(A, lambda i, j: stored[blk(i, j)],
                                    steps=3, seed=1)
    P = from_reference_arrays({"A": full}, Layout(mb, mb, STORAGE[kind][1]))
    tiles = torch.from_numpy(stored.astype(np.float32)).to(
        torch.bfloat16 if kind == "bf16" else torch.float32)
    orig = lambda i, j: tiles[blk(i, j)]  # noqa: E731
    got_err = backward_error(P["A"], orig)
    got_ir = refine_solve(P["A"], orig, steps=3, seed=1)
    assert abs(got_err - ref_err) <= 1e-5 * ref_err or \
        max(got_err, ref_err) <= 1e-6, (got_err, ref_err)
    assert len(got_ir) == len(ref_ir) == 4
    for g, r in zip(got_ir, ref_ir):
        assert max(g, r) <= 1e-6 or abs(g - r) <= 1e-2 * r, (got_ir, ref_ir)
    if kind == "f32":
        assert got_err < 1e-5 and got_ir[0] < 1e-5
    else:
        assert 1e-5 < got_err < 5e-2
        assert got_ir[0] > 1e-6 and got_ir[-1] < 1e-5


def test_refine_solve_draws_b_as_the_reference_does():
    """b comes from ``numpy.random.default_rng(seed)``, one block per tile
    row, as the reference draws it: with the identity as the factor, the
    direct solve gives x = b, and against the operand D = diag(d) its
    residual is ||(1 - d) b|| / ||b||, which depends on b."""
    mb, nt, seed = 8, 2, 5
    n = mb * nt
    d = (1.0 + np.arange(n) / n).astype(np.float32)
    D = np.diag(d)
    P = from_reference_arrays({"A": np.eye(n, dtype=np.float32)},
                              Layout(mb, mb))
    hist = refine_solve(P["A"], lambda i, j: torch.from_numpy(
        D[i * mb:(i + 1) * mb, j * mb:(j + 1) * mb].copy()), steps=0,
        seed=seed)
    rng = np.random.default_rng(seed)
    b = np.concatenate([rng.standard_normal(mb).astype(np.float32)
                        for _ in range(nt)])
    want = np.linalg.norm((1 - d) * b) / np.linalg.norm(b)
    assert hist == [pytest.approx(want, rel=1e-5)]


# -- the taskpool's contract --------------------------------------------------

def test_potrf_taskpool_refuses_tf32():
    A = TwoDimBlockCyclic(8, 8, 16, 16)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            potrf.potrf_taskpool(A)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("shape,precision", [
    ((16, 24), None), ((20, 20), None), ((16, 16), "default")],
    ids=["not-square", "ragged", "precision"])
def test_potrf_taskpool_refuses_what_it_does_not_take(shape, precision):
    with pytest.raises(ValueError):
        potrf.potrf_taskpool(TwoDimBlockCyclic(8, 8, *shape),
                             precision=precision)


def test_potrf_taskpool_flops_match_the_reference():
    mb = 24
    ref = jax_potrf.potrf_taskpool(JaxMatrix(mb, mb, 3 * mb, 3 * mb),
                                   device="cpu")
    got = potrf.potrf_taskpool(TwoDimBlockCyclic(mb, mb, 3 * mb, 3 * mb))
    assert set(got.task_classes) == set(ref.task_classes)
    for name, tc in ref.task_classes.items():
        assert got.task_classes[name].properties["flops"] == \
            tc.properties["flops"], name
    assert potrf.potrf_flops(98304) == jax_potrf.potrf_flops(98304)
