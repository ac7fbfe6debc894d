"""The QR slice: the port's tiled QR against the JAX package's.

The same seeded inputs (numpy) go through both packages.  The JAX side
runs its QR task bodies and ``qr_taskpool`` on its CPU XLA devices with
``--mca qr_pallas_gram 1`` (the blocked Pallas Gram kernel in interpret
mode, as tests/test_pallas.py runs it); the port runs its bodies on CPU
tensors (the kernels' plain versions) and its taskpool on the CPU-backed
device module.  Operands are 0.05*N(0,1) + I in every tile, the JAX
bench's geqrf operand (``prestage(..., bump_all=1.0, rand_scale=0.05)``).

Tolerances, as max|port - jax| / max(1, max|jax|):
  * f32: 1e-5 for one task body and 1e-4 for R after the whole slice
    (measured ~4e-7 per body: both packages run the same true-f32
    arithmetic in another order, and the slice chains 14 tasks);
  * bf16 storage, one body: 1e-2 — a sum that lands next to a bf16
    rounding boundary rounds one bf16 ulp apart (2^-8 to 2^-7 relative);
  * bf16 storage, R after the slice: 3e-2 — such flips enter the
    trailing matrix and the last panels factor it again, so two bf16
    factorizations differ at the factor's own accuracy class (RᵀR against
    AᵀA reads 1.1e-2 here in both packages, as the JAX package's bf16
    bench factor read 1.0e-2); measured up to 7.8e-3.
RᵀR against AᵀA holds the reference's own bound (tests/test_apps_drivers
.py: 1e-4 in f32).
"""

import collections
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.apps import qr as jax_qr
from parsec_tpu.apps.qr_check import ls_refine as jax_ls_refine
from parsec_tpu.core.context import Context as JaxContext
from parsec_tpu.data.matrix import TwoDimBlockCyclic as JaxMatrix
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.apps import cuda_kernels, qr
from parsec_tpu_torch.apps.qr_check import ls_refine
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.carry import (Layout, from_reference_arrays,
                                         to_reference_arrays)
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.utils.mca import params as port_params

TOL_BODY = {"f32": 1e-5, "bf16": 1e-2}
TOL_SLICE = {"f32": 1e-4, "bf16": 3e-2}
STORAGE = {"f32": (np.float32, "float32"),
           "bf16": (ml_dtypes.bfloat16, "bfloat16")}


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _operand(mb, seed, nt=1):
    """nt x nt tiles of mb x mb, each 0.05*N(0,1) + I."""
    n = mb * nt
    rng = np.random.default_rng(seed)
    return (0.05 * rng.standard_normal((n, n))
            + np.kron(np.ones((nt, nt)), np.eye(mb))).astype(np.float32)


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


# -- task bodies -------------------------------------------------------------

@pytest.mark.parametrize("mb,ib", [(256, 128), (32, 0)],
                         ids=["blocked-ib128", "unblocked"])
def test_geqrt_matches_jax(mb, ib):
    """The blocked GEQRT's Gram products run the Pallas kernel on the JAX
    side and gram_tile's plain version on the port's."""
    T = _operand(mb, 5)
    ref = jax_qr._mk_geqrt(ib, pallas_gram=ib > 0)(
        jnp.asarray(T), jnp.zeros((mb, mb), jnp.float32))
    before = qr.qr_guard_fallbacks.value
    got = qr._mk_geqrt(ib)(torch.from_numpy(T), torch.zeros(mb, mb))
    assert qr.qr_guard_fallbacks.value == before       # fast path taken
    for k in ("T", "Q"):
        assert _rel(_f32(got[k]), ref[k]) < TOL_BODY["f32"], k
    Q, R = got["Q"].double(), got["T"].double()
    assert (Q.T @ Q - torch.eye(mb, dtype=torch.float64)).abs().max() < 5e-5
    assert (Q @ R - torch.from_numpy(T).double()).abs().max() < 1e-5


@pytest.mark.parametrize("ib", [128, 0], ids=["blocked-ib128", "unblocked"])
def test_tsqrt_matches_jax(ib):
    mb = 256
    R = np.triu(_operand(mb, 6))
    B = _operand(mb, 7)
    ref = jax_qr._mk_tsqrt(ib)(jnp.asarray(R), jnp.asarray(B),
                               jnp.zeros((2 * mb, mb), jnp.float32))
    before = qr.qr_guard_fallbacks.value
    got = qr._mk_tsqrt(ib)(torch.from_numpy(R.copy()), torch.from_numpy(B),
                           torch.zeros(2 * mb, mb))
    assert qr.qr_guard_fallbacks.value == before
    for k in ("T", "B", "Q"):
        assert _rel(_f32(got[k]), ref[k]) < TOL_BODY["f32"], k


def _wy_pair(mb, seed):
    R = np.triu(_operand(mb, seed))
    return np.asarray(jax_qr._mk_tsqrt(0)(
        jnp.asarray(R), jnp.asarray(_operand(mb, seed + 1)),
        jnp.zeros((2 * mb, mb), jnp.float32))["Q"])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_tsmqr_matches_jax(kind):
    """TSMQR's three products run on gemm_tile (its plain version here):
    bf16 operands, f32 accumulation, the reference's rounding points."""
    mb = 256
    rng = np.random.default_rng(8)
    Q = _wy_pair(mb, 9)
    C1, C2 = (rng.standard_normal((mb, mb)).astype(np.float32)
              for _ in range(2))
    (qj, qt), (c1j, c1t), (c2j, c2t) = (_store(x, kind) for x in (Q, C1, C2))
    ref = jax_qr._mk_tsmqr()(jnp.asarray(qj), jnp.asarray(c1j),
                             jnp.asarray(c2j))
    cuda_kernels.gemm_tile_launches.reset()
    got = qr._mk_tsmqr()(qt, c1t, c2t)
    assert cuda_kernels.gemm_tile_launches.value == 0    # CPU: plain version
    for k in ("C1", "C2"):
        assert got[k].dtype == qt.dtype
        assert _rel(_f32(got[k]), _f32(ref[k])) < TOL_BODY[kind], k


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_unmqr_matches_jax(kind):
    mb = 256
    Q = np.asarray(jax_qr._mk_geqrt(0)(
        jnp.asarray(_operand(mb, 10)), jnp.zeros((mb, mb)))["Q"])
    C = np.random.default_rng(11).standard_normal((mb, mb)).astype(
        np.float32)
    (qj, qt), (cj, ct) = _store(Q, kind), _store(C, kind)
    ref = jax_qr._mk_unmqr()(jnp.asarray(qj), jnp.asarray(cj))
    got = qr._mk_unmqr()(qt, ct)
    assert got["C"].dtype == ct.dtype
    assert _rel(_f32(got["C"]), _f32(ref["C"])) < TOL_BODY[kind]


@pytest.mark.parametrize("mb,ib", [(256, 128), (32, 0)],
                         ids=["blocked-ib128", "unblocked"])
def test_rank_deficient_tile_takes_the_householder_guard(mb, ib):
    """A zero column makes the Gram matrix singular: the JAX Cholesky
    yields NaNs and ``lax.cond`` picks the Householder QR; the port's
    ``cholesky_ex`` reports it and the host branch does the same.  Both
    then hold LAPACK's Householder R (negative diagonal entries, which the
    Cholesky path never gives)."""
    T = _operand(mb, 12)
    T[:, 5] = 0.0
    ref = jax_qr._mk_geqrt(ib, pallas_gram=ib > 0)(
        jnp.asarray(T), jnp.zeros((mb, mb), jnp.float32))
    before = qr.qr_guard_fallbacks.value
    got = qr._mk_geqrt(ib)(torch.from_numpy(T), torch.zeros(mb, mb))
    assert qr.qr_guard_fallbacks.value == before + 1
    assert (np.diag(np.asarray(ref["T"])) < 0).any()
    assert _rel(_f32(got["T"]), ref["T"]) < TOL_BODY["f32"]
    Q, R = got["Q"].double(), got["T"].double()
    assert (Q @ R - torch.from_numpy(T).double()).abs().max() < 1e-5


# -- the whole slice ------------------------------------------------------------

def _counter(ctx):
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1
    ctx.pins_register("complete_exec", count)
    return done


def _run_jax(a, mb, kind, ib):
    dt = STORAGE[kind][0]
    A = JaxMatrix(mb, mb, a.shape[0], a.shape[1], dtype=dt,
                  name="A").from_array(a.astype(dt))
    jax_params.set("qr_ib", ib)
    jax_params.set("qr_pallas_gram", 1)
    jax_qr._kernels.clear()
    try:
        with JaxContext(nb_cores=2) as ctx:
            done = _counter(ctx)
            ctx.add_taskpool(jax_qr.qr_taskpool(A, device="tpu"))
            ctx.wait(timeout=300)
    finally:
        jax_params.unset("qr_ib")
        jax_params.unset("qr_pallas_gram")
        jax_qr._kernels.clear()
    return np.asarray(A.to_array(), np.float32), dict(done)


def _run_port(a, mb, kind, ib, device="cuda"):
    mats = from_reference_arrays({"A": a}, Layout(mb, mb, STORAGE[kind][1]))
    port_params.set("qr_ib", ib)
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            done = _counter(ctx)
            ctx.add_taskpool(qr.qr_taskpool(mats["A"], device=device))
            ctx.wait(timeout=300)
            launched = sum(d.stats.executed_tasks
                           for d in ctx.device_registry.accelerators)
    finally:
        port_params.unset("qr_ib")
    return to_reference_arrays(mats)["A"], dict(done), launched


def _rtr_err(out, a):
    R = np.triu(out).astype(np.float64)
    ata = a.astype(np.float64).T @ a.astype(np.float64)
    return np.abs(R.T @ R - ata).max() / np.abs(ata).max()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_qr_slice_matches_jax(kind):
    """mb=256, nt=3, qr_ib=128: 14 tasks, every one a device launch."""
    mb, nt, ib = 256, 3, 128
    a = _operand(mb, 13, nt)
    ref, ref_done = _run_jax(a, mb, kind, ib)
    cuda_kernels.gram_tile_launches.reset()
    got, got_done, launched = _run_port(a, mb, kind, ib)
    assert cuda_kernels.gram_tile_launches.value == 0    # CPU: plain version
    assert got_done == ref_done == {"GEQRT": 3, "UNMQR": 3, "TSQRT": 3,
                                    "TSMQR": 5}
    assert launched == sum(got_done.values())
    for i in range(nt):
        for j in range(nt):
            blk = np.s_[i * mb:(i + 1) * mb, j * mb:(j + 1) * mb]
            if i > j:
                assert not got[blk].any(), (i, j)   # zeroed below
            else:
                assert _rel(got[blk], ref[blk]) < TOL_SLICE[kind], (i, j)
    if kind == "f32":
        assert _rtr_err(got, a) < 1e-4
    else:   # against the bf16-rounded operand the factor came from
        ar = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert _rtr_err(got, ar) < 3e-2


def test_qr_slice_unblocked_matches_jax():
    mb, nt = 32, 3
    a = _operand(mb, 14, nt)
    ref, ref_done = _run_jax(a, mb, "f32", 0)
    got, got_done, _ = _run_port(a, mb, "f32", 0)
    assert got_done == ref_done
    assert _rel(np.triu(got), np.triu(ref)) < TOL_SLICE["f32"]
    assert _rtr_err(got, a) < 1e-4


@pytest.mark.parametrize("nt", [1, 2, 4])
def test_qr_cpu_bodies_match_numpy(nt):
    """The CPU incarnations alone (float64 torch ops), as the reference's
    tests/test_apps_drivers.py holds its own: a full Householder GEQRT
    gives other signs than the Cholesky-QR device body, so R is checked
    through RᵀR = AᵀA."""
    mb = 8
    n = nt * mb
    a = np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    out, done, launched = _run_port(a, mb, "f32", 0, device="cpu")
    assert launched == 0
    assert sum(done.values()) == nt + 2 * (nt * (nt - 1) // 2) + sum(
        (nt - 1 - k) ** 2 for k in range(nt))
    assert np.abs(np.tril(out, -1)).max() < 1e-4
    assert _rtr_err(out, a) < 1e-4


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_ls_refine_matches_jax(kind):
    """The CSNE ladder of both packages on their own factored R: every
    iterate agrees to 10% until both reach the f32 floor (1e-5 here, where
    rounding alone decides the value: the f32 direct solves read 3.7e-6
    and 2.5e-6), and both ladders reach f32 class (tests/test_qr_check.py's
    bound, 1e-6)."""
    n, mb = 64, 16
    rng = np.random.default_rng(0 if kind == "f32" else 1)
    scale = 0.1 if kind == "f32" else 0.05
    a = (scale * rng.standard_normal((n, n)) + np.eye(n)).astype(np.float32)
    ar = a.astype(STORAGE[kind][0]).astype(np.float32)
    dt = STORAGE[kind][0]
    A = JaxMatrix(mb=mb, nb=mb, lm=n, ln=n, dtype=dt)
    for m, nn in A.local_tiles():
        A.data_of(m, nn).overwrite_host(
            a[m * mb:(m + 1) * mb, nn * mb:(nn + 1) * mb].astype(dt))
    with JaxContext(nb_cores=2) as ctx:
        ctx.add_taskpool(jax_qr.qr_taskpool(A, device="tpu"))
        ctx.wait()
    ref = jax_ls_refine(A, lambda i, j: jnp.asarray(
        ar[i * mb:(i + 1) * mb, j * mb:(j + 1) * mb]), steps=4)

    P = TwoDimBlockCyclic(mb, mb, n, n, dtype=STORAGE[kind][1])
    P.from_array(torch.from_numpy(a))
    with Context(nb_cores=2, device="cpu") as ctx:
        ctx.add_taskpool(qr.qr_taskpool(P))
        ctx.wait()
    tiles = torch.from_numpy(ar)
    got = ls_refine(P, lambda i, j: tiles[i * mb:(i + 1) * mb,
                                          j * mb:(j + 1) * mb], steps=4)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert max(g, r) <= 1e-5 or abs(g - r) <= 0.1 * r, (got, ref)
    assert min(got) <= 1e-6 and min(ref) <= 1e-6
    assert got[-1] <= got[0]


@pytest.mark.parametrize("conditioned", [False, True],
                         ids=["bench-operand", "conditioned-operand"])
def test_ls_refine_on_the_card_run_operands_in_both_packages(conditioned):
    """The two operands of chip_smoke.py's QR path, bf16 storage.  The
    geqrf bench operand (0.05*N(0,1) + I in every tile) is near-singular
    (cond ~1e3 at n = 96), and the CSNE ladder, which contracts only while
    cond^2 * eps_bf16 < 1, diverges in BOTH packages; on I + (0.25/sqrt(n))
    * N(0,1) (singular values in [0.5, 1.5]) both reach f32 class and
    agree to 10% above the f32 floor."""
    mb, nt = 32, 3
    n = mb * nt
    rng = np.random.default_rng(15)
    if conditioned:
        a = np.eye(n) + 0.25 / np.sqrt(n) * rng.standard_normal((n, n))
    else:
        a = 0.05 * rng.standard_normal((n, n)) \
            + np.kron(np.ones((nt, nt)), np.eye(mb))
    a = a.astype(np.float32).astype(ml_dtypes.bfloat16)
    ar = a.astype(np.float32)
    blk = lambda i, j: np.s_[i * mb:(i + 1) * mb, j * mb:(j + 1) * mb]  # noqa: E731
    A = JaxMatrix(mb, mb, n, n, dtype=ml_dtypes.bfloat16).from_array(a)
    jax_params.set("qr_ib", 16)
    port_params.set("qr_ib", 16)
    try:
        with JaxContext(nb_cores=2) as ctx:
            ctx.add_taskpool(jax_qr.qr_taskpool(A, device="tpu"))
            ctx.wait()
        P = from_reference_arrays({"A": ar}, Layout(mb, mb, "bfloat16"))["A"]
        with Context(nb_cores=2, device="cpu") as ctx:
            ctx.add_taskpool(qr.qr_taskpool(P))
            ctx.wait()
    finally:
        jax_params.unset("qr_ib")
        port_params.unset("qr_ib")
    ref = jax_ls_refine(A, lambda i, j: jnp.asarray(ar[blk(i, j)]), steps=4)
    tiles = torch.from_numpy(ar)
    got = ls_refine(P, lambda i, j: tiles[blk(i, j)], steps=4)
    if conditioned:
        assert max(min(got), min(ref)) <= 1e-5
        for g, r in zip(got, ref):
            assert max(g, r) <= 1e-5 or abs(g - r) <= 0.1 * r, (got, ref)
    else:
        for hist in (got, ref):
            assert 1.0 < hist[0] < hist[-1], (got, ref)


# -- the taskpool's contract --------------------------------------------------

def test_qr_taskpool_refuses_tf32():
    A = TwoDimBlockCyclic(8, 8, 16, 16)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            qr.qr_taskpool(A)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_qr_taskpool_refuses_multi_rank_and_ragged_grids():
    with pytest.raises(NotImplementedError):
        qr.qr_taskpool(TwoDimBlockCyclic(8, 8, 16, 16, nodes=2, P=2))
    with pytest.raises(ValueError):
        qr.qr_taskpool(TwoDimBlockCyclic(8, 8, 16, 24))


@pytest.mark.parametrize("ib,mb,want", [(512, 6144, 512), (0, 64, 0),
                                        (48, 64, 0), (64, 64, 0),
                                        (16, 64, 16)])
def test_effective_ib_clamps_like_the_reference(ib, mb, want):
    port_params.set("qr_ib", ib)
    jax_params.set("qr_ib", ib)
    try:
        assert qr.effective_ib(mb) == jax_qr.effective_ib(mb) == want
    finally:
        port_params.unset("qr_ib")
        jax_params.unset("qr_ib")


def test_geqrf_flops_matches_the_reference():
    assert qr.geqrf_flops(49152, 49152) == jax_qr.geqrf_flops(49152, 49152)
