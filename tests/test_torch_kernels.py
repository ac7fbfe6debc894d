"""The port's tile kernels against the JAX package's Pallas kernels.

On the CPU the wrappers ``gemm_tile`` and ``gram_tile`` take their plain
versions; these tests hold those plain versions against
``pallas_gemm_tile`` and ``pallas_gram_tile`` run as tests/test_pallas.py
runs them (Pallas in interpret mode on the CPU, 128 blocks), and ragged
shapes against the JAX fallback paths.  ``tri_inv``, the matmul-only
triangular inverse of the QR panel, is held against the JAX one.

Tolerances, as max|port - jax| / max(1, max|jax|): 1e-5 for f32 inputs
(only the order of the f32 summation differs) and 1e-3 for bf16 inputs
(the tests/test_pallas.py bound).  The kernels themselves, which need the
card, are held against the plain versions in tests/test_torch_cuda.py.
"""

import re
import shutil
import stat

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.apps.pallas_kernels import pallas_gemm_tile, \
    pallas_gram_tile
from parsec_tpu.apps.potrf import tri_inv as jax_tri_inv
from parsec_tpu_torch.apps import cuda_kernels
from parsec_tpu_torch.apps.cuda_kernels import gemm_tile, \
    gemm_tile_reference, gram_tile, gram_tile_reference
from parsec_tpu_torch.apps.potrf import tri_inv

TOL = {"f32": 1e-5, "bf16": 1e-3}


def _rel_err(got, ref):
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def _operands(m, k, n, kind, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    if kind == "bf16":
        a = a.astype(ml_dtypes.bfloat16)
        b = b.astype(ml_dtypes.bfloat16)
    return a, b, c


def _to_torch(x):
    """numpy (f32 or ml_dtypes bf16) -> CPU tensor of the same type; bf16
    goes through f32, which is exact."""
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _port(a, b, c, alpha):
    out = gemm_tile(_to_torch(a), _to_torch(b), _to_torch(c), alpha)
    return out.numpy()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("alpha", [1.0, 2.0, -1.0])
def test_plain_matches_pallas_blocked(kind, alpha):
    """256^2 with 128 blocks: the blocked Pallas program in interpret
    mode (f32 VMEM accumulator, K-innermost grid) vs the port."""
    a, b, c = _operands(256, 256, 256, kind, seed=10)
    fn = pallas_gemm_tile(alpha, bm=128, bn=128, bk=128)
    ref = np.asarray(jax.jit(fn)(a, b, c))
    assert _rel_err(_port(a, b, c, alpha), ref) < TOL[kind]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(100, 100, 100), (200, 136, 72),
                                   (129, 257, 130)])
def test_plain_matches_fallback_on_ragged_shapes(kind, shape):
    """Shapes off the 128 grid take the JAX fused fallback; the port has
    no fallback (the kernel masks the edge) and must agree with it."""
    m, k, n = shape
    a, b, c = _operands(m, k, n, kind, seed=11)
    fn = pallas_gemm_tile(-1.0, precision="highest")
    ref = np.asarray(jax.jit(fn)(a, b, c))
    assert _rel_err(_port(a, b, c, -1.0), ref) < TOL[kind]


def test_cpu_tensors_take_the_plain_version_without_counting():
    cuda_kernels.gemm_tile_launches.reset()
    a, b, c = (torch.from_numpy(x) for x in _operands(64, 32, 48, "f32", 3))
    out = gemm_tile(a, b, c, 0.5)
    torch.testing.assert_close(out, gemm_tile_reference(a, b, c, 0.5),
                               rtol=0, atol=0)
    assert out.data_ptr() != c.data_ptr()     # functional: C not aliased
    assert cuda_kernels.gemm_tile_launches.value == 0


def test_plain_version_keeps_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a, b, c = (torch.from_numpy(x)
                   for x in _operands(8, 8, 8, "f32", 4))
        gemm_tile_reference(a, b, c)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("shape,blocks", [((512, 256), (128, 128)),
                                          ((100, 36), None)],
                         ids=["blocked-512x256", "fallback-100x36"])
def test_gram_plain_matches_pallas(shape, blocks):
    """512x256 runs the blocked Pallas Gram program in interpret mode (f32
    VMEM accumulator over a K-innermost grid of 128 blocks, HIGHEST);
    100x36 is off the 128 grid and takes the JAX fallback, where the
    port has none (the kernel masks the edge).  Tolerance 1e-5: both sides
    are true f32, only the summation order differs."""
    X = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    fn = pallas_gram_tile(*blocks) if blocks else pallas_gram_tile()
    ref = np.asarray(jax.jit(fn)(X))
    got = gram_tile(torch.from_numpy(X))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert _rel_err(got.numpy(), ref) < 1e-5


def test_gram_cpu_tensors_take_the_plain_version_without_counting():
    cuda_kernels.gram_tile_launches.reset()
    X = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 24)).astype(np.float32))
    torch.testing.assert_close(gram_tile(X), gram_tile_reference(X),
                               rtol=0, atol=0)
    assert cuda_kernels.gram_tile_launches.value == 0


@pytest.mark.parametrize("n", [64, 1024], ids=["leaf", "recursive"])
def test_tri_inv_matches_jax(n):
    """n=1024 takes the recursive branch above the 512 leaf.  The JAX
    side runs at HIGHEST, the port in f32 with TF32 off; tolerance 1e-5
    (only the order of f32 sums differs).  The result inverts L."""
    rng = np.random.default_rng(n)
    L = (np.tril(0.05 * rng.standard_normal((n, n)))
         + np.eye(n)).astype(np.float32)
    ref = np.asarray(jax_tri_inv(jax.numpy.asarray(L),
                                 precision=jax.lax.Precision.HIGHEST))
    got = tri_inv(torch.from_numpy(L)).numpy()
    assert _rel_err(got, ref) < 1e-5
    assert np.abs(got @ L - np.eye(n)).max() < 1e-4
    assert not np.triu(got, 1).any()


def test_library_name_changes_with_any_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_kernels._CSRC, csrc)
    monkeypatch.setattr(cuda_kernels, "_CSRC", csrc)
    names = {cuda_kernels.library_path().name}
    assert {p.name for p in cuda_kernels.sources()} >= {"gemm_tile.cu",
                                                        "gram_tile.cu"}
    for src in cuda_kernels.sources():
        src.write_text(src.read_text() + "\n// edited\n")
        names.add(cuda_kernels.library_path().name)
    assert len(names) == 1 + len(cuda_kernels.sources())


def test_build_failure_names_the_source(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` that fails on one source: the build raises with
    that source's name and leaves nothing behind."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text('#!/bin/sh\ncase "$*" in *gram_tile.cu*) '
                    'echo broken >&2; exit 3;; esac\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_kernels, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="gram_tile.cu"):
        cuda_kernels.build()
    assert list((tmp_path / "build").iterdir()) == []


BF16 = torch.bfloat16


@pytest.mark.parametrize("m,n,k,ptrs,route", [
    (12288, 12288, 12288, (0, 0, 0), "wgmma"),      # GEMM mb=12288
    (6144, 6144, 6144, (256, 512, 1024), "wgmma"),   # QR updates
    (2048, 2048, 2048, (16, 32, 8), "wgmma"),        # GEMM mb=2048
    (1000, 776, 520, (0, 0, 0), "wgmma"),            # ragged, multiples of 8
    (40, 776, 8, (0, 0, 0), "wgmma"),                # under one stage of K
    (1000, 777, 520, (0, 0, 0), "wmma"),             # n % 8
    (1000, 776, 513, (0, 0, 0), "wmma"),             # k % 8
    (1000, 776, 0, (0, 0, 0), "wmma"),               # k = 0
    (256, 256, 256, (2, 0, 0), "wmma"),              # A misaligned
    (256, 256, 256, (0, 8, 0), "wmma"),              # B misaligned
    (256, 256, 256, (0, 0, 4), "wmma"),              # C misaligned
    (256, 256, 256, (0, 0, 0), "fma")],              # f32
    ids=["mb12288", "qr6144", "mb2048", "ragged8", "k8", "n-odd", "k-odd",
         "k0", "a-misaligned", "b-misaligned", "c-misaligned", "f32"])
def test_gemm_route_by_shape_and_alignment(m, n, k, ptrs, route):
    """TMA describes a bf16 operand only with rows of a whole number of 16
    bytes on 16-byte aligned bases; the epilogue pairs C's columns."""
    dtype = torch.float32 if route == "fma" else BF16
    base = 1 << 20
    a, b, c = (base + p for p in ptrs)
    assert cuda_kernels.gemm_route(m, n, k, dtype, a, b, c) == route


def test_gemm_route_refuses_other_types():
    with pytest.raises(TypeError):
        cuda_kernels.gemm_route(8, 8, 8, torch.float16, 0, 0, 0)


@pytest.mark.parametrize("m", [0, 1, 15, 16, 20, 100, 6143, 6144, 6145,
                               12288, 100000])
@pytest.mark.parametrize("n", [1, 33, 512])
def test_gram_split_plan_covers_every_row_once(m, n):
    """The runs [s * rows, min(m, (s + 1) * rows)) of the plan tile the
    rows of X: every row in exactly one run, no run empty (one empty run at
    m = 0), each run a whole number of stages, and the grid within the
    blocks the plan aims at (or one run a tile when the tiles alone
    exceed it)."""
    sms = 132
    splits, rows = cuda_kernels.gram_split_plan(m, n, sms)
    assert rows % cuda_kernels.GRAM_STAGE_ROWS == 0 and splits >= 1
    runs = [range(s * rows, min(m, (s + 1) * rows)) for s in range(splits)]
    covered = [r for run in runs for r in run]
    assert covered == list(range(m))
    assert all(len(run) > 0 for run in runs) or (m == 0 and splits == 1)
    tiles = cuda_kernels.gram_upper_tiles(n)
    assert (splits * tiles <= cuda_kernels.GRAM_BLOCKS_PER_SM * sms
            or splits == 1)


def test_gram_split_plan_at_the_qr_shape():
    """6144 x 512 on 132 SMs: 36 upper tiles, 22 runs of 288 rows (the last
    96), 792 blocks, all that 6 a SM allow: one wave."""
    assert cuda_kernels.gram_upper_tiles(512) == 36
    assert cuda_kernels.gram_split_plan(6144, 512, 132) == (22, 288)


@pytest.mark.parametrize("name,kernel_name", [
    ("GRAM_TILE", "kT"), ("GRAM_STAGE_ROWS", "kKC"),
    ("GRAM_BLOCKS_PER_SM", "kBlocksPerSM")])
def test_gram_plan_constants_match_the_kernel(name, kernel_name):
    """The wrapper sizes the split plan and its scratch from copies of the
    kernel's own constants: the two must not drift apart."""
    src = (cuda_kernels._CSRC / "gram_tile.cu").read_text()
    found = re.findall(rf"constexpr int {kernel_name} = (\d+);", src)
    assert found == [str(getattr(cuda_kernels, name))]


# -- the transposed-B, bf16-C variant (the Cholesky updates) ------------------

def _bf16_ulps_apart(got, ref):
    """Elementwise |got - ref| in units of the last place of ref's bf16
    value (both are bf16 values held as f32)."""
    _, e = np.frexp(ref)
    return np.abs(got - ref) / np.ldexp(1.0, e - 8)


def _trans_b_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal((n, k)).astype(ml_dtypes.bfloat16)
    c = rng.standard_normal((m, n)).astype(ml_dtypes.bfloat16)
    return a, b, c


@pytest.mark.parametrize("shape", [(128, 256, 64), (100, 72, 136)],
                         ids=["aligned", "ragged"])
def test_trans_b_bf16_c_plain_rounds_once(shape):
    """The plain version of ``C - A @ B^T`` with a bf16 C: an f32 sum seeded
    from C, rounded once to bf16 — a numpy oracle accumulating in f32 and
    rounding at the end.  Rounding the product to bf16 before the sum (the
    double rounding the f32-C plain version's cast would give) misses the
    oracle far more often."""
    m, k, n = shape
    a, b, c = _trans_b_operands(m, k, n, seed=12)
    a32, b32, c32 = (x.astype(np.float32) for x in (a, b, c))
    prod = a32 @ b32.T
    oracle = (c32 + np.float32(-1.0) * prod).astype(ml_dtypes.bfloat16)
    got = gemm_tile(_to_torch(a), _to_torch(b), _to_torch(c), -1.0,
                    trans_b=True)
    assert got.dtype == torch.bfloat16
    got32 = got.float().numpy()
    ref32 = oracle.astype(np.float32)
    assert _bf16_ulps_apart(got32, ref32).max() <= 1.0
    assert np.mean(got32 != ref32) <= 1e-2      # f32 sums in another order
    twice = (c32 - prod.astype(ml_dtypes.bfloat16).astype(np.float32)) \
        .astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.mean(twice != ref32) > 10 * max(np.mean(got32 != ref32),
                                              1.0 / got32.size)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_trans_b_plain_matches_pallas_blocked(kind):
    """``C - A @ B^T`` against the blocked Pallas program in interpret mode
    on A, B^T made contiguous and C in the tile type (the reference's
    kernel seeds its f32 accumulator from C and casts once at the end, as
    the variant does): 1e-5 in f32, one bf16 ulp in bf16."""
    m, k, n = 256, 256, 128
    if kind == "bf16":
        a, b, c = _trans_b_operands(m, k, n, seed=13)
    else:
        rng = np.random.default_rng(13)
        a, b, c = (rng.standard_normal(s).astype(np.float32)
                   for s in ((m, k), (n, k), (m, n)))
    fn = pallas_gemm_tile(-1.0, bm=128, bn=128, bk=128)
    ref = np.asarray(jax.jit(fn)(a, np.ascontiguousarray(b.T), c),
                     np.float32)
    got = gemm_tile(_to_torch(a), _to_torch(b), _to_torch(c), -1.0,
                    trans_b=True).float().numpy()
    if kind == "bf16":
        assert _bf16_ulps_apart(got, ref).max() <= 1.0
    else:
        assert _rel_err(got, ref) < 1e-5


def test_trans_b_cpu_tensors_take_the_plain_version_without_counting():
    cuda_kernels.gemm_tile_launches.reset()
    a, b, c = (_to_torch(x) for x in _trans_b_operands(64, 32, 48, 14))
    out = gemm_tile(a, b, c, -1.0, trans_b=True)
    torch.testing.assert_close(
        out, gemm_tile_reference(a, b, c, -1.0, trans_b=True), rtol=0,
        atol=0)
    assert out.dtype == torch.bfloat16 and out.data_ptr() != c.data_ptr()
    assert cuda_kernels.gemm_tile_launches.value == 0


@pytest.mark.parametrize("m,n,k,ptrs,dtype,route", [
    (6144, 6144, 6144, (256, 512, 1024), BF16, "wgmma"),  # potrf updates
    (1000, 778, 520, (0, 0, 0), BF16, "wgmma"),   # n even: no TMA rule on n
    (40, 6, 8, (0, 0, 4), BF16, "wgmma"),         # bf16 C: 4-byte pairs
    (1000, 777, 520, (0, 0, 0), BF16, "wmma"),    # n odd: no column pairs
    (1000, 778, 513, (0, 0, 0), BF16, "wmma"),    # k % 8: B^T's rows
    (256, 256, 256, (0, 2, 0), BF16, "wmma"),     # B misaligned
    (256, 256, 256, (0, 0, 2), BF16, "wmma"),     # C misaligned
    (256, 256, 256, (0, 0, 0), torch.float32, "fma")],
    ids=["potrf6144", "ragged-n", "small", "n-odd", "k-odd",
         "b-misaligned", "c-misaligned", "f32"])
def test_gemm_route_with_trans_b(m, n, k, ptrs, dtype, route):
    """B given as (n, k) puts TMA's row rule on k, which A's rows already
    carry; the epilogue still pairs C's columns, now bf16 (4 bytes)."""
    base = 1 << 20
    a, b, c = (base + p for p in ptrs)
    c_dtype = BF16 if dtype == BF16 else torch.float32
    assert cuda_kernels.gemm_route(m, n, k, dtype, a, b, c, trans_b=True,
                                   c_dtype=c_dtype) == route
