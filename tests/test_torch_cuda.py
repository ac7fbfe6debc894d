"""Hand-written kernels of the port against their plain versions, on the
card.  Marked ``cuda``: each test skips without a CUDA device.  This file
imports neither JAX nor the JAX package, so it also runs where neither is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, as max|kernel - plain| / max(1, max|plain|): 1e-4 with bf16
inputs and 1e-5 with f32 inputs (products are exact in f32 in both cases;
only the order of the f32 summation differs).

The tiled GEMM also runs here through the runtime under a 1 MiB device
copy-cache budget, so that tiles are evicted and written back to the host
between launches on the card; the tiled QR runs on the card against the
same run on the CPU-backed device module.
"""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.apps import cuda_kernels, qr
from parsec_tpu_torch.apps.cuda_kernels import gemm_tile, \
    gemm_tile_reference, gram_tile, gram_tile_reference
from parsec_tpu_torch.apps.gemm import gemm_taskpool
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.carry import (Layout, from_reference_arrays,
                                         to_reference_arrays)
from parsec_tpu_torch.utils.mca import params


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,alpha", [
    (torch.bfloat16, (1000, 513, 777), -1.0),
    (torch.float32, (1000, 513, 777), -1.0),
    (torch.bfloat16, (512, 512, 512), 1.0),
    (torch.bfloat16, (130, 24, 264), 2.0),
    (torch.float32, (256, 256, 256), 0.5)])
def test_gemm_tile_matches_plain_version(card, dtype, shape, alpha):
    m, k, n = shape
    g = torch.Generator(device=card).manual_seed(7)
    a = torch.randn((m, k), generator=g, device=card).to(dtype)
    b = torch.randn((k, n), generator=g, device=card).to(dtype)
    c = torch.randn((m, n), generator=g, device=card)
    before = cuda_kernels.gemm_tile_launches.value
    got = gemm_tile(a, b, c, alpha)
    torch.cuda.synchronize()
    ref = gemm_tile_reference(a, b, c, alpha)
    err = ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()
    assert err <= (1e-4 if dtype == torch.bfloat16 else 1e-5)
    assert cuda_kernels.gemm_tile_launches.value == before + 1
    assert got.data_ptr() != c.data_ptr()


@pytest.mark.cuda
def test_gemm_tile_rejects_what_it_does_not_take(card):
    a = torch.zeros((8, 8), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        gemm_tile(a, a, torch.zeros((8, 8), device=card))
    b = torch.zeros((8, 8), device=card)
    with pytest.raises(ValueError):
        gemm_tile(b, b, torch.zeros((8, 8)))          # C on the CPU
    with pytest.raises(ValueError):
        gemm_tile(b.t(), b, b)                          # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("panel", ["float32", "bfloat16"])
def test_gemm_under_memory_budget_on_the_card(card, panel):
    n, mb, alpha, beta = 512, 128, 2.0, 0.5
    rng = np.random.default_rng(31)
    arrays = {k: rng.standard_normal((n, n)).astype(np.float32)
              for k in "ABC"}
    mats = from_reference_arrays(arrays, {"A": Layout(mb, mb, panel),
                                          "B": Layout(mb, mb, panel),
                                          "C": Layout(mb, mb)})
    a, b = (mats[k].to_array().float() for k in "AB")    # panel-rounded
    want = gemm_tile_reference(a, b, beta * torch.from_numpy(arrays["C"]),
                               alpha)
    before = cuda_kernels.gemm_tile_launches.value
    params.set("device_mem_mb", 1)          # 48 tiles against 1 MiB
    params.set("device_inflight_depth", 2)
    try:
        with Context(nb_cores=2) as ctx:
            ctx.add_taskpool(gemm_taskpool(mats["A"], mats["B"], mats["C"],
                                           alpha=alpha, beta=beta))
            ctx.wait(timeout=300)
            stats = ctx.device_registry.accelerators[0].stats
    finally:
        params.unset("device_mem_mb")
        params.unset("device_inflight_depth")
    got = torch.from_numpy(to_reference_arrays(mats)["C"])
    err = ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()
    assert err <= (1e-4 if panel == "bfloat16" else 1e-5)
    assert cuda_kernels.gemm_tile_launches.value - before == (n // mb) ** 3
    assert stats.evictions > 0 and stats.bytes_out > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6144, 512), (100, 36), (1000, 36),
                                   (513, 257), (12288, 512), (0, 40),
                                   (7, 1)])
def test_gram_tile_matches_plain_version(card, shape):
    g = torch.Generator(device=card).manual_seed(9)
    X = torch.randn(shape, generator=g, device=card)
    before = cuda_kernels.gram_tile_launches.value
    got = gram_tile(X)
    torch.cuda.synchronize()
    ref = gram_tile_reference(X)
    err = ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item() \
        if ref.numel() else 0.0
    assert err <= 1e-5
    assert torch.equal(got, got.T)          # mirrored, not recomputed
    assert cuda_kernels.gram_tile_launches.value == before + 1


@pytest.mark.cuda
def test_gram_tile_rejects_what_it_does_not_take(card):
    with pytest.raises(TypeError):
        gram_tile(torch.zeros((8, 4), device=card, dtype=torch.bfloat16))
    X = torch.zeros((8, 4), device=card)
    with pytest.raises(ValueError):
        gram_tile(X.t())                        # not contiguous
    with pytest.raises(ValueError):
        gram_tile(torch.zeros((8, 4), device="meta"))   # another device


@pytest.mark.cuda
@pytest.mark.parametrize("panel", ["float32", "bfloat16"])
def test_qr_on_the_card_matches_the_cpu_run(card, panel):
    """mb=256, nt=3, qr_ib=128 (14 tasks): R on the card against the same
    taskpool on the CPU-backed module (plain versions).  Tolerance 1e-4
    in f32 (true-f32 arithmetic in another order) and 3e-2 in bf16 (a
    bf16 rounding flip re-enters the trailing matrix; see
    tests/test_torch_qr.py)."""
    mb, nt = 256, 3
    n = mb * nt
    rng = np.random.default_rng(41)
    a = (0.05 * rng.standard_normal((n, n))
         + np.kron(np.ones((nt, nt)), np.eye(mb))).astype(np.float32)
    outs = {}
    launches = {}
    params.set("qr_ib", 128)
    try:
        for where in ("cpu", "cuda"):
            mats = from_reference_arrays({"A": a}, Layout(mb, mb, panel))
            for c in (cuda_kernels.gemm_tile_launches,
                      cuda_kernels.gram_tile_launches):
                c.reset()
            with Context(nb_cores=2, device=where) as ctx:
                ctx.add_taskpool(qr.qr_taskpool(mats["A"]))
                ctx.wait(timeout=300)
            outs[where] = to_reference_arrays(mats)["A"]
            launches[where] = (cuda_kernels.gemm_tile_launches.value,
                               cuda_kernels.gram_tile_launches.value)
    finally:
        params.unset("qr_ib")
    # 3 UNMQR + 3 x 5 TSMQR on K1; 2 Grams x 2 blocks x 3 GEQRT on K2
    assert launches == {"cpu": (0, 0), "cuda": (18, 12)}
    got, ref = outs["cuda"], outs["cpu"]
    assert not np.tril(got, -1).any()
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= (1e-4 if panel == "float32" else 3e-2)


def _route_moved(before: dict) -> list:
    return [r for r, c in cuda_kernels.gemm_tile_route_launches.items()
            if c.value != before[r]]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,alpha,zero_c", [
    ((1000, 520, 776), -1.0, False),     # off the 128 x 256 tile grid
    ((1000, 8, 776), 0.5, False),        # K below one stage (64)
    ((1000, 16, 776), -1.0, False),
    ((40, 520, 776), 1.0, False),        # M below one warpgroup's 64 rows
    ((256, 1024, 136), 0.5, False),      # non-square: a wrong B major-ness
    ((136, 1024, 256), -1.0, False),     # would not survive both
    ((1000, 520, 776), 1.0, True)],      # zero C
    ids=["ragged", "k8", "k16", "m40", "wide-k", "tall-n", "zero-c"])
def test_gemm_tile_wgmma_route(card, shape, alpha, zero_c):
    m, k, n = shape
    g = torch.Generator(device=card).manual_seed(11)
    a = torch.randn((m, k), generator=g, device=card).bfloat16()
    b = torch.randn((k, n), generator=g, device=card).bfloat16()
    c = torch.zeros((m, n), device=card) if zero_c else \
        torch.randn((m, n), generator=g, device=card)
    before = {r: v.value for r, v in
              cuda_kernels.gemm_tile_route_launches.items()}
    got = gemm_tile(a, b, c, alpha)
    torch.cuda.synchronize()
    ref = gemm_tile_reference(a, b, c, alpha)
    err = ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()
    assert err <= 1e-4
    assert _route_moved(before) == ["wgmma"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "misaligned"])
def test_gemm_tile_wmma_route(card, case):
    """Shapes TMA cannot describe take the WMMA kernel: N and K not
    multiples of 8, or an A that is a contiguous view 2 bytes past a
    16-byte boundary."""
    g = torch.Generator(device=card).manual_seed(13)
    if case == "ragged":
        m, k, n = 1000, 513, 777
        a = torch.randn((m, k), generator=g, device=card).bfloat16()
    else:
        m, k, n = 256, 256, 264
        flat = torch.randn(m * k + 1, generator=g, device=card).bfloat16()
        a = flat[1:].view(m, k)
        assert a.is_contiguous() and a.data_ptr() % 16 == 2
    b = torch.randn((k, n), generator=g, device=card).bfloat16()
    c = torch.randn((m, n), generator=g, device=card)
    before = {r: v.value for r, v in
              cuda_kernels.gemm_tile_route_launches.items()}
    got = gemm_tile(a, b, c, -1.0)
    torch.cuda.synchronize()
    ref = gemm_tile_reference(a, b, c, -1.0)
    err = ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()
    assert err <= 1e-4
    assert _route_moved(before) == ["wmma"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6144, 512), (6145, 512), (20, 512),
                                   (0, 512), (333, 1), (333, 33)],
                         ids=["qr", "ragged-split", "under-split", "m0",
                              "n1", "n33"])
def test_gram_tile_split_k_repeats_bit_for_bit(card, shape):
    """The split plan at the QR path's shape, at M not a multiple of the
    split, at M below the split count the QR shape gets, at M = 0 and at
    narrow N; two calls on one input give the same bits (the partials are
    summed in a fixed order, no atomics)."""
    g = torch.Generator(device=card).manual_seed(17)
    X = torch.randn(shape, generator=g, device=card)
    got = gram_tile(X)
    again = gram_tile(X)
    torch.cuda.synchronize()
    ref = gram_tile_reference(X)
    err = ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item() \
        if ref.numel() else 0.0
    assert err <= 1e-5
    assert torch.equal(got, again)
    assert torch.equal(got, got.T)
    if shape[0] == 0:
        assert not got.any()


@pytest.mark.cuda
def test_gram_tile_refuses_a_short_scratch(card):
    """The C entry is told the scratch's length and refuses a plan whose
    partials would not fit it (cudaErrorInvalidValue), launching nothing."""
    m, n = 6144, 512
    X = torch.zeros((m, n), device=card)
    G = torch.empty((n, n), device=card)
    splits, rows = cuda_kernels.gram_split_plan(
        m, n, torch.cuda.get_device_properties(card).multi_processor_count)
    need = splits * cuda_kernels.gram_upper_tiles(n) \
        * cuda_kernels.GRAM_TILE ** 2
    P = torch.empty(need, device=card)
    lib = cuda_kernels._load()
    stream = torch.cuda.current_stream(card).cuda_stream
    assert lib.parsec_gram_tile_f32(X.data_ptr(), G.data_ptr(), P.data_ptr(),
                                    need - 1, m, n, splits, rows,
                                    card.index, stream) == 1
    assert lib.parsec_gram_tile_f32(X.data_ptr(), G.data_ptr(), P.data_ptr(),
                                    need, m, n, splits, rows, card.index,
                                    stream) == 0
    torch.cuda.synchronize()
    assert not G.any()
