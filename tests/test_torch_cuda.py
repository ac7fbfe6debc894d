"""Hand-written kernels of the port against their plain versions, on the
card.  Marked ``cuda``: each test skips without a CUDA device.  This file
imports neither JAX nor the JAX package, so it also runs where neither is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance, as max|kernel - plain| / max(1, max|plain|): 1e-4 with bf16
inputs and 1e-5 with f32 inputs (products are exact in f32 in both cases;
only the order of the f32 summation differs).

K1's transposed-B variant writes a bf16 C: kernel and plain version each
round an f32 sum once, so each element may also land one bf16 ulp apart.

K1's grouped launch must give the bits of single launches member by
member, and its in-place form (``out=C``) the bits of the out-of-place
call, on every route.

The tiled GEMM also runs here through the runtime under a 1 MiB device
copy-cache budget, so that tiles are evicted and written back to the host
between launches on the card; the tiled QR and the tiled Cholesky run on
the card against the same runs on the CPU-backed device module.  K1's
tiles are counted as single launches plus grouped members: the device
module fuses waves at its defaults.

A JobService on the card serves one job of each catalog app (GEMM,
potrf, stencil); f32 operands send K1 to its fma route.

The remaining apps run on the card too: ring attention (both masks)
against the float64 dense reference at the JAX package's test tolerance
(rtol 2e-4, atol 2e-5), a recursive potrf whose inner pool runs on the
card (K1 on its fma route, CHECK reading the committed factor), and the
permute wave against ``expected_wave_result``.

Fault tolerance on the card: a 2-rank potrf whose rank 1 is killed mid-run
completes on rank 0 (adopted tiles remade on the card) within the 2-rank
limits, a collection whose tiles live on the card round-trips through
checkpoint and restore bit for bit, and the recovery drain keeps a queued
in-place K1 launch of the torn generation off restored bytes.  A rank
goes down and rejoins, and a 2-rank DTD GEMM whose rank 1 is killed
recovers on rank 0 through the skip agreement, C bit for bit K1's chain.
"""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.apps import cuda_kernels, potrf, qr
from parsec_tpu_torch.apps.cuda_kernels import gemm_tile, \
    gemm_tile_grouped, gemm_tile_reference, gram_tile, gram_tile_reference
from parsec_tpu_torch.apps.gemm import gemm_taskpool
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.carry import (Layout, from_reference_arrays,
                                         to_reference_arrays)
from parsec_tpu_torch.utils.mca import params


def _k1_tiles() -> int:
    """K1 tiles computed so far: single launches plus grouped members."""
    return cuda_kernels.gemm_tile_launches.value + \
        cuda_kernels.gemm_tile_grouped_members.value


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
    before = _k1_tiles()
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
    assert _k1_tiles() - before == (n // mb) ** 3
    assert stats.evictions > 0 and stats.bytes_out > 0


@pytest.mark.cuda
def test_dtd_gemm_on_the_card_matches_ptg_bit_for_bit(card):
    """The tiled GEMM through DTD insert_task on the card at 2048^3 tiles
    (bf16 A and B, f32 C; 2 x 2 x 2 tiles): every task on K1's wgmma
    route, C bit-identical to the PTG GEMM's on the same tiles (the same
    K1 chain over k) and within 1e-3 of the plain product."""
    from parsec_tpu_torch.apps.gemm import gemm_dtd_insert
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    mb, t = 2048, 2
    g = torch.Generator(device=card).manual_seed(41)
    full = {k: torch.randn((t * mb, t * mb), generator=g, device=card)
            for k in "ABC"}
    out = {}
    for front in ("dtd", "ptg"):
        mats = {k: TwoDimBlockCyclic(mb, mb, t * mb, t * mb, dtype=dt,
                                     name=k).from_array(
                                         full[k].to(dt).cpu())
                for k, dt in (("A", torch.bfloat16), ("B", torch.bfloat16),
                              ("C", torch.float32))}
        before = cuda_kernels.gemm_tile_route_launches["wgmma"].value + \
            cuda_kernels.gemm_tile_grouped_members.value
        with Context(nb_cores=2) as ctx:
            if front == "dtd":
                tp = DTDTaskpool("gemm")
                ctx.add_taskpool(tp)
                assert gemm_dtd_insert(tp, *mats.values()) == t ** 3
                tp.wait(timeout=300)
            else:
                ctx.add_taskpool(gemm_taskpool(*mats.values()))
            ctx.wait(timeout=300)
            assert ctx.device_registry.accelerators[0].stats.faults == 0
        wgmma = cuda_kernels.gemm_tile_route_launches["wgmma"].value + \
            cuda_kernels.gemm_tile_grouped_members.value - before
        assert wgmma == t ** 3
        out[front] = mats["C"].to_array()
    assert torch.equal(out["dtd"], out["ptg"])
    a, b = (full[k].to(torch.bfloat16).float().cpu() for k in "AB")
    want = gemm_tile_reference(a, b, full["C"].cpu(), 1.0)
    err = ((out["dtd"] - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-3


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
                      cuda_kernels.gemm_tile_grouped_members,
                      cuda_kernels.gram_tile_launches):
                c.reset()
            with Context(nb_cores=2, device=where) as ctx:
                ctx.add_taskpool(qr.qr_taskpool(mats["A"]))
                ctx.wait(timeout=300)
            outs[where] = to_reference_arrays(mats)["A"]
            launches[where] = (_k1_tiles(),
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


def _err(got, ref):
    """max|got - ref| / max(1, max|ref|), each element's difference less
    one bf16 ulp of ref when the output is bf16."""
    d = (got.float() - ref.float()).abs()
    if ref.dtype == torch.bfloat16:
        _, e = torch.frexp(ref.float())
        d = (d - torch.ldexp(torch.ones_like(d), e - 8)).clamp(min=0.0)
    return (d.max() / ref.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset,route", [
    ((512, 512, 512), torch.bfloat16, 0, "wgmma"),
    ((1000, 520, 778), torch.bfloat16, 0, "wgmma"),   # ragged, n % 8 != 0
    ((1000, 8, 776), torch.bfloat16, 0, "wgmma"),     # K below one stage
    ((256, 1024, 136), torch.bfloat16, 0, "wgmma"),   # non-square: a wrong
    ((136, 1024, 256), torch.bfloat16, 0, "wgmma"),   # B major-ness fails
    ((40, 520, 6), torch.bfloat16, 0, "wgmma"),       # one pair of columns
    ((1000, 520, 777), torch.bfloat16, 0, "wmma"),    # n odd
    ((1000, 513, 778), torch.bfloat16, 0, "wmma"),    # k % 8 != 0
    ((256, 256, 264), torch.bfloat16, 2, "wmma"),     # A misaligned
    ((1000, 513, 777), torch.float32, 0, "fma"),
    ((256, 256, 256), torch.float32, 0, "fma"),
    ((2048, 2048, 2048), torch.float32, 0, "fma")],   # served potrf jobs
    ids=["aligned", "ragged", "k8", "wide-k", "tall-n", "n6", "n-odd",
         "k-odd", "a-misaligned", "f32-ragged", "f32", "f32-2048"])
def test_gemm_tile_trans_b_on_every_route(card, shape, dtype, offset, route):
    """``C - A @ B^T`` with B given as (n, k) and C in the operands' type
    (bf16: read and written in bf16), against its plain version, on the
    route the shape and the pointers pick."""
    m, k, n = shape
    g = torch.Generator(device=card).manual_seed(19)
    flat = torch.randn(m * k + offset, generator=g, device=card).to(dtype)
    a = flat[offset:].view(m, k)
    assert a.is_contiguous() and a.data_ptr() % 16 == 2 * offset
    b = torch.randn((n, k), generator=g, device=card).to(dtype)
    c = torch.randn((m, n), generator=g, device=card).to(dtype)
    before = {r: v.value for r, v in
              cuda_kernels.gemm_tile_route_launches.items()}
    got = gemm_tile(a, b, c, -1.0, trans_b=True)
    torch.cuda.synchronize()
    ref = gemm_tile_reference(a, b, c, -1.0, trans_b=True)
    assert got.dtype == dtype
    assert _err(got, ref) <= (1e-4 if dtype == torch.bfloat16 else 1e-5)
    assert _route_moved(before) == [route]


@pytest.mark.cuda
def test_gemm_tile_trans_b_rejects_what_it_does_not_take(card):
    bf = torch.zeros((8, 8), device=card, dtype=torch.bfloat16)
    f = torch.zeros((8, 8), device=card)
    with pytest.raises(TypeError):
        gemm_tile(bf, bf, f, -1.0, trans_b=True)       # f32 C with B^T
    with pytest.raises(TypeError):
        gemm_tile(bf, bf, bf, -1.0)                     # bf16 C without
    with pytest.raises(ValueError):
        gemm_tile(bf, torch.zeros((8, 16), device=card,
                                  dtype=torch.bfloat16), bf, trans_b=True)


@pytest.mark.cuda
@pytest.mark.parametrize("panel", ["float32", "bfloat16"])
def test_potrf_on_the_card_matches_the_cpu_run(card, panel):
    """mb=256, nt=3 (7 tasks): the factor on the card against the same
    taskpool on the CPU-backed module (plain versions).  SYRK and GEMM are
    4 K1 launches, on ``wgmma`` with bf16 tiles and ``fma`` with f32.
    Tolerance 1e-4 in f32 (true f32 in another order) and 2e-2 in bf16 (a
    bf16 rounding flip re-enters the trailing matrix)."""
    mb, nt = 256, 3
    n = mb * nt
    rng = np.random.default_rng(43)
    B = rng.standard_normal((n, n)).astype(np.float32)
    a = (B @ B.T + n * np.eye(n)).astype(np.float32)
    outs, routes = {}, {}
    for where in ("cpu", "cuda"):
        mats = from_reference_arrays({"A": a}, Layout(mb, mb, panel))
        before = {r: v.value for r, v in
                  cuda_kernels.gemm_tile_route_launches.items()}
        grouped0 = cuda_kernels.gemm_tile_grouped_members.value
        with Context(nb_cores=2, device=where) as ctx:
            tp = potrf.potrf_taskpool(mats["A"])
            ctx.add_taskpool(tp)
            ctx.wait(timeout=300)
        assert not tp.cholesky_check.failed()
        outs[where] = np.tril(to_reference_arrays(mats)["A"])
        routes[where] = {r: v.value - before[r] for r, v in
                         cuda_kernels.gemm_tile_route_launches.items()
                         if v.value != before[r]}
        # grouped launches all take the wgmma route
        grouped = cuda_kernels.gemm_tile_grouped_members.value - grouped0
        if grouped:
            routes[where]["wgmma"] = routes[where].get("wgmma", 0) + grouped
    assert routes == {"cpu": {}, "cuda": {
        "wgmma" if panel == "bfloat16" else "fma": 4}}
    got, ref = outs["cuda"], outs["cpu"]
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= (1e-4 if panel == "float32" else 2e-2)


@pytest.mark.cuda
def test_two_rank_potrf_on_the_card_matches_one_rank(card):
    """Two ranks (spawned, each its own CUDA context on this card) run
    potrf at mb=256, nt=4 in bf16 over the comm layer: every lower tile
    within 2e-2 of the single-rank run on the card, the per-class task
    counts summed over the ranks equal to the single-rank run's, the K1
    tiles (SYRK and GEMM: 10) all launched, and the remote tiles staged
    in from the host."""
    import torch_comm_workers as W
    from parsec_tpu_torch.comm.launch import run_distributed
    nt, mb = 4, 256
    torch.cuda.empty_cache()
    res = run_distributed(W.dist_potrf, 2,
                          args=("port", nt, mb, 2, "bf16"),
                          device="cuda", timeout=600)
    k1_0 = _k1_tiles()
    a = W.spd(nt * mb)
    mats = from_reference_arrays({"A": a}, Layout(mb, mb, "bfloat16"))
    with Context(nb_cores=2, device="cuda") as ctx:
        tp = potrf.potrf_taskpool(mats["A"])
        ctx.add_taskpool(tp)
        ctx.wait(timeout=300)
    assert not tp.cholesky_check.failed()
    ref = to_reference_arrays(mats)["A"]
    assert _k1_tiles() - k1_0 == 10
    got = W.merged(res, "tiles")
    for key, tile in got.items():
        m, k = map(int, key.split(","))
        r = ref[m * mb:(m + 1) * mb, k * mb:(k + 1) * mb]
        g, r = (np.tril(x) if m == k else x for x in (tile, r))
        assert np.abs(g - r).max() / max(1.0, np.abs(r).max()) <= 2e-2, key
    assert len(got) == nt * (nt + 1) // 2
    done = {}
    for r in res:
        assert not r["failed"] and r["staged_in"] > 0
        for c, v in r["done"].items():
            done[c] = done.get(c, 0) + v
    assert done == {"POTRF": nt - 1, "POTRFL": 1, "TRSM": 6, "SYRK": 6,
                    "GEMM": 4}
    assert sum(r["k1_tiles"] for r in res) == 10


def _operands(card, m, k, n, dtype, trans_b, seed, offset=0):
    """A (with ``offset`` elements before it in its storage), B and C of
    one call: B as (n, k) with ``trans_b``, C in the operands' type with
    it (the types K1 takes)."""
    g = torch.Generator(device=card).manual_seed(seed)
    flat = torch.randn(m * k + offset, generator=g, device=card).to(dtype)
    a = flat[offset:].view(m, k)
    b = torch.randn((n, k) if trans_b else (k, n), generator=g,
                    device=card).to(dtype)
    c = torch.randn((m, n), generator=g, device=card)
    return a, b, c.to(dtype) if trans_b else c


GROUP_SHAPES = {"2048": ((2048, 2048, 2048), False),
                "1024-trans": ((1024, 1024, 1024), True),
                "ragged": ((1000, 520, 776), False),
                "ragged-trans": ((1000, 520, 778), True)}


@pytest.mark.cuda
@pytest.mark.parametrize("members", [1, 2, 3, 8])
@pytest.mark.parametrize("case", list(GROUP_SHAPES))
def test_gemm_tile_grouped_matches_single_launches(card, members, case):
    """n equal-shape calls in one grouped wgmma launch: each member
    bit-identical to its single launch (the same tiles, summed in the same
    order) and within tolerance of the plain version, out of place and
    into C; one grouped launch counted with n members (n = 1: a single
    launch)."""
    (m, k, n), trans_b = GROUP_SHAPES[case]
    ops = [_operands(card, m, k, n, torch.bfloat16, trans_b, 23 + i)
           for i in range(members)]
    As, Bs, Cs = (list(x) for x in zip(*ops))
    singles = [gemm_tile(a, b, c, -1.0, trans_b) for a, b, c in ops]
    launches0 = cuda_kernels.gemm_tile_grouped_launches.value
    members0 = cuda_kernels.gemm_tile_grouped_members.value
    got = gemm_tile_grouped(As, Bs, Cs, -1.0, trans_b)
    torch.cuda.synchronize()
    grouped = 1 if members > 1 else 0
    assert cuda_kernels.gemm_tile_grouped_launches.value - launches0 == \
        grouped
    assert cuda_kernels.gemm_tile_grouped_members.value - members0 == \
        members * grouped
    refs = [gemm_tile_reference(a, b, c, -1.0, trans_b) for a, b, c in ops]
    for g, s1, r in zip(got, singles, refs):
        assert torch.equal(g, s1)
        assert _err(g, r) <= 1e-4
    outs = [c.clone() for c in Cs]
    inplace = gemm_tile_grouped(As, Bs, outs, -1.0, trans_b, out=outs)
    torch.cuda.synchronize()
    for o, i, s1 in zip(outs, inplace, singles):
        assert i is o and torch.equal(o, s1)


@pytest.mark.cuda
def test_gemm_tile_grouped_with_a_member_off_the_wgmma_route(card):
    """One member TMA cannot describe (an A 2 bytes past a 16-byte
    boundary): the group runs as single launches on each member's own
    route, and no grouped launch is counted."""
    ops = [_operands(card, 256, 256, 264, torch.bfloat16, False, 29),
           _operands(card, 256, 256, 264, torch.bfloat16, False, 30,
                     offset=1)]
    before = {r: v.value for r, v in
              cuda_kernels.gemm_tile_route_launches.items()}
    launches0 = cuda_kernels.gemm_tile_grouped_launches.value
    got = gemm_tile_grouped(*(list(x) for x in zip(*ops)), 0.5)
    torch.cuda.synchronize()
    assert cuda_kernels.gemm_tile_grouped_launches.value == launches0
    moved = {r: v.value - before[r] for r, v in
             cuda_kernels.gemm_tile_route_launches.items()}
    assert moved == {"wgmma": 1, "wmma": 1, "fma": 0}
    for g, (a, b, c) in zip(got, ops):
        assert _err(g, gemm_tile_reference(a, b, c, 0.5)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,trans_b,offset,route", [
    ((1000, 520, 776), torch.bfloat16, False, 0, "wgmma"),
    ((1000, 520, 778), torch.bfloat16, True, 0, "wgmma"),
    ((1000, 513, 777), torch.bfloat16, False, 0, "wmma"),
    ((256, 256, 264), torch.bfloat16, True, 1, "wmma"),
    ((1000, 513, 777), torch.float32, False, 0, "fma"),
    ((1000, 513, 777), torch.float32, True, 0, "fma"),
    ((2048, 2048, 2048), torch.float32, False, 0, "fma")],
    ids=["wgmma", "wgmma-trans", "wmma", "wmma-trans", "fma", "fma-trans",
         "fma-2048"])
def test_gemm_tile_in_place_is_bit_identical(card, shape, dtype, trans_b,
                                             offset, route):
    """``out=C`` writes O into C's storage, allocates nothing and gives
    the out-of-place call's bits, on every route (each element of C is
    read and then written by one thread alone)."""
    m, k, n = shape
    a, b, c = _operands(card, m, k, n, dtype, trans_b, 31, offset)
    want = gemm_tile(a, b, c, -1.0, trans_b)
    c2 = c.clone()
    ptr = c2.data_ptr()
    before = {r: v.value for r, v in
              cuda_kernels.gemm_tile_route_launches.items()}
    got = gemm_tile(a, b, c2, -1.0, trans_b, out=c2)
    torch.cuda.synchronize()
    assert got is c2 and c2.data_ptr() == ptr
    assert torch.equal(c2, want)
    assert _route_moved(before) == [route]


@pytest.mark.cuda
def test_gemm_tile_out_must_not_overlap_an_operand(card):
    a, b, c = _operands(card, 64, 64, 64, torch.bfloat16, True, 37)
    with pytest.raises(ValueError):
        gemm_tile(a, b, c, -1.0, True, out=a)
    with pytest.raises(ValueError):
        gemm_tile(a, b, c, -1.0, True, out=b)


@pytest.mark.cuda
def test_gemm_tile_fma_route_at_the_served_shape(card):
    """The served GEMM jobs' tiles: f32 operands at 2048^3 take the fma
    route, within 1e-5 of the plain version."""
    g = torch.Generator(device=card).manual_seed(17)
    A = torch.randn((2048, 2048), generator=g, device=card)
    B = torch.randn((2048, 2048), generator=g, device=card)
    C = torch.randn((2048, 2048), generator=g, device=card)
    fma0 = cuda_kernels.gemm_tile_route_launches["fma"].value
    got = gemm_tile(A, B, C, 1.0)
    torch.cuda.synchronize()
    assert cuda_kernels.gemm_tile_route_launches["fma"].value == fma0 + 1
    ref = gemm_tile_reference(A, B, C, 1.0)
    err = ((got - ref).abs().max() / ref.abs().max().clamp(min=1.0)).item()
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True], ids=["B", "B^T"])
@pytest.mark.parametrize("shape,alpha,offset", [
    ((1000, 520, 776), -1.0, 0),   # M, N off the 128 x 128 tiles: vector
    ((130, 12, 260), 1.0, 0),      # K not a multiple of the 8-deep slab
    ((64, 0, 64), 1.0, 0),         # K = 0: O = C
    ((77, 3, 95), 2.0, 0),         # K < 4 and N % 4 != 0: scalar
    ((1000, 513, 777), -1.0, 0),   # K % 4 != 0: scalar
    ((256, 256, 258), 0.5, 0),     # N % 4 != 0: scalar
    ((256, 256, 256), -1.0, 1),    # A misaligned by one float: scalar
    ((5, 4, 4), 1.0, 0)],          # one thread's sub-tile
    ids=["ragged", "k12", "k0", "k3", "k-odd", "n-odd", "a-misaligned",
         "tiny"])
def test_gemm_tile_fma_route_vector_and_scalar(card, shape, alpha, offset,
                                               trans_b):
    """K1's fma route at the edges of its 128 x 128 tiles, 8-deep slabs
    and float4 rows, in both layouts: within 1e-5 of the plain version,
    on the fma route, bit-identical when repeated and in place."""
    m, k, n = shape
    a, b, c = _operands(card, m, k, n, torch.float32, trans_b, 41, offset)
    before = {r: v.value for r, v in
              cuda_kernels.gemm_tile_route_launches.items()}
    got = gemm_tile(a, b, c, alpha, trans_b)
    again = gemm_tile(a, b, c, alpha, trans_b)
    c2 = c.clone()
    gemm_tile(a, b, c2, alpha, trans_b, out=c2)
    torch.cuda.synchronize()
    assert _route_moved(before) == ["fma"]
    assert _err(got, gemm_tile_reference(a, b, c, alpha, trans_b)) <= 1e-5
    assert torch.equal(got, again)
    assert torch.equal(c2, got)


@pytest.mark.cuda
def test_job_service_serves_each_app_on_the_card(card):
    """A JobService on the card serves one job of each catalog app, each
    held to its own check (GEMM 1e-3 of the plain product, potrf within
    the JAX package's test tolerance 1e-4, stencil 1e-5 of the float64
    reference), and the GEMM and potrf jobs launch K1 on the fma route."""
    from parsec_tpu_torch.service import JobService
    from parsec_tpu_torch.service.server import APPS
    fma0 = cuda_kernels.gemm_tile_route_launches["fma"].value
    with JobService(nb_cores=4, max_active=3) as svc:
        assert all(d.is_cuda for d in
                   svc.context.device_registry.accelerators)
        jobs = {app: svc.submit(APPS[app](p), name=app) for app, p in (
            ("gemm", {"n": 1024, "nb": 256, "seed": 1}),
            ("potrf", {"n": 1024, "nb": 256, "seed": 2}),
            ("stencil", {"n": 1 << 16, "nb": 1 << 13, "steps": 12,
                         "fuse": 4, "seed": 3}))}
        res = {app: j.result(timeout=300.0) for app, j in jobs.items()}
    assert res["gemm"]["rel_err"] <= 1e-3
    assert res["potrf"]["residual"] < 1e-4
    assert res["stencil"]["max_err"] <= 1e-5
    # 64 GEMM tiles plus the potrf's 10 SYRK/GEMM updates, all f32
    assert cuda_kernels.gemm_tile_route_launches["fma"].value - fma0 == 74


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_the_card(card, causal):
    """P = 4 parties of Tq = Tkv = 256, d = 128, f32 (TF32 off): every
    output row within rtol 2e-4, atol 2e-5 of the float64 dense
    reference; the ring's 16 visits all ran on the card, no kernel of
    csrc/ among them."""
    from parsec_tpu_torch.apps import ring_attention as ra
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    assert not torch.backends.cuda.matmul.allow_tf32
    P, T, d = 4, 256, 128
    gen = torch.Generator(device=card).manual_seed(17)
    Q, K, V = (torch.randn((P * T, d), generator=gen, device=card)
               for _ in range(3))
    KV = TwoDimBlockCyclic(2 * T, d, 2 * P * T, d, name="KV")
    ACC = TwoDimBlockCyclic(T, 2 * d + 2, P * T, 2 * d + 2, name="ACC")
    with Context(nb_cores=4) as ctx:
        dev = ctx.device_registry.accelerators[0]
        for q in range(P):
            rows = slice(q * T, (q + 1) * T)
            KV.place_on_device(q, 0, dev, ra.pack_kv(K[rows], V[rows]))
            ACC.place_on_device(q, 0, dev, ra.pack_query(Q[rows]))
        k1 = _k1_tiles()
        ctx.add_taskpool(ra.ring_attention_taskpool(KV, ACC, causal=causal))
        ctx.wait(timeout=120)
        assert dev.stats.executed_tasks == P * P
        assert _k1_tiles() == k1
        got = torch.cat([ra.unpack_output(
            ACC.data_of(q, 0).pull_to_host().payload, d)
            for q in range(P)]).to(card, torch.float64)
    want = ra.dense_reference(Q.double(), K.double(), V.double(),
                              causal=causal)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
def test_recursive_potrf_on_the_card(card):
    """One n = 1024 f32 tile factored by an inner potrf over 256
    subtiles on the card: max|LL' - A| / max|A| < 1e-4 in float64, the
    inner pool's 10 SYRK/GEMM updates on K1's fma route, and CHECK reads
    the committed factor (commit pulls the inner tiles home)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    with Context(nb_cores=4) as ctx:
        # the driver sets the kernel counts to 0 before its passes
        res = chip_smoke.drive_recursive_potrf(
            ctx, 1024, 256, passes=1,
            gen=torch.Generator(device=card).manual_seed(3),
            label="cuda test")
    assert res["residual"] < 1e-4
    # two passes (warm, timed) of 10 SYRK/GEMM updates, all on fma
    assert res["k1_fma"] == res["launches"]["gemm_tile"] == 20


@pytest.mark.cuda
def test_permute_wave_on_the_card(card):
    """P = 8 parties of (256, 256) f32 on the card: every W(q) equals
    ``expected_wave_result`` exactly, P and C on the card, GATE on the
    host."""
    from parsec_tpu_torch.apps import wave
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    P, n = 8, 256
    V = TwoDimBlockCyclic(n, n, P * n, n, name="V")
    W = TwoDimBlockCyclic(n, n, P * n, n, name="W")
    wave.fill_wave_inputs(V, W)
    with Context(nb_cores=4) as ctx:
        ctx.add_taskpool(wave.permute_wave_taskpool(V, W))
        ctx.wait(timeout=60)
        assert ctx.device_registry.accelerators[0].stats.executed_tasks \
            == 2 * P
    for q in range(P):
        got = W.data_of(q, 0).pull_to_host().payload
        assert torch.all(got == wave.expected_wave_result(P, q))


def _chip_smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


@pytest.mark.cuda
def test_two_rank_potrf_recovers_a_killed_rank_on_the_card(card):
    """The fault-tolerance path at mb=512, nt=6 (bf16, two ranks on this
    card, the pass stretched by 300 ms activation-frame delays so the
    kill lands inside it): rank 1 killed, rank 0 recovers — one recovery
    started, none failed, adopted tiles remade on the card — and its
    factor is within 1e-2 of the single-rank run's, backward error
    within 5e-2, K1 launched by the survivor."""
    import pathlib
    import sys
    chip_smoke = _chip_smoke()
    refs = {}
    with Context(nb_cores=4) as ctx:
        chip_smoke.drive_potrf(ctx, 512, 6, torch.bfloat16, passes=1,
                               label="cuda test", keep=refs)
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)   # the spawned ranks import chip_smoke
    try:
        out = chip_smoke.phase_recovery(
            refs, nofault_s=2.0, size=(512, 6), setup_s=6.0, kill_at=1.0,
            extra_plan="delay_frame=tag:ACT,p=1,ms=300")
    finally:
        sys.path.remove(root)
    assert out["recovery"]["started"] == 1
    assert out["recovery"]["failed"] == 0
    assert out["recovery"]["restored_tiles"]["init"] > 0
    assert out["worst_rel_fro"] <= 1e-2
    assert out["backward_error"] <= 5e-2
    assert out["launches"]["gemm_tile"] + \
        out["launches"]["gemm_tile_grouped"] > 0


@pytest.mark.cuda
def test_checkpoint_round_trip_of_a_device_resident_collection(card):
    """C of a GEMM pass, its tiles the card's, through checkpoint (flushed
    home) and restore into a fresh collection: bit for bit; the DOT of the
    pass holds its 64 task nodes and 48 edges; K1 ran every tile."""
    chip_smoke = _chip_smoke()
    with Context(nb_cores=4) as ctx:
        res = chip_smoke.drive_checkpoint_grapher(ctx, 512, 4, "cuda test")
    assert res["bit_identical"]
    assert (res["dot_nodes"], res["dot_edges"]) == (64, 48)
    assert res["launches"]["gemm_tile"] + \
        res["launches"]["gemm_tile_grouped"] > 0


@pytest.mark.cuda
def test_stale_k1_launch_never_lands_on_restored_bytes(card):
    """The recovery drain on the card: a K1 ``out=C`` launch queued at the
    epoch bump is completed through the fence without launching, the one
    already in the manager finishes before the restore, and nothing lands
    on the restored bytes afterwards (K1's counter moves once)."""
    from test_torch_recovery_plane import stale_launch_case
    stale_launch_case("cuda", 256,
                      on_launch=lambda: _k1_tiles())


@pytest.mark.cuda
def test_two_rank_dtd_gemm_recovers_a_killed_rank_on_the_card(card):
    """The rejoin and DTD-recovery legs at mb=512, 8 x 8 x 8 (two ranks on
    this card over shm; rank 1's restarted incarnation stalls each
    dispatch 50 ms so the kill lands inside the DTD pass): rank 1 rejoins
    and serves pass B, then dies in the DTD GEMM; rank 0 recovers it, C
    within 1e-3 of the plain-version product and bit for bit K1's chain,
    K1 launched by the survivor."""
    import pathlib
    import sys
    chip_smoke = _chip_smoke()
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)   # the spawned ranks import chip_smoke
    try:
        out = chip_smoke.phase_rejoin_dtd(
            dtd_nofault_s=2.0, size=(512, 8), setup_s=8.0, kill_at=0.4,
            extra_plan="delay_dispatch=ms=50")
    finally:
        sys.path.remove(root)
    assert out["dtd"]["worst_rel"] <= 1e-3
    assert out["dtd"]["bit_identical"] is True
    assert out["dtd"]["recovery"]["tasks_reexecuted"] > 0
    assert out["launches"]["gemm_tile"] + \
        out["launches"]["gemm_tile_grouped"] > 0


@pytest.mark.cuda
def test_killed_rank_rejoins_and_serves_on_the_card(card):
    """The rejoin leg alone at mb=512 over evloop: rank 1's engine goes
    down and comes back as incarnation 1, rank 0 counts one rejoin and
    its JobService heals, both GEMM passes check on the card."""
    import os
    import pathlib
    import sys
    from parsec_tpu_torch.comm import run_distributed
    chip_smoke = _chip_smoke()
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    os.environ["PARSEC_MCA_RECOVERY_ENABLE"] = "1"
    sys.path.insert(0, root)
    try:
        res = run_distributed(chip_smoke.rejoin_rank, 2, args=(512, 8),
                              device="cuda", timeout=300)
    finally:
        sys.path.remove(root)
        os.environ.pop("PARSEC_MCA_RECOVERY_ENABLE", None)
    assert res[0]["rejoin"]["rejoins"] == 1 and res[0]["rejoin"]["dead"] == []
    assert res[1]["rejoin"]["epoch"] == 1
    assert not res[0]["service"]["degraded"]
    assert ("healthy", "rejoin") in \
        [tuple(x) for x in res[0]["service"]["transitions"]]
    for r in res:
        assert r["pass_a"]["worst_rel"] <= 1e-3
        assert r["pass_b"]["worst_rel"] <= 1e-3
    assert sum(r["rejoin_launches"]["gemm_tile"] +
               r["rejoin_launches"]["gemm_tile_grouped"] for r in res) > 0


# -- several device modules on one card (device="cuda*N") ------------------


@pytest.mark.cuda
def test_cuda_n_layout_gives_each_module_a_stream_and_a_budget(card):
    """``cuda*4``: four modules over card 0, named cuda:0/i, each with a
    launch stream of its own (not the default stream) and a quarter of
    the card's free memory as its budget, with the ICI engine attached;
    ``cuda`` keeps one module on the default stream, no budget, no
    engine."""
    free = torch.cuda.mem_get_info(0)[0]
    with Context(nb_cores=2, device="cuda*4") as ctx:
        mods = ctx.device_registry.accelerators
        assert [m.name for m in mods] == [f"cuda:0/{i}" for i in range(4)]
        streams = {m.stream.cuda_stream for m in mods}
        assert len(streams) == 4
        assert torch.cuda.default_stream(0).cuda_stream not in streams
        for m in mods:
            assert 0 < m._capacity <= free // 4 * 1.05
        assert ctx.ici is not None and ctx.ici.mesh() == list(mods)
    with Context(nb_cores=2, device="cuda") as ctx:
        (m,) = ctx.device_registry.accelerators
        assert m.name == "cuda:0" and m._capacity is None
        assert m.stream == torch.cuda.default_stream(0)
        assert ctx.ici is None


@pytest.mark.cuda
def test_ici_put_is_ordered_after_the_producing_stream(card):
    """A put from module 0 to module 1 reads the value module 0's stream
    writes after a long spin, not what the tensor held when the put was
    issued; a host read of module 1's copy sees it too."""
    from parsec_tpu_torch.data.data import to_host
    with Context(nb_cores=2, device="cuda*2") as ctx:
        m0, m1 = ctx.device_registry.accelerators
        with torch.cuda.stream(m0.stream):
            x = torch.zeros(1 << 20, device=card)
            torch.cuda._sleep(100_000_000)
            x.fill_(7.0)
        out = ctx.ici.put(x, m1.space, m0.space)
        assert out.data_ptr() != x.data_ptr()
        assert bool(torch.all(to_host(out) == 7.0))
        assert ctx.ici.stats.puts == 1


@pytest.mark.cuda
def test_host_read_waits_for_every_module_stream(card):
    """A tile written on a module's stream after a long spin reads back
    right through ``pull_to_host`` (the host read fence)."""
    from parsec_tpu_torch.data.data import new_data
    with Context(nb_cores=2, device="cuda*2") as ctx:
        m1 = ctx.device_registry.accelerators[1]
        datum = new_data(torch.zeros(1 << 20))
        with torch.cuda.stream(m1.stream):
            y = torch.zeros(1 << 20, device=card)
            torch.cuda._sleep(100_000_000)
            y.fill_(3.0)
        datum.overwrite_on(m1.space, y)
        assert bool(torch.all(datum.pull_to_host().payload == 3.0))


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda", "cuda*4"])
def test_gemm_over_modules_on_the_card(card, device):
    """The tiled GEMM with panel broadcasts over four modules of the card
    (C spread over them) against the plain product, every task on K1,
    the engine's broadcasts fired; on one module the same pool runs with
    no engine and the same tasks and launches."""
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    mb, nt = 256, 4
    n = mb * nt
    g = torch.Generator().manual_seed(15)
    a = torch.randn((n, n), generator=g).bfloat16()
    b = torch.randn((n, n), generator=g).bfloat16()
    A = TwoDimBlockCyclic(mb, mb, n, n, dtype=torch.bfloat16,
                          name="A").from_array(a)
    B = TwoDimBlockCyclic(mb, mb, n, n, dtype=torch.bfloat16,
                          name="B").from_array(b)
    C = TwoDimBlockCyclic(mb, mb, n, n, name="C").from_array(
        torch.zeros((n, n)))
    tiles0 = _k1_tiles()
    with Context(nb_cores=4, device=device) as ctx:
        C.distribute_devices(ctx)
        ctx.add_taskpool(gemm_taskpool(A, B, C, panel_bcast=True))
        ctx.wait(timeout=120)
        executed = sum(m.stats.executed_tasks
                       for m in ctx.device_registry.accelerators)
        bcasts = ctx.ici.stats.bcasts if ctx.ici is not None else None
        assert (ctx.ici is None) == (device == "cuda")
    assert executed == nt ** 3 and _k1_tiles() - tiles0 == nt ** 3
    if device != "cuda":
        assert bcasts > 0
    want = a.float() @ b.float()
    err = float((C.to_array() - want).abs().max()) / float(
        want.abs().max())
    assert err < 1e-3
