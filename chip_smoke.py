"""Drive the PyTorch/CUDA port (``parsec_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure propagates; the script then exits non-zero and prints
no result line):

1. card     — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build    — compile every kernel from ``parsec_tpu_torch/csrc`` with nvcc
              (one process per source, all started together);
3. kernels  — hold each kernel against its plain PyTorch version on the
              card at every shape, C and alpha the paths give it (and
              check which route K1 took), and time kernel, plain version
              and one library call at every shape the paths give it (K1:
              12288^3, 6144^3, 2048^3); K2 twice on one input must agree
              bit for bit;
4. GEMM path — the tiled GEMM at the repo's bench geometry (mb=12288,
              mt=nt=3, kt=4; A and B bf16, C f32), tiles born on the card:
              one warm pass, three timed passes, C checked against a
              tile-by-tile plain-version product, kernel launches counted;
5. small tiles — the same app at mb=2048 over 16384^2 x 16384 (512 tasks),
              where the runtime's per-task host cost shows;
6. QR path  — the tiled QR at the repo's geqrf bench geometry (mb=6144,
              nt=8, bf16 tile storage, qr_ib=512: 204 tasks a pass), tiles
              regenerated on the card before each pass: one warm pass,
              three timed passes, task, incarnation and launch counts
              checked on every pass, then R's lower tiles, the
              factorization residual and the least-squares ladder.

Every kernel count is set to 0 just before a path runs and read just
after it; every K1 launch on a path must have taken the wgmma route.
``nvidia-smi`` reads the SM clock and power draw before a path's first
pass and after its last timed one, outside the timed window.  It prints a
``{"kernels": [...]}`` line (launches summed over the paths), the card's
name and power limit, then as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails before
doing anything.  It imports nothing of JAX and nothing of ``parsec_tpu``.
"""

from __future__ import annotations

import json
import resource
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import parsec_tpu_torch
from parsec_tpu_torch.apps import cuda_kernels, qr
from parsec_tpu_torch.apps.cuda_kernels import gemm_tile, \
    gemm_tile_reference, gram_tile, gram_tile_reference
from parsec_tpu_torch.apps.gemm import gemm_taskpool, total_flops
from parsec_tpu_torch.apps.qr_check import ls_refine, newest_payload
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

SEED = 20261016

#: dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, f32 FLOP/s
#: outside the tensor cores, device-memory bytes/s
PEAKS = {
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
}

#: kernel-vs-plain tolerance on max|kernel - plain| / max(1, max|plain|):
#: bf16 products are exact in f32, so only the summation order differs
TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}

#: every kernel's launch count, by the name the kernels line gives it
COUNTERS = {"gemm_tile": cuda_kernels.gemm_tile_launches,
            "gram_tile": cuda_kernels.gram_tile_launches}
#: K1's launches by route
ROUTES = cuda_kernels.gemm_tile_route_launches

#: K1's launches per pass at each shape the paths give it, by path
K1_SHAPES = {12288: {"GEMM mb=12288": 36}, 6144: {"QR mb=6144": 448},
             2048: {"GEMM mb=2048": 512}}

#: QR path limits: the factorization residual ||R'Rz - A'Az|| / ||A'Az||
#: of a bf16-storage factor (the JAX package recorded 1.0e-2 for its own),
#: and the least-squares ladder's best relative error
QR_RESIDUAL_TOL = 3e-2
QR_LADDER_TOL = 1e-5


def reset_counts() -> None:
    for c in (*COUNTERS.values(), *ROUTES.values()):
        c.reset()


def read_counts() -> dict:
    return {name: c.value for name, c in COUNTERS.items()}


def read_routes() -> dict:
    return {name: c.value for name, c in ROUTES.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str):
    if "H100" in name and "PCIe" in name:
        key = "H100 PCIe"
    elif "H100" in name and "NVL" in name:
        key = "H100 NVL"
    else:
        key = "H100 SXM"
    return key, PEAKS[key]


def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def read_clock(label: str, when: str) -> None:
    """One ``nvidia-smi`` reading of the SM clock and power draw, taken
    outside every timed window: under a sustained load the card lowers its
    clock to hold its power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[{label}] SM clock, power draw {when}: {out}")


def time_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max()
            / ref.abs().max().clamp(min=1.0)).item()


def _library_addmm(A, B, C, alpha):
    """One PyTorch call computing C + alpha * A @ B on the same operands
    (cuBLAS).  bf16 operands with an f32 C need ``out_dtype``; the port
    never calls this."""
    if A.dtype == C.dtype:
        return torch.addmm(C, A, B, alpha=alpha), "torch.addmm"
    return torch.addmm(C, A, B, alpha=alpha, out_dtype=C.dtype), \
        "torch.addmm(out_dtype=float32)"


def k1_bound(A, B, C, bf16_peak: float, mem_rate: float):
    """Least time of one K1 call: 2mnk flop at the bf16 tensor-core peak
    against A and B read once, C read and O written once."""
    m, k = A.shape
    n = B.shape[1]
    t_ops = 2.0 * m * n * k / bf16_peak * 1e3
    t_bytes = (A.numel() * A.element_size() + B.numel() * B.element_size()
               + 2 * C.numel() * 4) / mem_rate * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def in_turns(fns: dict, reps: int, rounds: int = 3) -> dict:
    """The least device time of each ``fns`` entry over ``rounds`` rounds
    taken in turns: the card lowers its clock to hold its power limit
    under a sustained load, so one version timed after another would pay
    for the other's heat."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            got[name].append(time_ms(fn, reps=reps, warm=1))
    return {name: min(v) for name, v in got.items()}


def time_k1(A, B, C, alpha, peaks) -> dict:
    """K1, its plain version and one library call on the same operands,
    with the bound, at one shape; kernel and library in turns."""
    m, k = A.shape
    n = B.shape[1]
    reps = 5 if m >= 12288 else 20
    bound, by = k1_bound(A, B, C, peaks[0], peaks[2])
    plain_ms = time_ms(lambda: gemm_tile_reference(A, B, C, alpha),
                       reps=3)
    fns = {"kernel": lambda: gemm_tile(A, B, C, alpha)}
    try:
        _, lib_name = _library_addmm(A, B, C, alpha)
        fns["library"] = lambda: _library_addmm(A, B, C, alpha)
    except (TypeError, RuntimeError) as exc:
        lib_name = f"none ({type(exc).__name__})"
    t = in_turns(fns, reps)
    ms, lib_ms = t["kernel"], t.get("library")
    log(f"gemm_tile at {m}x{k}x{n} bf16: kernel {ms:.4f} ms "
        f"({2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} "
        f"ms, library_ms {lib_ms} ({lib_name}), bound {bound:.4f} ms ({by}),"
        f" share of bound {bound / ms:.3f}, launches per pass "
        f"{K1_SHAPES[m]}")
    return {"shape": [m, k, n], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms, "launches_per_pass": K1_SHAPES[m]}


def phase_kernels(dev: torch.device, peaks) -> dict:
    """Kernel vs plain version on the card at the shapes and C/alpha forms
    every path gives it, with the route each call took; timings at every
    shape the paths give it."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, m, k, n, dtype, alpha, C is zero, route, timed); the QR
    # path's calls at 6144^3: UNMQR and TSMQR's Z take a zero C with alpha
    # 1, TSMQR's other two a live C with alpha 1 and -1
    cases = [("main", 12288, 12288, 12288, bf16, 1.0, False, "wgmma", True),
             ("QR UNMQR/TSMQR Z", 6144, 6144, 6144, bf16, 1.0, True,
              "wgmma", False),
             ("QR TSMQR inner", 6144, 6144, 6144, bf16, 1.0, False,
              "wgmma", True),
             ("QR TSMQR C2", 6144, 6144, 6144, bf16, -1.0, False, "wgmma",
              False),
             ("GEMM mb=2048", 2048, 2048, 2048, bf16, 1.0, False, "wgmma",
              True),
             ("ragged", 1000, 520, 776, bf16, 0.5, False, "wgmma", False),
             ("ragged", 1000, 513, 777, bf16, -1.0, False, "wmma", False),
             ("ragged", 1000, 513, 777, f32, -1.0, False, "fma", False),
             ("f32", 2048, 2048, 2048, f32, 0.5, False, "fma", False)]
    entry, shapes = None, []
    for label, m, k, n, dt, alpha, zero_c, route, timed in cases:
        A = torch.randn((m, k), generator=g, device=dev).to(dt)
        B = torch.randn((k, n), generator=g, device=dev).to(dt)
        C = torch.zeros((m, n), device=dev) if zero_c else \
            torch.randn((m, n), generator=g, device=dev)
        routes0 = read_routes()
        got = gemm_tile(A, B, C, alpha)
        torch.cuda.synchronize()
        took = [r for r, v in read_routes().items() if v != routes0[r]]
        ref = gemm_tile_reference(A, B, C, alpha)
        err = rel_err(got, ref)
        max_abs = (got - ref).abs().max().item()
        ok = err <= TOL[dt] and took == [route]
        log(f"kernel vs plain {label} {m}x{k}x{n} {str(dt)[6:]} "
            f"alpha={alpha}{' zero C' if zero_c else ''}: route {took}, rel "
            f"err {err:.3e} (tol {TOL[dt]:.0e}) max abs {max_abs:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if took != [route]:
            raise AssertionError(f"gemm_tile took route {took}, expected "
                                 f"{route}")
        if not ok:
            raise AssertionError(f"gemm_tile disagrees with its plain "
                                 f"version: {err} > {TOL[dt]}")
        del got, ref
        if timed:
            shapes.append(time_k1(A, B, C, alpha, peaks))
        if label == "main":
            t = shapes[-1]
            entry = {"name": "gemm_tile", "route": "cuda",
                     "source": "parsec_tpu_torch/csrc/gemm_tile.cu",
                     "replaces": "parsec_tpu/apps/pallas_kernels.py:74",
                     "launches": 0, "max_abs_err": max_abs, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]}
        del A, B, C
        torch.cuda.empty_cache()
    entry["shapes"] = shapes
    return entry


class _Incarnations:
    """Counts, per task class, device launches handed to the device
    module (``exec_async``) and bodies run inline (``exec_end``)."""

    def __init__(self, ctx):
        self._lock = threading.Lock()
        self.counts = {}
        ctx.pins_register("exec_async", self._hit)
        ctx.pins_register("exec_end", self._hit)

    def _hit(self, es, event, task):
        key = (task.task_class.name, event)
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + 1

    def take(self):
        with self._lock:
            out, self.counts = self.counts, {}
        return out


def drive_gemm(ctx: Context, mb: int, mt: int, nt: int, kt: int,
               passes: int, gen: torch.Generator, label: str) -> dict:
    """The tiled GEMM through the runtime: tiles born on the device, one
    warm pass then ``passes`` timed passes of insert + wait; checks C,
    kernel launches, executed tasks and incarnations.  Returns numbers."""
    dev = ctx.device_registry.accelerators[0]
    on_card = dev.is_cuda
    A = TwoDimBlockCyclic(mb, mb, mt * mb, kt * mb, dtype=torch.bfloat16,
                          name="A")
    B = TwoDimBlockCyclic(mb, mb, kt * mb, nt * mb, dtype=torch.bfloat16,
                          name="B")
    C = TwoDimBlockCyclic(mb, mb, mt * mb, nt * mb, dtype=torch.float32,
                          name="C")
    t0 = time.perf_counter()
    for M in (A, B, C):
        for (m, n) in M.local_tiles():
            tile = torch.randn(M.tile_shape(m, n), generator=gen,
                               device=dev.tdev).to(M.dtype)
            M.place_on_device(m, n, dev, tile)
    c0 = {mn: C.data_of(*mn).copy_on(dev.space).payload.clone()
          for mn in C.local_tiles()}
    if on_card:
        torch.cuda.synchronize()
    log(f"[{label}] tiles born on {dev.name}: "
        f"{time.perf_counter() - t0:.2f} s")
    ntasks = mt * nt * kt
    flops = total_flops(mt * mb, nt * mb, kt * mb)
    inc = _Incarnations(ctx)
    # counts go to 0 just before the path runs and are read just after
    reset_counts()
    inc.take()
    if on_card:
        read_clock(label, "before the passes")
    times = []
    for p in range(passes + 1):
        launches0 = cuda_kernels.gemm_tile_launches.value
        wgmma0 = ROUTES["wgmma"].value
        executed0 = dev.stats.executed_tasks
        t0 = time.perf_counter()
        ctx.add_taskpool(gemm_taskpool(A, B, C))
        ctx.wait()
        dt = time.perf_counter() - t0
        launched = cuda_kernels.gemm_tile_launches.value - launches0
        wgmma = ROUTES["wgmma"].value - wgmma0
        executed = dev.stats.executed_tasks - executed0
        counts = inc.take()
        device_runs = counts.get(("GEMM", "exec_async"), 0)
        cpu_runs = counts.get(("GEMM", "exec_end"), 0)
        if executed != ntasks or device_runs != ntasks or cpu_runs != 0:
            raise AssertionError(
                f"[{label}] pass {p}: executed_tasks {executed}, device "
                f"incarnations {device_runs}, CPU incarnations {cpu_runs}; "
                f"expected {ntasks}, {ntasks}, 0")
        if on_card and (launched != ntasks or wgmma != ntasks):
            raise AssertionError(f"[{label}] pass {p}: gemm_tile launched "
                                 f"{launched} times, {wgmma} on the wgmma "
                                 f"route, expected {ntasks} and {ntasks}")
        kind = "warm" if p == 0 else "timed"
        log(f"[{label}] pass {p} ({kind}): {dt * 1e3:.1f} ms, "
            f"{flops / dt / 1e9:.1f} GFLOP/s, {launched} kernel launches "
            f"({wgmma} wgmma), {executed} device tasks, {cpu_runs} CPU "
            f"incarnations")
        if p:
            times.append(dt)
    if on_card:
        read_clock(label, "after the last timed pass")
    launches = read_counts()
    log(f"[{label}] kernel launches on this path: {launches}; K1 by route "
        f"{read_routes()}")
    # C = C0 + (passes + 1) * A @ B, against the plain version tile by tile
    worst = 0.0
    for (m, n) in C.local_tiles():
        prod = torch.zeros_like(c0[(m, n)])
        for k in range(kt):
            a = A.data_of(m, k).copy_on(dev.space).payload
            b = B.data_of(k, n).copy_on(dev.space).payload
            prod = gemm_tile_reference(a, b, prod, 1.0)
        ref = c0[(m, n)] + (passes + 1) * prod
        got = C.data_of(m, n).copy_on(dev.space).payload
        if not torch.isfinite(got).all():
            raise AssertionError(f"[{label}] C({m},{n}) is not finite")
        worst = max(worst, rel_err(got, ref))
    log(f"[{label}] C vs tile-by-tile plain product: rel err {worst:.3e} "
        f"(tol 1e-3)")
    if worst > 1e-3:
        raise AssertionError(f"[{label}] C disagrees: {worst}")
    best = min(times)
    return {"launches": launches, "best_s": best,
            "gflops": flops / best / 1e9, "ntasks": ntasks}


def phase_small_tiles(ctx: Context, gen: torch.Generator) -> dict:
    mb, t = 2048, 8
    res = drive_gemm(ctx, mb, t, t, t, passes=3, gen=gen, label="mb=2048")
    # idle share, estimated: kernel time of one tile (CUDA events) times
    # the launches of a pass, against the pass's wall time
    A = torch.randn((mb, mb), generator=gen, device="cuda").bfloat16()
    B = torch.randn((mb, mb), generator=gen, device="cuda").bfloat16()
    C = torch.randn((mb, mb), generator=gen, device="cuda")
    k_ms = time_ms(lambda: gemm_tile(A, B, C, 1.0), reps=20)
    busy = res["ntasks"] * k_ms * 1e-3 / res["best_s"]
    log(f"[mb=2048] best pass {res['best_s'] * 1e3:.1f} ms, "
        f"{res['gflops']:.1f} GFLOP/s; kernel {k_ms * 1e3:.1f} us/tile; "
        f"estimated device idle share {max(0.0, 1.0 - busy):.3f}")
    return res["launches"]


def phase_gram(dev: torch.device, peaks) -> dict:
    """gram_tile vs its plain version on the card at the QR path's shape
    and at ragged ones; timings and bound at the path's shape."""
    _, f32_peak, mem_rate = peaks
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = [("path", 6144, 512), ("ragged", 100, 36),
             ("ragged", 1000, 36), ("ragged", 513, 257),
             ("ragged", 6145, 512), ("narrow", 333, 1), ("narrow", 333, 33),
             ("tall", 12288, 512)]
    entry = None
    for label, m, n in cases:
        X = torch.randn((m, n), generator=g, device=dev)
        got = gram_tile(X)
        torch.cuda.synchronize()
        ref = gram_tile_reference(X)
        err = rel_err(got, ref)
        max_abs = (got - ref).abs().max().item()
        ok = err <= TOL[torch.float32]
        log(f"gram_tile vs plain {label} {m}x{n}: rel err {err:.3e} "
            f"(tol {TOL[torch.float32]:.0e}) max abs {max_abs:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"gram_tile disagrees with its plain "
                                 f"version: {err} > {TOL[torch.float32]}")
        if label == "path":
            again = gram_tile(X)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("gram_tile: two calls on one input "
                                     "differ")
            log(f"gram_tile at {m}x{n}: two calls bit-identical; split plan "
                f"(splits, rows) "
                f"{cuda_kernels.gram_split_plan(m, n, sm_count(dev))}")
            del again
            # least work: the upper triangle, m*n*(n+1) flop; X read and
            # G written once
            flops = float(m) * n * (n + 1)
            nbytes = 4.0 * (m * n + n * n)
            t_ops = flops / f32_peak * 1e3
            t_bytes = nbytes / mem_rate * 1e3
            bound = max(t_ops, t_bytes)
            torch.backends.cuda.matmul.allow_tf32 = False
            t = in_turns({"kernel": lambda: gram_tile(X),
                          "plain": lambda: gram_tile_reference(X),
                          "library": lambda: torch.mm(X.T, X)}, reps=200)
            ms, plain_ms, lib_ms = t["kernel"], t["plain"], t["library"]
            log(f"gram_tile at {m}x{n} f32: kernel {ms:.4f} ms "
                f"({2 * flops / ms / 1e9:.2f} TFLOP/s counted as 2mn^2), "
                f"plain {plain_ms:.4f} ms, library_ms {lib_ms:.4f} "
                f"(torch.mm(X.T, X), TF32 off), bound {bound:.4f} ms "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
                f"share of bound {bound / ms:.3f}; kernel / library "
                f"{ms / lib_ms:.3f}")
            entry = {"name": "gram_tile", "route": "cuda",
                     "source": "parsec_tpu_torch/csrc/gram_tile.cu",
                     "replaces": "parsec_tpu/apps/pallas_kernels.py:169",
                     "launches": 0, "max_abs_err": max_abs, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes",
                     "library_ms": lib_ms}
        del X, got, ref
    return entry


def qr_tile_maker(A: TwoDimBlockCyclic, tdev: torch.device, seed: int,
                  conditioned: bool = False):
    """The QR operand, tile by tile, each tile from its own seeded
    generator and rounded to the storage dtype — so it regenerates exactly
    without a second resident copy.

    The geqrf bench operand (``conditioned=False``): 0.05 * N(0, 1) + I in
    every tile.  Its identity blocks make it near-singular at scale
    (cond 1e3 already at n = 96), so the least-squares ladder, which
    contracts only while cond^2 * eps_bf16 < 1, diverges on its bf16
    factor — in the JAX package too.  The conditioned operand I +
    (0.25 / sqrt(n)) * N(0, 1) keeps every singular value in [0.5, 1.5],
    where the ladder's contract holds."""
    n = A.lm
    scale = 0.25 / n ** 0.5 if conditioned else 0.05

    def tile(m: int, k: int) -> torch.Tensor:
        g = torch.Generator(device=tdev).manual_seed(seed + m * A.nt + k)
        t = scale * torch.randn(A.tile_shape(m, k), generator=g, device=tdev)
        if m == k or not conditioned:
            t.diagonal().add_(1.0)
        return t.to(A.dtype)
    return tile


def qr_residual(A: TwoDimBlockCyclic, orig) -> float:
    """Stochastic factorization check without Q: an orthogonal QR has
    R^T R = A^T A, so compare the two quadratic forms on a random probe
    (O(n^2) matvecs, tile-streamed; R from A's tiles, the operand
    regenerated)."""
    nt, mb = A.mt, A.mb
    dev = orig(0, 0).device
    rng = np.random.default_rng(123)
    z = [torch.from_numpy(rng.standard_normal(mb).astype(np.float32))
         .to(dev) for _ in range(nt)]
    w = [torch.zeros(mb, device=dev) for _ in range(nt)]
    v = [torch.zeros(mb, device=dev) for _ in range(nt)]
    tiles = A.local_tiles()
    for m, n in tiles:
        w[m] += orig(m, n).float() @ z[n]
        if m <= n:
            v[m] += newest_payload(A, m, n).float() @ z[n]
    y1 = [torch.zeros(mb, device=dev) for _ in range(nt)]
    y2 = [torch.zeros(mb, device=dev) for _ in range(nt)]
    for m, n in tiles:
        y2[n] += orig(m, n).float().T @ w[m]
        if m <= n:
            y1[n] += newest_payload(A, m, n).float().T @ v[m]
    num = float(torch.sqrt(sum(torch.sum((a - b) ** 2)
                               for a, b in zip(y1, y2))))
    den = float(torch.sqrt(sum(torch.sum(b ** 2) for b in y2)))
    return num / den


def qr_task_counts(nt: int) -> dict:
    panel = nt * (nt - 1) // 2
    return {"GEQRT": nt, "UNMQR": panel, "TSQRT": panel,
            "TSMQR": sum((nt - 1 - k) ** 2 for k in range(nt))}


def drive_qr(ctx: Context, mb: int, nt: int, dtype: torch.dtype,
             passes: int, label: str, ladder_steps: int = 4) -> dict:
    """The tiled QR through the runtime at the ``qr_ib`` in force: the
    bench operand regenerated on the device before every pass (outside
    the timed window), one warm pass then ``passes`` timed passes of
    insert + wait, tasks, incarnations and kernel launches checked on
    every pass; then R's lower tiles and the factorization residual.  One
    more pass factors the conditioned operand, on which the least-squares
    ladder is held to its limit (the bench operand's ladder is printed: it
    cannot converge, see ``qr_tile_maker``).  Returns numbers."""
    dev = ctx.device_registry.accelerators[0]
    on_card = dev.is_cuda
    n = nt * mb
    A = TwoDimBlockCyclic(mb, mb, n, n, dtype=dtype, name="A")
    want = qr_task_counts(nt)
    ntasks = sum(want.values())
    ib = qr.effective_ib(mb)
    blocks = mb // ib if ib else 1
    want_launches = {"gemm_tile": want["UNMQR"] + 3 * want["TSMQR"],
                     "gram_tile": 2 * blocks * want["GEQRT"]}
    flops = qr.geqrf_flops(n, n)
    inc = _Incarnations(ctx)

    def factor(orig, what: str) -> float:
        """Regenerate A from ``orig``, factor it once, check the counts;
        returns the pass's wall time (insert + wait + synchronize)."""
        t0 = time.perf_counter()
        for (m, k) in A.local_tiles():
            A.place_on_device(m, k, dev, orig(m, k))
        if on_card:
            torch.cuda.synchronize()
        regen_s = time.perf_counter() - t0
        launches0 = read_counts()
        wgmma0 = ROUTES["wgmma"].value
        executed0 = dev.stats.executed_tasks
        falls0 = qr.qr_guard_fallbacks.value
        t0 = time.perf_counter()
        ctx.add_taskpool(qr.qr_taskpool(A))
        ctx.wait()
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = {k: v - launches0[k] for k, v in read_counts().items()}
        wgmma = ROUTES["wgmma"].value - wgmma0
        executed = dev.stats.executed_tasks - executed0
        counts = inc.take()
        device_runs = {c: counts.get((c, "exec_async"), 0) for c in want}
        cpu_runs = sum(counts.get((c, "exec_end"), 0) for c in want)
        if executed != ntasks or device_runs != want or cpu_runs:
            raise AssertionError(
                f"[{label}] {what}: executed_tasks {executed}, device "
                f"incarnations {device_runs}, CPU incarnations {cpu_runs}; "
                f"expected {ntasks}, {want}, 0")
        if on_card and (launched != want_launches
                        or wgmma != want_launches["gemm_tile"]):
            raise AssertionError(f"[{label}] {what}: launched {launched}, "
                                 f"{wgmma} K1 on the wgmma route, expected "
                                 f"{want_launches}, all K1 on wgmma")
        log(f"[{label}] {what}: {dt * 1e3:.1f} ms, "
            f"{flops / dt / 1e9:.1f} GFLOP/s, launches {launched} ({wgmma} "
            f"K1 wgmma), "
            f"{executed} device tasks {device_runs}, {cpu_runs} CPU "
            f"incarnations, guard fallbacks "
            f"{qr.qr_guard_fallbacks.value - falls0}; tiles regenerated "
            f"in {regen_s * 1e3:.1f} ms (untimed)")
        return dt

    def lower_tiles_zero() -> None:
        nonzero = [(m, k) for (m, k) in A.local_tiles() if m > k
                   and bool(newest_payload(A, m, k).any())]
        if nonzero:
            raise AssertionError(f"[{label}] tiles below the diagonal are "
                                 f"not zero: {nonzero}")

    log(f"[{label}] mb={mb} nt={nt} n={n} {str(dtype)[6:]} storage, "
        f"qr_ib={ib}: {ntasks} tasks a pass {want}, {flops:.4e} flop")
    bench = qr_tile_maker(A, dev.tdev, SEED + 3)
    conditioned = qr_tile_maker(A, dev.tdev, SEED + 4, conditioned=True)
    # counts go to 0 just before the path runs and are read just after
    reset_counts()
    inc.take()
    fallbacks0 = qr.qr_guard_fallbacks.value
    if on_card:
        read_clock(label, "before the passes")
    times = [factor(bench, f"pass {p} ({'timed' if p else 'warm'})")
             for p in range(passes + 1)][1:]
    if on_card:
        read_clock(label, "after the last timed pass")

    t0 = time.perf_counter()
    lower_tiles_zero()
    residual = qr_residual(A, bench)
    bench_ladder = ls_refine(A, bench, steps=ladder_steps)
    log(f"[{label}] bench operand: lower tiles zero; factorization "
        f"residual ||R'Rz-A'Az||/||A'Az|| = {residual:.3e} (limit "
        f"{QR_RESIDUAL_TOL:.0e}); LS-refine errors, held to no limit (the "
        f"operand is too ill-conditioned for the ladder, see "
        f"qr_tile_maker): "
        f"{['%.3e' % h for h in bench_ladder]}; checks took "
        f"{time.perf_counter() - t0:.1f} s")
    if not residual <= QR_RESIDUAL_TOL:
        raise AssertionError(f"[{label}] residual {residual} > "
                             f"{QR_RESIDUAL_TOL}")

    factor(conditioned, "ladder pass (conditioned operand, untimed)")
    lower_tiles_zero()
    cond_residual = qr_residual(A, conditioned)
    ladder = ls_refine(A, conditioned, steps=ladder_steps)
    log(f"[{label}] conditioned operand: lower tiles zero; factorization "
        f"residual {cond_residual:.3e}; LS-refine errors (CSNE direct, "
        f"then one refinement step each): {['%.3e' % h for h in ladder]} "
        f"(limit {QR_LADDER_TOL:.0e})")
    if not cond_residual <= QR_RESIDUAL_TOL:
        raise AssertionError(f"[{label}] conditioned residual "
                             f"{cond_residual} > {QR_RESIDUAL_TOL}")
    if not min(ladder) <= QR_LADDER_TOL:
        raise AssertionError(f"[{label}] LS ladder {ladder} never reached "
                             f"{QR_LADDER_TOL}")
    launches = read_counts()
    fallbacks = qr.qr_guard_fallbacks.value - fallbacks0
    log(f"[{label}] kernel launches on this path: {launches}; K1 by route "
        f"{read_routes()}; guard fallbacks {fallbacks}")
    best = min(times)
    return {"launches": launches, "best_s": best,
            "gflops": flops / best / 1e9, "ntasks": ntasks,
            "fallbacks": fallbacks, "residual": residual,
            "bench_ladder": bench_ladder, "ladder": ladder}


def qr_class_times(dev: torch.device, mb: int, ib: int,
                   dtype: torch.dtype) -> dict:
    """Device time of one body of each QR task class at the path's shapes
    (CUDA events, mean of 3 calls after a warm one), on the bench
    operand's tiles: the breakdown of a pass, outside any path run."""
    tile = qr_tile_maker(TwoDimBlockCyclic(mb, mb, 2 * mb, 2 * mb,
                                           dtype=dtype), dev, SEED + 5)
    T, B, C1, C2 = tile(0, 0), tile(1, 0), tile(0, 1), tile(1, 1)
    q1 = torch.zeros((mb, mb), dtype=dtype, device=dev)
    q2 = torch.zeros((2 * mb, mb), dtype=dtype, device=dev)
    geqrt, tsqrt = qr._mk_geqrt(ib), qr._mk_tsqrt(ib)
    unmqr, tsmqr = qr._mk_unmqr(), qr._mk_tsmqr()
    out = geqrt(T, q1)
    R, Q1 = out["T"], out["Q"]
    Q2 = tsqrt(R, B, q2)["Q"]
    return {"GEQRT": time_ms(lambda: geqrt(T, q1), reps=3),
            "UNMQR": time_ms(lambda: unmqr(Q1, C1), reps=3),
            "TSQRT": time_ms(lambda: tsqrt(R, B, q2), reps=3),
            "TSMQR": time_ms(lambda: tsmqr(Q2, C1, C2), reps=3)}


def phase_qr(ctx: Context) -> dict:
    mb, nt = 6144, 8
    ib = qr.effective_ib(mb)        # the registered qr_ib, 512
    torch.cuda.reset_peak_memory_stats()
    res = drive_qr(ctx, mb, nt, torch.bfloat16, passes=3,
                   label="QR path mb=6144")
    log(f"[QR path mb=6144] best pass {res['best_s'] * 1e3:.1f} ms, "
        f"{res['gflops']:.1f} GFLOP/s (geqrf_flops(n, n) / best pass); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; peak host RSS of the process so far "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
        f" GiB")
    # where the time goes, estimated: one body of each class timed alone,
    # times the class's tasks in a pass, against the best pass
    ms = qr_class_times(torch.device("cuda", 0), mb, ib, torch.bfloat16)
    counts = qr_task_counts(nt)
    busy = sum(ms[c] * counts[c] for c in counts) * 1e-3
    log("[QR path mb=6144] device ms per task: "
        + ", ".join(f"{c} {ms[c]:.2f} x {counts[c]} = "
                    f"{ms[c] * counts[c]:.0f}" for c in counts)
        + f"; sum {busy * 1e3:.0f} ms against the best pass "
        f"{res['best_s'] * 1e3:.0f} ms: estimated device idle share "
        f"{max(0.0, 1.0 - busy / res['best_s']):.3f}")
    return res["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    key, peaks = peaks_for(name)
    log(f"card: {smi}")
    log(f"torch.cuda: {name}, {torch.cuda.device_count()} device(s); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"parsec_tpu_torch {parsec_tpu_torch.__version__}; "
        f"bound from the {key} peaks")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    path = cuda_kernels.build(verbose=True)
    log(f"build: {path.name} from {len(cuda_kernels.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_kernels.last_build_seconds:.1f} s)")

    entries = {"gemm_tile": phase_kernels(dev, peaks),
               "gram_tile": phase_gram(dev, peaks)}
    torch.cuda.empty_cache()

    per_path = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    with Context(nb_cores=4) as ctx:
        res = drive_gemm(ctx, 12288, 3, 3, 4, passes=3, gen=gen,
                         label="GEMM path mb=12288")
        per_path["GEMM mb=12288"] = res["launches"]
        log(f"[GEMM path mb=12288] best pass {res['best_s'] * 1e3:.1f} ms, "
            f"{res['gflops']:.1f} GFLOP/s")
    torch.cuda.empty_cache()
    with Context(nb_cores=4) as ctx:
        per_path["GEMM mb=2048"] = phase_small_tiles(ctx, gen)
    torch.cuda.empty_cache()
    with Context(nb_cores=4) as ctx:
        per_path["QR mb=6144"] = phase_qr(ctx)
    torch.cuda.empty_cache()

    for path_name, launches in per_path.items():
        log(f"launches on path {path_name}: {launches}")
    for kname, entry in entries.items():
        entry["launches"] = sum(l[kname] for l in per_path.values())
        if entry["launches"] <= 0:
            raise AssertionError(f"{kname} was never launched on a path")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card "
        f"check")
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
