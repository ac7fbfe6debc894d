"""Tiled GEMM driver: C = alpha*A@B + beta*C as a parameterized task graph.

The flagship throughput app, mirroring the reference's DTD GEMM perf
harness (reference: tests/dsl/dtd/dtd_test_simple_gemm.c — GFLOPS =
2*M*N*K/t, :659-666) but expressed as a PTG: one GEMM(m, n, k) task per
(C tile, k panel), chained over k so each C tile flows through its own
accumulation pipeline while independent (m, n) chains run concurrently.
Owner-computes: the task runs where C(m, n) lives.

The device body of every GEMM task is ``gemm_tile`` (apps/cuda_kernels.py),
the hand-written Hopper kernel: bf16 A/B panels with an f32 C give
tensor-core products with f32 accumulation.  It writes C in place when
the device module donates the tile, and a fused wave of GEMM tasks runs
as one ``gemm_tile_grouped`` launch.  The CPU body is the kernel's plain
version.
"""

from __future__ import annotations

from typing import Optional

from parsec_tpu_torch.apps.cuda_kernels import gemm_tile, \
    gemm_tile_grouped, gemm_tile_reference
from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.api import DATA, IN, OUT, PTG, Range, TASK


def _tile_kernel(alpha: float):
    """Accumulation step of the k-chain: Ci + alpha * Ai@Bi, into Ci's
    storage when donated; a wave of steps is one grouped launch.
    (beta is applied once by the SCALE task class, not per step.)"""
    def fn(Ai, Bi, Ci, *, donate=False):
        return gemm_tile(Ai, Bi, Ci, alpha, out=Ci if donate else None)

    def grouped(calls, *, donate=False):
        As, Bs, Cs = zip(*calls)
        return gemm_tile_grouped(As, Bs, Cs, alpha,
                                 out=Cs if donate else None)
    fn.grouped = grouped
    return fn


def gemm_taskpool(A: TiledMatrix, B: TiledMatrix, C: TiledMatrix,
                  alpha: float = 1.0, beta: float = 1.0,
                  device: str = "cuda",
                  panel_bcast: Optional[bool] = None
                  ) -> ParameterizedTaskpool:
    """Build the C = alpha*A@B + beta*C taskpool over tiled collections.

    A and B are bf16 or f32 and C is f32 (the kernel's two type sets);
    an f32 product is full f32 (no TF32).
    ``device``: "cuda"/"gpu" gives GEMM tasks the kernel as device body
    ahead of the CPU body; anything else leaves the CPU body only.
    ``panel_bcast``: route each A-row/B-column panel through a reader task
    whose output fans out to every consumer — the dataflow broadcast form
    that multi-rank runs need.  Default: on when the collections are
    distributed.
    """
    if A.nt != B.mt or A.mt != C.mt or B.nt != C.nt:
        raise ValueError(
            f"tile grids do not agree: A {A.mt}x{A.nt}, B {B.mt}x{B.nt}, "
            f"C {C.mt}x{C.nt}")
    mt, nt, kt = C.mt, C.nt, A.nt
    mb, nb, kb = C.mb, C.nb, A.nb
    flops_per_task = 2.0 * mb * nb * kb
    use_device = device in ("cuda", "gpu")
    kernel = _tile_kernel(alpha)
    prescale = beta != 1.0

    def cpu_body(Ai, Bi, Ci):
        return gemm_tile_reference(Ai, Bi, Ci, alpha)

    distributed = C.nodes > 1
    if panel_bcast is None:
        panel_bcast = distributed
    p = PTG("gemm", MT=mt, NT=nt, KT=kt)
    if panel_bcast:
        # Owner-computes reader tasks broadcast each A-row / B-column
        # panel to the GEMM tasks that consume it — the dataflow bcast
        # tree of the reference (remote_dep.c star/chain/binomial) and
        # the PTG form of SUMMA's panel broadcasts.  Single-rank builds
        # skip the indirection and read the collection directly.
        p.task("RA", m=Range(0, mt - 1), k=Range(0, kt - 1)) \
            .affinity(lambda m, k, A=A: A(m, k)) \
            .flow("T", "READ",
                  IN(DATA(lambda m, k, A=A: A(m, k))),
                  OUT(TASK("GEMM", "Ai",
                           lambda m, k, NT=nt: [dict(m=m, n=n, k=k)
                                                for n in range(NT)]))) \
            .body(lambda: None)
        p.task("RB", k=Range(0, kt - 1), n=Range(0, nt - 1)) \
            .affinity(lambda k, n, B=B: B(k, n)) \
            .flow("T", "READ",
                  IN(DATA(lambda k, n, B=B: B(k, n))),
                  OUT(TASK("GEMM", "Bi",
                           lambda k, n, MT=mt: [dict(m=m, n=n, k=k)
                                                for m in range(MT)]))) \
            .body(lambda: None)
    if prescale:
        # one-time beta scaling of each C tile, feeding the k=0 step
        # (the reference harness folds beta the same way: the chain
        # itself is pure accumulation)
        sb = p.task("SCALE", m=Range(0, mt - 1), n=Range(0, nt - 1)) \
            .affinity(lambda m, n, C=C: C(m, n)) \
            .flow("Ci", "RW",
                  IN(DATA(lambda m, n, C=C: C(m, n))),
                  OUT(TASK("GEMM", "Ci", lambda m, n: dict(m=m, n=n, k=0))))
        if use_device:
            sb.body(_scale_kernel(beta), device=device)
        sb.body(lambda Ci: beta * Ci)
    tb = p.task("GEMM",
                m=Range(0, mt - 1), n=Range(0, nt - 1), k=Range(0, kt - 1)) \
        .affinity(lambda m, n, C=C: C(m, n)) \
        .priority(lambda k, KT=kt: KT - k) \
        .flow("Ai", "READ",
              IN(TASK("RA", "T", lambda m, k: dict(m=m, k=k)))
              if panel_bcast else
              IN(DATA(lambda m, k, A=A: A(m, k)))) \
        .flow("Bi", "READ",
              IN(TASK("RB", "T", lambda k, n: dict(k=k, n=n)))
              if panel_bcast else
              IN(DATA(lambda k, n, B=B: B(k, n)))) \
        .flow("Ci", "RW",
              IN(TASK("SCALE", "Ci", lambda m, n: dict(m=m, n=n)),
                 when=lambda k: k == 0) if prescale else
              IN(DATA(lambda m, n, C=C: C(m, n)),
                 when=lambda k: k == 0),
              IN(TASK("GEMM", "Ci", lambda m, n, k: dict(m=m, n=n, k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("GEMM", "Ci", lambda m, n, k: dict(m=m, n=n, k=k + 1)),
                  when=lambda k, KT=kt: k < KT - 1),
              OUT(DATA(lambda m, n, C=C: C(m, n)),
                  when=lambda k, KT=kt: k == KT - 1)) \
        .property("flops", flops_per_task)
    if use_device:
        tb.body(kernel, device=device)
    tb.body(cpu_body)
    return p.build()


def _scale_kernel(beta: float):
    def fn(Ci):
        return beta * Ci
    return fn


def total_flops(m: int, n: int, k: int) -> float:
    """Useful FLOPs of C[m,n] = A[m,k]@B[k,n] (2*M*N*K)."""
    return 2.0 * m * n * k
