"""Does the GEMM leg's rate depend on its operands' values?  On one CUDA card.

    python3 gemm_operand_ab.py [ROUNDS]

The bench entry's GEMM leg (``python -m parsec_tpu_torch.bench``) multiplies
the JAX package's iota tiles ((x * 1e-5 + seed * 1e-3) mod 1, bf16), where
``chip_smoke.py``'s GEMM path multiplies Gaussian ones; the two read apart
at the same shape.  This script takes both in turns (iota, Gaussian,
Gaussian, iota per round), on the same card in one process:

1. K1 alone at 12288^3 (bf16 A and B, f32 C), 100 launches timed with CUDA
   events, with the SM clock and power draw read right after;
2. the GEMM leg itself (``bench.run_gemm_bench``: mb=12288, 3x3x4, a warm
   pass, two drain passes, best of three), its tiles made by
   ``bench.prestage`` with ``rand_scale`` 0 (iota) or 1 (Gaussian).

Prints one JSON line per measurement and a summary line; exits non-zero
without a card.
"""

import functools
import json
import sys
import types

import torch

from parsec_tpu_torch import bench
from parsec_tpu_torch.apps import cuda_kernels

MB = 12288


def operands(kind: str, dev: torch.device):
    """A, B (bf16) and C (f32) tiles of one K1 call: iota or Gaussian."""
    if kind == "iota":
        return tuple(bench.tile_generator(
            types.SimpleNamespace(mb=MB, nb=MB, dtype=dt), dev)(seed, 0.0)
            for seed, dt in ((0.0, torch.bfloat16), (1.0, torch.bfloat16),
                             (2.0, torch.float32)))
    g = torch.Generator(device=dev).manual_seed(7)
    return (torch.randn((MB, MB), generator=g, device=dev).bfloat16(),
            torch.randn((MB, MB), generator=g, device=dev).bfloat16(),
            torch.randn((MB, MB), generator=g, device=dev))


def k1_ms(a, b, c, reps: int = 100) -> float:
    cuda_kernels.gemm_tile(a, b, c, 1.0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        cuda_kernels.gemm_tile(a, b, c, 1.0)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def leg_gflops(kind: str, peak: float) -> float:
    stage = bench.prestage
    if kind == "gauss":
        bench.prestage = functools.partial(stage, rand_scale=1.0)
    try:
        return bench.run_gemm_bench(MB, 3, 3, 4, reps=3,
                                    ab_dtype=torch.bfloat16,
                                    peak_gflops=peak)
    finally:
        bench.prestage = stage


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_operand_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    from parsec_tpu_torch.utils.mca import params
    params.set("device", "cuda")
    cuda_kernels.build()
    dev = torch.device("cuda", 0)
    peak = bench.peak_gflops(True)
    print(bench.card_smi(), flush=True)
    got = {"k1": {"iota": [], "gauss": []}, "leg": {"iota": [], "gauss": []}}
    for r in range(rounds):
        for kind in ("iota", "gauss", "gauss", "iota"):
            a, b, c = operands(kind, dev)
            ms = k1_ms(a, b, c)
            clock = bench.sm_clock()
            del a, b, c
            torch.cuda.empty_cache()
            got["k1"][kind].append(ms)
            print(json.dumps({"round": r, "what": "K1 12288^3", "operands":
                              kind, "ms": ms, "clock_power": clock}),
                  flush=True)
        for kind in ("iota", "gauss", "gauss", "iota"):
            gf = leg_gflops(kind, peak)
            clock = bench.sm_clock()
            torch.cuda.empty_cache()
            got["leg"][kind].append(gf)
            print(json.dumps({"round": r, "what": "GEMM leg mb=12288",
                              "operands": kind, "gflops": gf,
                              "clock_power": clock}), flush=True)
    print(json.dumps({"k1_ms": {k: [min(v), max(v)]
                                for k, v in got["k1"].items()},
                      "leg_gflops": {k: [min(v), max(v)]
                                     for k, v in got["leg"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
