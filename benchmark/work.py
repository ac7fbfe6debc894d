"""Useful work: flops of a whole problem, tasks of each class a pass, and
the flops and bytes of one task of each class that K1 implements.

Keyed by problem and task class, so a metric reads the same work whatever
kernel runs a class.  Bytes count each input tile read once and each output
tile written once; flops count what the inputs need (a Cholesky SYRK task
needs the lower half of its product and the diagonal: mb^2 (mb + 1), not
the 2 mb^3 of the full product K1 computes).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple


def potrf_flops(n: int) -> float:
    """Useful flops of an n x n Cholesky factorization (n^3 / 3)."""
    return n ** 3 / 3.0


def gemm_flops(m: int, n: int, k: int) -> float:
    """Useful flops of C += A @ B with A m x k, B k x n (2 m n k)."""
    return 2.0 * m * n * k


def potrf_class_counts(nt: int) -> Dict[str, int]:
    """Tasks of each class in one tiled Cholesky of nt x nt tiles."""
    return {"POTRF": nt - 1, "POTRFL": 1,
            "TRSM": nt * (nt - 1) // 2,
            "SYRK": nt * (nt - 1) // 2,
            "GEMM": nt * (nt - 1) * (nt - 2) // 6}


def gemm_class_counts(mt: int, nt: int, kt: int) -> Dict[str, int]:
    """Tasks of each class in one tiled product of mt x kt by kt x nt."""
    return {"GEMM": mt * nt * kt}


def _potrf_syrk(mb: int, store: int, _c: int) -> Tuple[float, float]:
    # T -= R R^T on a diagonal tile: reads R and T, writes T
    return float(mb * mb * (mb + 1)), 3.0 * mb * mb * store


def _potrf_gemm(mb: int, store: int, _c: int) -> Tuple[float, float]:
    # C -= L R^T: reads L, R and C, writes C
    return 2.0 * mb ** 3, 4.0 * mb * mb * store


def _gemm_gemm(mb: int, ab: int, c: int) -> Tuple[float, float]:
    # C += A B: reads A, B and C, writes C
    return 2.0 * mb ** 3, mb * mb * (2.0 * ab + 2.0 * c)


#: (flops, bytes) of one task of the classes K1 implements, by problem and
#: class: f(tile, bytes of an A/B or stored element, bytes of a C element)
K1_TASK_WORK: Dict[str, Dict[str, Callable[[int, int, int],
                                           Tuple[float, float]]]] = {
    "potrf": {"SYRK": _potrf_syrk, "GEMM": _potrf_gemm},
    "gemm": {"GEMM": _gemm_gemm},
}


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes: float) -> Tuple[float, str]:
    """The least time the card needs for this work, and what bounds it."""
    t_ops, t_mem = flops / peak_flops, nbytes / peak_bytes
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
