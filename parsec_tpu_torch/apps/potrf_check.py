"""Numerical accounting for the tiled Cholesky (apps/potrf.py), ported from
``parsec_tpu/apps/potrf_check.py``.

Two checks the bench publishes beside the GFLOP/s number:

- ``backward_error``: the exact normwise backward error
  ||A - L L^T||_F / ||A||_F over the factored tile grid, computed tile by
  tile (one f32 product per (i, j, k) triple — n^3 flops, about three
  times the factorization, once).  A bf16-storage factor rounds every
  intermediate tile, so its backward error sits at bf16 epsilon, not f32.

- ``refine_solve``: the HPL-AI-style justification for bf16 storage.
  Solves A x = b with the factor as the preconditioner of an f32
  fixed-point refinement, x += (L L^T)^{-1} (b - A x): each step contracts
  the error by about the factor's backward error, so a bf16 factor reaches
  f32-class accuracy in a few O(n^2) steps.

Every product is f32 with TF32 off (the reference's HIGHEST), and the
triangular solves are ``torch.linalg.solve_triangular``.  Both read the
CURRENT tile payloads of a factored TiledMatrix (CUDA tensors on the
card, CPU tensors in tests) plus a caller-supplied ``orig_tile(m, n)``
regenerating the pre-factorization tile, so nothing needs a second
resident copy of A.  Vectors live on the device of ``orig_tile``'s tiles.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from parsec_tpu_torch.apps.cuda_kernels import check_f32_matmul
from parsec_tpu_torch.apps.qr_check import newest_payload


def _symm(O: torch.Tensor) -> torch.Tensor:
    """The symmetric tile a Cholesky that reads the lower triangle
    factors: the lower triangle mirrored."""
    o = O.float()
    return torch.tril(o) + torch.tril(o, -1).T


def _sqn(R: torch.Tensor) -> float:
    return float(torch.sum(R.float() ** 2))


def _l_tile(A, i: int, j: int, device=None) -> torch.Tensor:
    """Factor tile (i, j) in f32 (on ``device`` when given: a recovered
    pool's factor may hold tiles on the host beside the card's); a
    diagonal tile's upper triangle holds values the Cholesky never wrote,
    so it is cut off on use (no f32 copies are kept: at bench scale they
    would cost GBs of device memory)."""
    t = newest_payload(A, i, j).float()
    if device is not None:
        t = t.to(device)
    return torch.tril(t) if i == j else t


def backward_error(A, orig_tile: Callable[[int, int], torch.Tensor]) -> float:
    """Exact ||A - L L^T||_F / ||A||_F over the lower triangle of the
    factored tile grid (the effective symmetric A: lower tiles as
    generated, diagonal tiles symmetrized from their lower triangle)."""
    check_f32_matmul("the backward error")
    NT = A.mt
    num = 0.0
    den = 0.0
    for i in range(NT):
        for j in range(i + 1):
            O = orig_tile(i, j)
            A0 = _symm(O) if i == j else O.float()
            # an off-diagonal tile stands for its mirrored upper tile too
            w = 1.0 if i == j else 2.0
            den += w * _sqn(A0)
            R = A0
            for kk in range(j + 1):
                R = R - _l_tile(A, i, kk, R.device) \
                    @ _l_tile(A, j, kk, R.device).T
            num += w * _sqn(R)
    return float(np.sqrt(num) / max(np.sqrt(den), 1e-300))


def _trsv(L: torch.Tensor, b: torch.Tensor, trans: bool) -> torch.Tensor:
    """Solve L z = b (or L^T z = b) for lower-triangular L."""
    M = L.T if trans else L
    return torch.linalg.solve_triangular(M, b[:, None],
                                         upper=trans)[:, 0]


def _solve_factored(A, b_blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    """x = (L L^T)^{-1} b by tiled forward and backward substitution in
    f32 (a triangular solve per diagonal tile, matvec updates: O(n^2))."""
    NT = A.mt
    # forward: L y = b
    y: List[torch.Tensor] = []
    for i in range(NT):
        rhs = b_blocks[i].float()
        for j in range(i):
            rhs = rhs - newest_payload(A, i, j).float() @ y[j]
        y.append(_trsv(_l_tile(A, i, i), rhs, trans=False))
    # backward: L^T x = y
    x: List[torch.Tensor] = [None] * NT
    for i in range(NT - 1, -1, -1):
        rhs = y[i]
        for j in range(i + 1, NT):
            rhs = rhs - newest_payload(A, j, i).float().T @ x[j]
        x[i] = _trsv(_l_tile(A, i, i), rhs, trans=True)
    return x


def _matvec(orig_tile, NT: int,
            x_blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    """y = A_eff @ x with the effective symmetric A regenerated tile by
    tile (lower tiles, symmetrized diagonal, mirrored upper)."""
    y = [torch.zeros_like(x_blocks[0], dtype=torch.float32)
         for _ in range(NT)]
    for i in range(NT):
        for j in range(i + 1):
            O = orig_tile(i, j)
            if i == j:
                y[i] = y[i] + _symm(O) @ x_blocks[i]
            else:
                Of = O.float()
                y[i] = y[i] + Of @ x_blocks[j]
                y[j] = y[j] + Of.T @ x_blocks[i]
    return y


def _norm(blocks: List[torch.Tensor]) -> float:
    return float(np.sqrt(sum(_sqn(b) for b in blocks)))


def refine_solve(A, orig_tile: Callable[[int, int], torch.Tensor],
                 steps: int = 3, seed: int = 0) -> List[float]:
    """Solve A x = b with the factored tiles as preconditioner and
    ``steps`` rounds of f32 iterative refinement; b is drawn from
    ``numpy.random.default_rng(seed)``, as the reference draws it.
    Returns the normwise relative residuals ||b - A x||_2 / ||b||_2, one
    per iterate (entry 0 = the direct solve with the factor)."""
    check_f32_matmul("the refinement solve")
    NT, mb = A.mt, A.mb
    dev = orig_tile(0, 0).device
    rng = np.random.default_rng(seed)
    b = [torch.from_numpy(rng.standard_normal(mb).astype(np.float32))
         .to(dev) for _ in range(NT)]
    bn = _norm(b)
    x = _solve_factored(A, b)
    hist = []
    for it in range(steps + 1):
        ax = _matvec(orig_tile, NT, x)
        r = [bb - aa for bb, aa in zip(b, ax)]
        hist.append(_norm(r) / max(bn, 1e-300))
        if it == steps:
            break        # the last residual is recorded; a further
            # solve and update would never be observed
        dx = _solve_factored(A, r)
        x = [xx + dd for xx, dd in zip(x, dx)]
    return hist
