"""Numerical accounting for the tiled QR (apps/qr.py): the mp-QR accuracy
ladder, ported from ``parsec_tpu/apps/qr_check.py``.

The factorization residual (||R^T R z - A^T A z|| / ||A^T A z||) bounds
how good the FACTOR is: bf16 tile storage rounds R to ~bf16 epsilon.  What
justifies low-precision storage is that the factor is a fine
PRECONDITIONER and the accuracy is recovered where it is consumed.
``ls_refine`` solves A x = b through the corrected semi-normal equations
(CSNE; Björck's refinement for QR factors): with R from the
factorization,

    x_0     = R^{-1} R^{-T} (A^T b)
    r_k     = b - A x_k;   d_k = R^{-1} R^{-T} (A^T r_k);   x_{k+1} += d_k

every product in f32 with TF32 off and the triangular solves on R's tile
grid (vector right-hand side — O(n^2) per step).

Operates on the CURRENT tile payloads of a factored TiledMatrix (R in the
upper block triangle; CUDA tensors on the card, CPU tensors in tests)
plus a caller-supplied ``orig_tile(m, n)`` regenerating the
pre-factorization tile — nothing here needs a second resident copy.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from parsec_tpu_torch.apps.qr import check_f32_matmul


def newest_payload(A, m, n) -> torch.Tensor:
    """Current newest payload of tile (m, n), wherever it lives."""
    d = A.data_of(m, n)
    v = d.newest_version()
    for _sp, c in d.copies().items():
        if c.version == v and c.payload is not None:
            return c.payload
    return d.pull_to_host().payload


def _r_tile(A, i, j) -> torch.Tensor:
    t = newest_payload(A, i, j).float()
    return torch.triu(t) if i == j else t


def _trsv(R: torch.Tensor, b: torch.Tensor, trans: bool) -> torch.Tensor:
    """Solve R z = b (or R^T z = b) for upper-triangular R."""
    M = R.T if trans else R
    return torch.linalg.solve_triangular(M, b[:, None],
                                         upper=not trans)[:, 0]


def _matvec(orig_tile, NT, x):
    """y = A @ x with A regenerated tile-wise."""
    y = [torch.zeros_like(x[0]) for _ in range(NT)]
    for i in range(NT):
        for j in range(NT):
            y[i] = y[i] + orig_tile(i, j).float() @ x[j]
    return y


def _matvec_t(orig_tile, NT, x):
    """y = A^T @ x with A regenerated tile-wise."""
    y = [torch.zeros_like(x[0]) for _ in range(NT)]
    for i in range(NT):
        for j in range(NT):
            y[j] = y[j] + orig_tile(i, j).float().T @ x[i]
    return y


def _rtr_solve(A, b):
    """z = R^{-1} R^{-T} b over the upper-block-triangular tile grid
    (tiled forward then backward substitution in f32)."""
    NT = A.mt
    # forward: R^T y = b  (R^T[i][j] = R[j][i]^T, j <= i)
    y: List[torch.Tensor] = []
    for i in range(NT):
        rhs = b[i]
        for j in range(i):
            rhs = rhs - _r_tile(A, j, i).T @ y[j]
        y.append(_trsv(_r_tile(A, i, i), rhs, trans=True))
    # backward: R x = y
    x: List[torch.Tensor] = [None] * NT
    for i in range(NT - 1, -1, -1):
        rhs = y[i]
        for j in range(i + 1, NT):
            rhs = rhs - _r_tile(A, i, j) @ x[j]
        x[i] = _trsv(_r_tile(A, i, i), rhs, trans=False)
    return x


def ls_refine(A, orig_tile: Callable[[int, int], torch.Tensor],
              steps: int = 3, seed: int = 0) -> List[float]:
    """The mp-QR accuracy ladder: solve A x = b (b = A x_true for a
    deterministic random x_true, so the truth is known without storing
    Q) through CSNE with the factored R as preconditioner and ``steps``
    refinement rounds.  Returns the per-iterate relative error history
    ||x_k - x_true||_2 / ||x_true||_2 (entry 0 = the direct CSNE solve).
    Vectors live on the device of ``orig_tile``'s tiles."""
    check_f32_matmul()
    NT, mb = A.mt, A.mb
    dev = orig_tile(0, 0).device
    rng = np.random.default_rng(seed)
    x_true = [torch.from_numpy(rng.standard_normal(mb).astype(np.float32))
              .to(dev) for _ in range(NT)]
    tn = float(np.sqrt(sum(float(torch.sum(t ** 2)) for t in x_true)))
    b = _matvec(orig_tile, NT, x_true)
    x = _rtr_solve(A, _matvec_t(orig_tile, NT, b))
    hist = []
    for it in range(steps + 1):
        en = float(np.sqrt(sum(float(torch.sum((xx - tt) ** 2))
                               for xx, tt in zip(x, x_true))))
        hist.append(en / max(tn, 1e-300))
        if it == steps:
            break
        ax = _matvec(orig_tile, NT, x)
        r = [bb - aa for bb, aa in zip(b, ax)]
        d = _rtr_solve(A, _matvec_t(orig_tile, NT, r))
        x = [xx + dd for xx, dd in zip(x, d)]
    return hist
