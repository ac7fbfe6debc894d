"""Pieces of the tiled Cholesky driver that other apps already need.

Only :func:`tri_inv` is here so far, the lower-triangular inverse of the
JAX package's ``parsec_tpu/apps/potrf.py`` that the QR panel construction
(apps/qr.py) uses; the POTRF/TRSM/SYRK/GEMM task classes come with the
potrf slice.

The inverse is pure matrix products, as in the reference, whose design
notes give the reason: a triangular solve runs far below the matmul rate
on an accelerator.  Every product is a float32 ``torch.matmul`` with TF32
off wherever the reference passes ``precision=HIGHEST`` (the QR driver
checks that TF32 is off when it builds a taskpool).
"""

from __future__ import annotations

import math

import torch

#: recursive-inversion leaf: below this order the Newton iteration runs
#: directly (log2(leaf) + 1 products of leaf x leaf)
_INV_LEAF = 512


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Lower-triangular inverse as pure matrix products.

    Recursive 2x2 block inversion
        [[L11, 0], [L21, L22]]^-1 =
        [[X11, 0], [-X22 @ L21 @ X11, X22]]
    with Newton--Schulz leaves: X <- X(2I - LX) starting from
    X0 = diag(L)^-1 converges EXACTLY in ceil(log2(n)) steps because the
    initial residual I - LX0 is strictly triangular (nilpotent) and each
    step squares it.
    """
    n = L.shape[0]
    if n <= _INV_LEAF:
        X = torch.diag(1.0 / torch.diagonal(L))
        two_i = 2.0 * torch.eye(n, dtype=L.dtype, device=L.device)
        for _ in range(int(math.ceil(math.log2(max(n, 2)))) + 1):
            X = X @ (two_i - L @ X)
        return X
    h = n // 2
    X11 = tri_inv(L[:h, :h])
    X22 = tri_inv(L[h:, h:])
    X21 = -(X22 @ (L[h:, :h] @ X11))
    top = torch.cat([X11, L.new_zeros((h, n - h))], dim=1)
    return torch.cat([top, torch.cat([X21, X22], dim=1)], dim=0)
