"""Linear-algebra / mini-app drivers built on the runtime.

The analog of the reference's tests/apps and of DPLASMA's tiled drivers
(reference: tests/dsl/dtd/dtd_test_simple_gemm.c, tests/apps/stencil/,
BASELINE.md north-star configs): each app builds a parameterized taskpool
over tiled-matrix collections with CUDA incarnations and CPU bodies.
Every app of the JAX package is ported: the tiled GEMM, QR and Cholesky
(with their checks), the stencil, the ring and ring attention, the
permute wave, the trees, redistribution and pingpong.
"""

from parsec_tpu_torch.apps.gemm import gemm_taskpool  # noqa: F401
from parsec_tpu_torch.apps.qr import qr_taskpool  # noqa: F401
