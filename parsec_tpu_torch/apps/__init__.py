"""Linear-algebra / mini-app drivers built on the runtime.

The analog of the reference's tests/apps and of DPLASMA's tiled drivers
(reference: tests/dsl/dtd/dtd_test_simple_gemm.c, tests/apps/stencil/,
BASELINE.md north-star configs): each app builds a parameterized taskpool
over tiled-matrix collections with CUDA incarnations and CPU bodies.
The tiled GEMM and the tiled QR (with its least-squares check) are
ported so far.
"""

from parsec_tpu_torch.apps.gemm import gemm_taskpool  # noqa: F401
from parsec_tpu_torch.apps.qr import qr_taskpool  # noqa: F401
