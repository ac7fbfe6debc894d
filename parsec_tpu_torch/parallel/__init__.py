"""Parallel layer: the SPMD schedules and the scheduling models.

``spmd`` carries the JAX package's mesh layer — the dataflow schedules
its multi-chip PTGs lower to (SUMMA all-gather, reduce-scatter ring,
halo ring shift) — run single-controller over the device modules of one
process (``device="cuda*N"`` on one card, "cpu:N" in tests) or over
torch devices; ``dryrun`` is the twin of the JAX package's multichip
dryrun (``__graft_entry__.dryrun_multichip``).  ``dagsim`` is the
list-scheduling simulator of a taskpool's DAG, which the live
attribution plane's ETA runs the DAG through (prof/liveattr.py
``eta_seconds``).
"""

from parsec_tpu_torch.parallel.spmd import (Mesh,  # noqa: F401
                                            halo_stencil_fn, make_mesh,
                                            ring_reduce_gemm_fn,
                                            summa_gemm_fn)
