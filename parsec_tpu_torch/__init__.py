"""parsec_tpu_torch — the task-DAG runtime on PyTorch and CUDA.

The port of ``parsec_tpu`` (a rebuild of PaRSEC, the Parallel Runtime
Scheduler and Execution Controller) to PyTorch on an NVIDIA H100:
applications are DAGs of micro-tasks with data-labeled dependency edges
(parameterized task graphs), tile kernels are hand-written CUDA kernels
for Hopper, and tiles are staged into device memory by the CUDA device
module.  It imports nothing of ``parsec_tpu`` and never imports JAX; the
module layout mirrors ``parsec_tpu`` so each counterpart is easy to find.

Ported so far (every module of ``parsec_tpu``; the deliberate
differences are listed in ROADMAP.md, Queue 3):
  ``utils``/``containers`` — config registry, logging, concurrent
                             containers, fault injection, checkpoints
  ``data``                 — Data/DataCopy coherency, arenas, repos, tiled
                             matrices and layouts, the carry from the JAX
                             package's arrays
  ``core`` + ``sched``     — taskpools, dep engine, termdet, schedulers,
                             the VP map, recursive pools and the recovery
                             plane (fault tolerance)
  ``native``               — the C scheduler core, trace sink and frame
                             parser, built at first use
  ``devices``              — device registry and the CUDA device module
  ``comm``                 — the distributed runtime (comm engine, remote
                             deps, shm and event-loop transports) and the
                             ICI transport between the device modules of
                             one process
  ``parallel``             — the SPMD schedules, the DAG simulator and
                             the multichip dryrun
  ``dsl``                  — the PTG, DTD and JDF front-ends
  ``apps``                 — the tiled GEMM, QR, Cholesky, stencil and
                             the other apps, and the Hopper kernels
  ``prof``                 — the telemetry plane, the trace stack, the
                             journal, the flight recorder and grapher
  ``service``              — the resident job service, its server and
                             the serving fabric
  ``tools``                — the operator tools (trace_info,
                             trace2chrome, metrics/job clients, live_view,
                             chaos, journal_audit) and the linter,
                             ``python -m parsec_tpu_torch.tools.parseclint``
"""

__version__ = "0.1.0"

from parsec_tpu_torch.utils import mca  # noqa: F401
from parsec_tpu_torch.core.context import Context  # noqa: F401
from parsec_tpu_torch.core.taskpool import (Compound,  # noqa: F401
                                            ParameterizedTaskpool, Taskpool,
                                            compose)
from parsec_tpu_torch.core.task import (CTL, NULL, READ, RW, WRITE,  # noqa: F401
                                        Dep, Flow, FromDesc, FromTask,
                                        HookReturn, New, Task, TaskClass,
                                        ToDesc, ToTask)
