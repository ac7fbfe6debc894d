"""parsec_tpu_torch — the task-DAG runtime on PyTorch and CUDA.

The port of ``parsec_tpu`` (a rebuild of PaRSEC, the Parallel Runtime
Scheduler and Execution Controller) to PyTorch on an NVIDIA H100:
applications are DAGs of micro-tasks with data-labeled dependency edges
(parameterized task graphs), tile kernels are hand-written CUDA kernels
for Hopper, and tiles are staged into device memory by the CUDA device
module.  It imports nothing of ``parsec_tpu`` and never imports JAX; the
module layout mirrors ``parsec_tpu`` so each counterpart is easy to find.

Ported so far (the GEMM, QR and Cholesky slices, the native core, the
telemetry plane, the distributed runtime, DTD/JDF and the job service):
  ``utils``/``containers`` — config registry, logging, concurrent containers
  ``data``                 — Data/DataCopy coherency, arenas, repos, tiled
                             matrices, the carry from the JAX package's arrays
  ``core`` + ``sched``     — taskpools, dep engine, termdet, schedulers
  ``devices``              — device registry and the CUDA device module
  ``dsl.ptg``              — the PTG front-end
  ``apps``                 — the tiled GEMM, QR, Cholesky and stencil, and
                             the Hopper kernels
  ``service``              — the resident job service, its server and
                             the serving fabric
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
