"""Observability: binary tracing, PINS instrumentation, gauges, the
telemetry plane and the causal trace pipeline.

reference: SURVEY.md §2.11/§5.1 — parsec/profiling.c binary trace +
dictionary, mca/pins/ callback framework, papi_sde.c live gauges,
tools/profiling readers.  The port carries the JAX package's modules the
Context runs at its defaults (journal, metrics with live attribution and
health, the PINS modules ``pins`` selects) and its trace stack
(profiling with the pinsext sink, reader, causal tracer with its comm
events, cross-rank critical path), the DOT grapher, the crash-dump flight
recorder (prof/flightrec.py) and the gauge aggregator.
"""

from parsec_tpu_torch.prof.profiling import (Profile, profiling_init,  # noqa: F401
                                             profiling_fini)
from parsec_tpu_torch.prof.pins import TaskProfilerPins, install_task_profiler  # noqa: F401
from parsec_tpu_torch.prof.gauges import Gauges, install_gauges  # noqa: F401
from parsec_tpu_torch.prof.reader import read_trace  # noqa: F401
from parsec_tpu_torch.prof.causal import (CausalTracer,  # noqa: F401
                                          install_causal_tracer)
from parsec_tpu_torch.prof.grapher import DotGrapher  # noqa: F401
