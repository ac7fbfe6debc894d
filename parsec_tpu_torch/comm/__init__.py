"""Distributed communication layer.

The port of the JAX package's comm stack (reference: SURVEY.md
§2.5/§5.8 — parsec_comm_engine.h transport-neutral vtable,
parsec_mpi_funnelled.c MPI module, remote_dep.c dataflow protocol +
bcast trees): an active-message comm-engine seam (engine.py: the
event-loop and threaded socket transports; shm.py: same-host mmap
rings; frames.py: the frame parser, native in commext.c), the
remote-dependency activation protocol with eager/rendezvous payloads
and star/chain/binomial broadcast propagation (remote_dep.py),
Safra-token global quiescence (the counterpart of the fourcounter
termdet module), and an mpiexec-style multiprocess launcher
(launch.py).

Payloads are torch tensors: a card tile is copied home at send time
and lands on the receiver as a host copy the device module stages in.
Each module's docstring lists what it leaves out of the JAX package's
(the flight-recorder, recovery and fault-injection hooks, the DTD
lanes).
"""

from parsec_tpu_torch.comm.engine import (CommEngine,  # noqa: F401
                                          EventLoopCE, SocketCE, make_ce)
from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine  # noqa: F401
from parsec_tpu_torch.comm.launch import run_distributed  # noqa: F401
