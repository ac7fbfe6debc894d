"""Resident job service: multi-tenant concurrent taskpool submission.

One warm Context serves a stream of independent jobs with admission
control, weighted fairness, per-job lifecycle (cancel/deadline), error
isolation, and per-job observability — the serving layer over the
batch runtime (see service/service.py for the design notes,
service/server.py for the socket front end and its ``request()``
client, and service/fabric.py for the multi-tenant fabric).
"""

from parsec_tpu_torch.service.job import (AdmissionError,  # noqa: F401
                                          JobCancelled, JobError,
                                          JobHandle, JobStatus, JobTimeout)
from parsec_tpu_torch.service.service import JobService  # noqa: F401
