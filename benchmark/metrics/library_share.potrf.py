"""Share of device-busy time in kernels not the port's own, Cholesky at coarse tiles."""

from benchmark.readers import library_share as read  # noqa: F401
