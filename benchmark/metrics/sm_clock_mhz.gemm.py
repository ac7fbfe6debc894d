"""The mean SM clock sampled beside the traced passes, GEMM at coarse tiles."""

from benchmark.readers import sm_clock_mhz as read  # noqa: F401
