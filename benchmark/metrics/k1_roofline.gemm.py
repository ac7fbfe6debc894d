"""K1's share of its roofline over the traced passes, GEMM at coarse tiles."""

from benchmark.readers import k1_roofline as read  # noqa: F401
