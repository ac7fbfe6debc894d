"""K1's share of its roofline over the traced passes, Cholesky at coarse tiles."""

from benchmark.readers import k1_roofline as read  # noqa: F401
