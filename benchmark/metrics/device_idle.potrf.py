"""Idle share of the device over the traced passes, Cholesky at coarse tiles."""

from benchmark.readers import device_idle as read  # noqa: F401
