"""Cholesky factorizations completed over the window, n^3/3 useful flops each, in TFLOP/s."""

from benchmark.readers import window_tflops as read  # noqa: F401
