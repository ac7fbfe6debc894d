"""C += A @ B products completed over the window, 2 m n k useful flops each, in TFLOP/s."""

from benchmark.readers import window_tflops as read  # noqa: F401
