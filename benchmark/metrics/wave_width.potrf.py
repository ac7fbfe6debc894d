"""Tasks per launch step of the device module over the window: Cholesky at coarse tiles."""

from benchmark.readers import wave_width as read  # noqa: F401
