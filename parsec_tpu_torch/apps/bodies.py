"""Binding an app's task bodies to a task class.

The port's apps write their device bodies as torch ops on the tile's
device; most serve as the CPU bodies too.  ``device`` "cuda" (or "gpu")
binds the device body ahead of the CPU body, anything else the CPU body
alone; the JAX package's "tpu"/"xla" name its XLA module and raise.
"""

from __future__ import annotations

from typing import Callable, Optional


def bind_bodies(tb, kernel: Callable, device: str,
                body: Optional[Callable] = None) -> None:
    """Bind ``kernel`` as the device body for "cuda"/"gpu", then
    ``body`` (default: ``kernel``) as the CPU body."""
    if device in ("tpu", "xla"):
        raise ValueError(
            f"device={device!r} names the JAX package's XLA module; the "
            "port's device bodies are 'cuda' (or 'gpu')")
    if device in ("cuda", "gpu"):
        tb.body(kernel, device=device)
    tb.body(kernel if body is None else body)
