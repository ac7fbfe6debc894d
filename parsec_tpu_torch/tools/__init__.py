"""Offline tools of the port (the JAX package keeps its own in ``tools/``
at the repository root)."""
