"""Scheduling models of the parallel layer.

The JAX package's ``parallel`` carries its SPMD mesh layer (XLA
collectives over ICI, not ported) and ``dagsim``, the list-scheduling
simulator of a taskpool's DAG.  The port carries ``dagsim`` alone: the
live attribution plane's ETA runs the DAG through it
(prof/liveattr.py ``eta_seconds``).
"""
