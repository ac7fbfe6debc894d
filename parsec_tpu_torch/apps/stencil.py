"""1D periodic stencil: iterative halo-exchange pipeline.

Rebuild of the reference's stencil mini-app (reference:
tests/apps/stencil/testing_stencil_1D.c + stencil_1D.jdf — a radius-R 1D
stencil iterated T times, each tile exchanging halos with its neighbors
every step; the wavefront pipeline is the canonical PTG pattern).  Here
the exchange is whole-tile (periodic boundaries) and each S(t, i) task
consumes its own tile plus both neighbors from step t-1 — the producer's
copy fans out to one writer and two readers, exercising the engine's
copy-on-write fan-out semantics.

The port's copy of the JAX package's apps/stencil.py.  Its deliberate
differences: the device bodies, plain ``jnp``/``lax.fori_loop`` there
(no Pallas kernel), are torch ops on the tile's device here (``torch.cat``
and a Python loop of ``ns`` sweeps), and serve as the CPU bodies too;
``device`` defaults to ``"cuda"``, binds them for ``"cuda"``/``"gpu"``
and raises for the JAX package's ``"tpu"``/``"xla"``.
"""

from __future__ import annotations

import numpy as np
import torch

from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.api import DATA, IN, OUT, PTG, Range, TASK

def _step(L, C, R):
    """One 3-point periodic sweep of the centre tile C with its
    neighbours' edge points."""
    ext = torch.cat([L[-1:], C, R[:1]])
    return (ext[:-2] + ext[2:] + C) / 3.0


def _fused(L, C, R, ns):
    """ns consecutive sweeps over the concatenated [L C R] array: the
    array's outer edges evolve with wrapped garbage, but wrongness
    propagates one element per sweep and never reaches the center tile
    for ns <= mb — the S-deep-halo trade (the GEMM k-chain trick applied
    to sweeps)."""
    u = torch.cat([L, C, R])
    for _ in range(int(ns)):
        e = torch.cat([u[-1:], u, u[:1]])
        u = (e[:-2] + e[2:] + u) / 3.0
    mb = C.shape[0]
    return u[mb:2 * mb]


def _bind(tb, fn, device: str) -> None:
    """The device body for "cuda"/"gpu" ahead of the CPU body (the same
    torch function: on the CPU it runs on host tensors)."""
    if device in ("tpu", "xla"):
        raise ValueError(
            f"device={device!r} names the JAX package's XLA module; the "
            "port's device bodies are 'cuda' (or 'gpu')")
    if device in ("cuda", "gpu"):
        tb.body(fn, device=device)
    tb.body(fn)


def stencil_taskpool(V: TiledMatrix, steps: int,
                     device: str = "cuda",
                     fuse: int = 1) -> ParameterizedTaskpool:
    """Iterate the 3-point periodic mean stencil ``steps`` times over the
    tile vector V (in place).

    ``fuse``: sweeps fused per task (S-deep halo; requires
    ``fuse <= V.mb``).  Each task runs ``fuse`` sweeps in one kernel
    over its 3-tile neighborhood, cutting the per-point runtime
    overhead by the fusion depth at 3x the element updates — the right
    trade for an overhead-bound fine-grained pipeline (reference
    harness: tests/apps/stencil/testing_stencil_1D.c)."""
    if fuse > 1:
        if fuse > V.mb:
            raise ValueError(f"fuse depth {fuse} exceeds tile size {V.mb}")
        return _stencil_taskpool_fused(V, steps, device, fuse)
    NT = V.mt
    if NT < 2:
        raise ValueError("stencil needs at least 2 tiles")

    p = PTG("stencil", NT=NT, T=steps)
    # INIT(i) reads each tile once and broadcasts it to the three t=0
    # consumers — reading AND writing a collection tile at the same
    # wavefront without a dep edge would be a DAG race (and remote reads
    # are not allowed anyway); the fan-out then rides the engine's
    # copy-on-write semantics.
    p.task("INIT", i=Range(0, NT - 1)) \
        .affinity(lambda i, V=V: V(i)) \
        .flow("X", "READ",
              IN(DATA(lambda i, V=V: V(i))),
              OUT(TASK("S", "C", lambda i: dict(t=0, i=i))),
              OUT(TASK("S", "L", lambda i, NT=NT: dict(t=0,
                                                       i=(i + 1) % NT))),
              OUT(TASK("S", "R", lambda i, NT=NT: dict(t=0,
                                                       i=(i - 1) % NT)))) \
        .body(lambda: None)
    tb = p.task("S", t=Range(0, steps - 1), i=Range(0, NT - 1)) \
        .affinity(lambda i, V=V: V(i)) \
        .priority(lambda t, T=steps: T - t) \
        .flow("L", "READ",
              IN(TASK("INIT", "X", lambda i, NT=NT: dict(i=(i - 1) % NT)),
                 when=lambda t: t == 0),
              IN(TASK("S", "C", lambda t, i, NT=NT: dict(t=t - 1,
                                                         i=(i - 1) % NT)),
                 when=lambda t: t > 0)) \
        .flow("R", "READ",
              IN(TASK("INIT", "X", lambda i, NT=NT: dict(i=(i + 1) % NT)),
                 when=lambda t: t == 0),
              IN(TASK("S", "C", lambda t, i, NT=NT: dict(t=t - 1,
                                                         i=(i + 1) % NT)),
                 when=lambda t: t > 0)) \
        .flow("C", "RW",
              IN(TASK("INIT", "X", lambda i: dict(i=i)),
                 when=lambda t: t == 0),
              IN(TASK("S", "C", lambda t, i: dict(t=t - 1, i=i)),
                 when=lambda t: t > 0),
              OUT(TASK("S", "C", lambda t, i: dict(t=t + 1, i=i)),
                  when=lambda t, T=steps: t < T - 1),
              OUT(TASK("S", "L", lambda t, i, NT=NT: dict(t=t + 1,
                                                          i=(i + 1) % NT)),
                  when=lambda t, T=steps: t < T - 1),
              OUT(TASK("S", "R", lambda t, i, NT=NT: dict(t=t + 1,
                                                          i=(i - 1) % NT)),
                  when=lambda t, T=steps: t < T - 1),
              OUT(DATA(lambda i, V=V: V(i)),
                  when=lambda t, T=steps: t == T - 1))
    _bind(tb, _step, device)
    return p.build()


def _stencil_taskpool_fused(V: TiledMatrix, steps: int, device: str,
                            fuse: int) -> ParameterizedTaskpool:
    """The fused-sweep variant: blocks of ``fuse`` sweeps per task; the
    last block carries the remainder as its ``ns`` local."""
    NT = V.mt
    if NT < 2:
        raise ValueError("stencil needs at least 2 tiles")
    NB = -(-steps // fuse)          # ceil

    def ns_of(globals_, locals_):
        return [min(fuse, steps - locals_["b"] * fuse)]

    p = PTG("stencil", NT=NT, T=steps)
    p.task("INIT", i=Range(0, NT - 1)) \
        .affinity(lambda i, V=V: V(i)) \
        .flow("X", "READ",
              IN(DATA(lambda i, V=V: V(i))),
              OUT(TASK("S", "C", lambda i: dict(b=0, i=i))),
              OUT(TASK("S", "L", lambda i, NT=NT: dict(b=0,
                                                       i=(i + 1) % NT))),
              OUT(TASK("S", "R", lambda i, NT=NT: dict(b=0,
                                                       i=(i - 1) % NT)))) \
        .body(lambda: None)
    tb = p.task("S", b=Range(0, NB - 1), i=Range(0, NT - 1), ns=ns_of) \
        .affinity(lambda i, V=V: V(i)) \
        .priority(lambda b, NB=NB: NB - b) \
        .flow("L", "READ",
              IN(TASK("INIT", "X", lambda i, NT=NT: dict(i=(i - 1) % NT)),
                 when=lambda b: b == 0),
              IN(TASK("S", "C", lambda b, i, NT=NT: dict(b=b - 1,
                                                         i=(i - 1) % NT)),
                 when=lambda b: b > 0)) \
        .flow("R", "READ",
              IN(TASK("INIT", "X", lambda i, NT=NT: dict(i=(i + 1) % NT)),
                 when=lambda b: b == 0),
              IN(TASK("S", "C", lambda b, i, NT=NT: dict(b=b - 1,
                                                         i=(i + 1) % NT)),
                 when=lambda b: b > 0)) \
        .flow("C", "RW",
              IN(TASK("INIT", "X", lambda i: dict(i=i)),
                 when=lambda b: b == 0),
              IN(TASK("S", "C", lambda b, i: dict(b=b - 1, i=i)),
                 when=lambda b: b > 0),
              OUT(TASK("S", "C", lambda b, i: dict(b=b + 1, i=i)),
                  when=lambda b, NB=NB: b < NB - 1),
              OUT(TASK("S", "L", lambda b, i, NT=NT: dict(b=b + 1,
                                                          i=(i + 1) % NT)),
                  when=lambda b, NB=NB: b < NB - 1),
              OUT(TASK("S", "R", lambda b, i, NT=NT: dict(b=b + 1,
                                                          i=(i - 1) % NT)),
                  when=lambda b, NB=NB: b < NB - 1),
              OUT(DATA(lambda i, V=V: V(i)),
                  when=lambda b, NB=NB: b == NB - 1))
    _bind(tb, _fused, device)
    return p.build()


def stencil_reference(x, steps: int):
    """Serial reference of the same periodic stencil, in float64.  ``x``
    a numpy array gives a numpy array; a tensor (a deliberate addition)
    gives a tensor computed on its device, so a card-sized result is
    checked on the card."""
    if isinstance(x, torch.Tensor):
        u = x.to(torch.float64)
        for _ in range(steps):
            ext = torch.cat([u[-1:], u, u[:1]])
            u = (ext[:-2] + ext[2:] + u) / 3.0
        return u
    u = x.astype(np.float64)
    for _ in range(steps):
        ext = np.concatenate([u[-1:], u, u[:1]])
        u = (ext[:-2] + ext[2:] + u) / 3.0
    return u
