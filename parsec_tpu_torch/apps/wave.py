"""Neighbor-shift wavefront: P producers each feeding the consumer on the
next device — the minimal DAG whose cross-device single-consumer edges
form one full CollectivePermute round (SURVEY §5.8 "batched per DAG
wavefront"; reference counterpart: a one-hop slice of the dataflow
pipelines in tests/apps/pingpong/ and tests/apps/stencil/).

Used by both the ICI runtime tests and the multichip dryrun, so the wave
wiring and its expected result live in exactly one place.

The port's copy of the JAX package's apps/wave.py: ``device`` defaults to
``"cuda"``, and the bodies ``T * 2.0`` and ``S + A`` are torch ops on the
tile's device that serve as the CPU bodies too (the JAX package's
``"tpu"``/``"xla"`` raise).
"""

from __future__ import annotations

from parsec_tpu_torch.apps.bodies import bind_bodies
from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.api import DATA, IN, OUT, PTG, Range, TASK


def permute_wave_taskpool(V: TiledMatrix, W: TiledMatrix,
                          device: str = "cuda") -> ParameterizedTaskpool:
    """P(q): doubles block ``V(q)``; C(q): adds P((q-1) mod P)'s result
    into ``W(q)``.  Every P->C edge is a cross-device single-consumer
    hop when ``V``/``W`` are distributed one block per device.

    A CTL-gather GATE holds every consumer until the whole producer wave
    completed — the shape batched placement is FOR: consumers that are
    not instantly runnable (multi-input joins, later pipeline stages), so
    the full round of edges rides one CollectivePermute before any
    consumer stages in.  Ungated, each consumer races its edge and lazy
    stage-in usually wins (that path is exercised by the serialized-chain
    test instead)."""
    nd = V.mt
    if W.mt != nd:
        raise ValueError("one W block per party")
    p = PTG("wave", ND=nd)
    tb = p.task("P", q=Range(0, nd - 1)) \
        .affinity(lambda q, V=V: V(q)) \
        .flow("T", "RW",
              IN(DATA(lambda q, V=V: V(q))),
              OUT(TASK("C", "S", lambda q, ND=nd: dict(q=(q + 1) % ND)))) \
        .flow("ctl", "CTL",
              OUT(TASK("GATE", "ctl", lambda q: dict())))
    bind_bodies(tb, lambda T: T * 2.0, device)
    p.task("GATE") \
        .flow("ctl", "CTL",
              IN(TASK("P", "ctl",
                      lambda ND=nd: [dict(q=q) for q in range(ND)])),
              OUT(TASK("C", "go",
                       lambda ND=nd: [dict(q=q) for q in range(ND)]))) \
        .body(lambda: None)
    tb = p.task("C", q=Range(0, nd - 1)) \
        .affinity(lambda q, W=W: W(q)) \
        .flow("go", "CTL", IN(TASK("GATE", "ctl", lambda q: dict()))) \
        .flow("S", "READ",
              IN(TASK("P", "T", lambda q, ND=nd: dict(q=(q - 1) % ND)))) \
        .flow("A", "RW",
              IN(DATA(lambda q, W=W: W(q))),
              OUT(DATA(lambda q, W=W: W(q))))
    bind_bodies(tb, lambda S, A: S + A, device)
    return p.build()


def fill_wave_inputs(V: TiledMatrix, W: TiledMatrix) -> None:
    """Canonical inputs: V(q) := q, W(q) := 0."""
    for m, _ in V.local_tiles():
        V.data_of(m).copy_on(0).payload[:] = float(m)
    for m, _ in W.local_tiles():
        W.data_of(m).copy_on(0).payload[:] = 0.0


def expected_wave_result(nd: int, q: int) -> float:
    """W(q) after the wave over the canonical inputs: twice the value
    party (q-1) mod P started with."""
    return 2.0 * float((q - 1) % nd)
