"""Ring pipeline: neighbor-exchange dataflow (the sequence-parallel
primitive).

The reference has no attention/sequence dimension (SURVEY §5.7), but its
dataflow bcast trees are the primitive ring schedules are built from.
This app expresses the canonical ring exchange — each of P parties holds
a block, and over P rounds every block visits every party while a local
accumulator combines it — as a plain PTG.  That is exactly the data
movement of ring attention (KV blocks circulating past resident Q) and
of ring allreduce; ``combine`` is the per-visit operator (attention
scores, a sum, ...).

Placement: party q's tasks run where ``A(q)`` lives, so on P ranks every
edge is a neighbor hop on the interconnect (the comm engine; the JAX
package's multi-device ICI path is not ported).  After the
pool completes, every party's accumulator has combined ALL blocks.

The port's copy of the JAX package's apps/ring.py.  Its deliberate
differences: ``device`` defaults to ``"cuda"``; one body serves as the
device body and the CPU body (``bind_bodies``; the JAX package's
``"tpu"``/``"xla"`` raise), so a combine is written in torch ops that run
on the tile's device; the default combine is a torch add.
"""

from __future__ import annotations

from typing import Callable, Optional

from parsec_tpu_torch.apps.bodies import bind_bodies
from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.api import DATA, IN, OUT, PTG, Range, TASK


def ring_pipeline_taskpool(V: TiledMatrix, A: TiledMatrix,
                           combine: Optional[Callable] = None,
                           device: str = "cuda",
                           visit_class: Optional[Callable] = None
                           ) -> ParameterizedTaskpool:
    """Build the P-party ring: ``V(q)`` are the circulating blocks,
    ``A(q)`` the resident accumulators (initialized by the caller;
    updated as ``A(q) = combine(A(q), block)`` once per visiting block).
    Default ``combine`` is addition — the ring-allreduce instance.

    Position-dependent operators: a combine whose parameters are
    literally named ``(acc, blk, q, t)`` receives the party and round
    indices ((q - t) mod P recovers which block is visiting).  For
    DEVICE combines prefer declaring ``(acc, blk, vc)`` with a
    ``visit_class(q, t) -> small int``: the class rides as a derived
    task parameter, so the kernel compiles once per CLASS (e.g. 3
    causal variants) instead of once per (q, t) pair — per-(q,t)
    statics would defeat wavefront launch fusion and trigger P^2
    recompiles."""
    P = V.mt
    if A.mt != P:
        raise ValueError("one accumulator per party")
    if combine is None:
        def combine(acc, blk):
            return acc + blk

    # protocol detection by parameter NAMES (arity would be spoofed by
    # unrelated optional params — a 2-ary combine with two kwargs must
    # not silently receive q/t)
    import inspect
    pnames = list(inspect.signature(combine).parameters)
    wants_vc = "vc" in pnames
    wants_pos = (not wants_vc) and "q" in pnames and "t" in pnames
    if wants_vc and visit_class is None:
        raise ValueError("a combine declaring 'vc' needs visit_class=")

    if wants_vc:
        def body(B, Acc, vc):
            return {"Acc": combine(Acc, B, vc)}
    elif wants_pos:
        def body(B, Acc, q, t):
            return {"Acc": combine(Acc, B, q, t)}
    else:
        def body(B, Acc):
            return {"Acc": combine(Acc, B)}

    p = PTG("ring", P=P)
    # R(q, t): party q, round t.  Round 0 combines the party's OWN block
    # and launches it around the ring; round t receives the block that
    # started at party (q - t) mod P and forwards it until it has
    # visited everyone.  ``vc`` (when requested) is a derived 1-value
    # parameter — the JDF derived-local idiom — so it lands in
    # task.locals and binds to kernels by name.
    params = dict(q=Range(0, P - 1), t=Range(0, P - 1))
    if wants_vc:
        params["vc"] = Range(lambda q, t: int(visit_class(q, t)),
                             lambda q, t: int(visit_class(q, t)))
    tb = p.task("R", **params)
    if wants_vc:
        # dep expressions name peers by (q, t) alone — vc is derived,
        # so it must not participate in the task key
        tb.make_key(lambda q, t: (q, t))
    tb = tb \
        .affinity(lambda q, A=A: A(q)) \
        .priority(lambda t, P=P: P - t) \
        .flow("B", "READ",
              IN(DATA(lambda q, V=V: V(q)), when=lambda t: t == 0),
              IN(TASK("R", "B",
                      lambda q, t, P=P: dict(q=(q - 1) % P, t=t - 1)),
                 when=lambda t: t > 0),
              OUT(TASK("R", "B",
                       lambda q, t, P=P: dict(q=(q + 1) % P, t=t + 1)),
                  when=lambda t, P=P: t < P - 1)) \
        .flow("Acc", "RW",
              IN(DATA(lambda q, A=A: A(q)), when=lambda t: t == 0),
              IN(TASK("R", "Acc", lambda q, t: dict(q=q, t=t - 1)),
                 when=lambda t: t > 0),
              OUT(TASK("R", "Acc", lambda q, t: dict(q=q, t=t + 1)),
                  when=lambda t, P=P: t < P - 1),
              OUT(DATA(lambda q, A=A: A(q)),
                  when=lambda t, P=P: t == P - 1))
    # one body serves the device and the CPU: torch ops on the tile's
    # device
    bind_bodies(tb, body, device)
    return p.build()

