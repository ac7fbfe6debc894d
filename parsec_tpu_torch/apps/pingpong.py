"""Ping-pong: task round-trip latency and dataflow bandwidth probes.

Rebuild of the reference's comm perf harnesses (reference:
tests/apps/pingpong/rtt.jdf — a datum bounced between 2 ranks through
dataflow edges, wall time / hops = task round-trip; bandwidth.jdf — the
same chain with large payloads measures dataflow edge bandwidth).  Host
bodies.
"""

from __future__ import annotations

import time
from typing import Tuple

from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic
from parsec_tpu_torch.dsl.ptg.api import DATA, IN, OUT, PTG, Range, TASK


def pingpong_taskpool(V: VectorTwoDimCyclic,
                      hops: int) -> ParameterizedTaskpool:
    """A chain of ``hops`` tasks alternating ownership over V's tiles
    (tile h % NT, so with a 2-rank 1D-cyclic V the datum ping-pongs)."""
    NT = V.mt
    p = PTG("pingpong", H=hops)
    p.task("P", h=Range(0, hops - 1)) \
        .affinity(lambda h, V=V, NT=NT: V(h % NT)) \
        .flow("T", "RW",
              IN(DATA(lambda V=V: V(0)), when=lambda h: h == 0),
              IN(TASK("P", "T", lambda h: dict(h=h - 1)),
                 when=lambda h: h > 0),
              OUT(TASK("P", "T", lambda h, H=hops: dict(h=h + 1)),
                  when=lambda h, H=hops: h < H - 1),
              OUT(DATA(lambda h, V=V, NT=NT: V(h % NT)),
                  when=lambda h, H=hops: h == H - 1)) \
        .body(lambda T: T + 1.0)
    return p.build()


def run_pingpong(ctx, nbytes: int, hops: int) -> Tuple[float, float]:
    """Returns (seconds per hop, MB/s of payload motion).  SPMD: call on
    every rank of the context's communicator."""
    elems = max(1, nbytes // 4)
    V = VectorTwoDimCyclic(mb=elems, lm=elems * max(2, ctx.nranks),
                           nodes=ctx.nranks, myrank=ctx.rank, name="PP")
    for m, _ in V.local_tiles():
        V.data_of(m).copy_on(0).payload[:] = 0.0
    t0 = time.perf_counter()
    ctx.add_taskpool(pingpong_taskpool(V, hops))
    ctx.wait()
    dt = time.perf_counter() - t0
    per_hop = dt / hops
    mbps = (nbytes / per_hop) / 1e6 if per_hop > 0 else float("inf")
    return per_hop, mbps
