"""Chaos harness: seeded fault plans vs 2-rank workloads, asserting the
NO-HANG invariant.

Every run must end, within its deadline, in exactly one of:

  * correct completion — the workload validates its numbers internally,
    so a silently wrong answer fails the run (zero silent corruption);
  * a STRUCTURED failure — PeerFailedError / TaskRetryExhausted
    somewhere in the collected per-rank tracebacks (kill plans
    additionally require the SURVIVOR to report PeerFailedError).

A run that neither completes nor errors before the harness deadline is
a HANG — the one outcome the robustness layer exists to abolish.

Usage:
    C="python -m parsec_tpu_torch.tools.chaos"
    $C --seeds 12                 # the acceptance run, on the card
    $C --seeds 3 --quick          # premerge smoke
    $C --device cpu --seeds 3     # the ranks on the CPU
    $C --list                     # show the plan catalog

Each seed rotates through the plan catalog (drop/dup/delay/trunc frame
faults, hard-close and silent-hang rank kills, transient task faults
with and without retry budget) over two workloads: a 2-rank tiled potrf
(PTG/dataflow path, rendezvous traffic forced via a small eager limit)
and a 2-rank DTD increment chain (lane/surrogate path, exact-value
check).  The fault plan reaches the spawned ranks through
``PARSEC_MCA_FAULT_PLAN`` in the environment (utils/faultinject.py).

The port of the JAX package's tools/chaos.py.  Its deliberate
differences:

* the ranks run on the card (``--device cuda``, the default: two ranks
  time-share one card, each its own CUDA context) unless ``--device
  cpu`` asks for the CPU; without a card a ``cuda`` run fails, it never
  falls back.  On the card the potrf workload runs its device bodies
  (K1 for its GEMM updates); the DTD and chain bodies are host bodies
  on either device;
* every rank starts its pool ``START_S`` seconds past the kill victims'
  engine start, and every ``kill_rank`` time of a plan moves by the
  same (``PARSEC_CHAOS_START_S``, ``_start_after``): a ``kill_rank``
  directive counts from the victim's engine start, and a rank that
  reached the launcher's barrier late (a loaded host, a CUDA context
  coming up) must not find the victim dead before its own pool exists;
* ``PARSEC_CHAOS_KILL_AFTER="<rank>:<n>[:<mode>],..."`` kills a rank
  once it has completed ``n`` tasks past a barrier that follows every
  rank's pool add (``_add_pool``): a death at a point of the pool's
  progress, however long the run takes under load, for the callers
  (tests) that must see the victim die mid-run;
* the potrf recovery legs delay activations 400 ms where the JAX
  package's delay 150 (120 in the multi-death entry): the port's CPU
  pool finished in ~0.9 s under the shorter delay, before a kill at
  1.0 s could land;
* the rejoin and degrade scenarios run under the port's launcher
  (``run_distributed``), not processes of their own.
"""

from __future__ import annotations

import argparse
import itertools
import os
import re
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from parsec_tpu_torch.comm.launch import run_distributed
from parsec_tpu_torch.tools import journal_audit
from parsec_tpu_torch.utils.faultinject import FaultPlan

#: seconds from the kill victims' engine start to every rank's pool start
START_S = 2.0

#: an application tag: the ranks' engine-start stamps (_start_after)
TAG_START = 22


# ---------------------------------------------------------------------------
# workloads (module-level: spawn pickling)
# ---------------------------------------------------------------------------

def _wait_s() -> float:
    return float(os.environ.get("PARSEC_CHAOS_WAIT_S", "60"))


def _host(payload) -> np.ndarray:
    return payload.detach().to("cpu", torch.float32).numpy()


def _kill_after(ctx, rank: int) -> None:
    """Arm ``PARSEC_CHAOS_KILL_AFTER`` on this rank: once it has
    completed its n-th task from here on, a thread of its own calls
    ``fault_kill`` (the ``kill_rank`` directive's death, ``close`` or
    ``hang``)."""
    plan = {}
    for ent in filter(None, os.environ.get("PARSEC_CHAOS_KILL_AFTER",
                                           "").split(",")):
        r, n, *mode = ent.split(":")
        plan[int(r)] = (int(n), mode[0] if mode else "close")
    if rank not in plan:
        return
    (n, mode), done, ce = plan[rank], itertools.count(1), ctx.comm.ce

    def on_complete(es, event, task):
        if next(done) == n:
            threading.Thread(target=ce.fault_kill, args=(mode,),
                             daemon=True).start()
    ctx.pins_register("complete_exec", on_complete)


def _start_after(ctx, rank, nranks):
    """With ``PARSEC_CHAOS_START_S`` set, hold this rank until that many
    seconds past the earliest kill victim's engine start (the victims
    are the fault plan's ``kill_rank`` ranks; CLOCK_MONOTONIC is the
    host's, so every rank reads one clock).  A ``kill_rank`` directive
    counts from the victim's engine start: on a loaded host a rank can
    reach the launcher's barrier a second late, and without this the
    death could land before that rank's pool exists."""
    offset = os.environ.get("PARSEC_CHAOS_START_S")
    victims = [d.rank for d in FaultPlan(os.environ.get(
        "PARSEC_MCA_FAULT_PLAN", "")).of_kind("kill_rank")]
    if offset is not None and victims:
        ce = ctx.comm.ce
        stamps, done = {rank: ce.started_at}, threading.Event()

        def on_stamp(src, at):
            stamps[src] = at
            if len(stamps) == nranks:
                done.set()
        ce.tag_register(TAG_START, on_stamp)
        for r in range(nranks):
            if r != rank:
                ce.send_am(TAG_START, r, ce.started_at)
        if len(stamps) < nranks and not done.wait(60):
            raise TimeoutError(f"rank {rank}: engine-start stamps {stamps}")
        ce.tag_unregister(TAG_START)
        go = min(stamps[v] for v in victims) + float(offset)
        time.sleep(max(0.0, go - time.monotonic()))


def _add_pool(ctx, rank, tp) -> None:
    """``ctx.add_taskpool(tp)``, then, with ``PARSEC_CHAOS_KILL_AFTER``
    set, a barrier of every rank before the kill is armed: a death
    counted from the victim's first tasks must not land before a peer
    has added its pool (a pool added after a death is not recovered)."""
    ctx.add_taskpool(tp)
    if os.environ.get("PARSEC_CHAOS_KILL_AFTER"):
        ctx.comm.ce.barrier()
        _kill_after(ctx, rank)


def _body_device(ctx) -> str:
    """``cuda`` on a rank whose Context has the card, else ``cpu``."""
    accs = ctx.device_registry.accelerators
    return "cuda" if accs and accs[0].is_cuda else "cpu"


def potrf_workload(ctx, rank, nranks, recover=False):
    """Tiled Cholesky with an internal numerical check — the
    PTG/remote-dep path (activations, rendezvous, writebacks).  With
    ``recover`` the collection carries an init_fn re-runnable source,
    so a kill_rank plan ends in lineage re-execution on the survivors
    instead of a structured failure — and the survivors validate the
    ADOPTED tiles too (local_tiles routes through the translated
    owner)."""
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

    n, mb = 96, 16
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = (a @ a.T + n * np.eye(n)).astype(np.float32)
    A = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, nodes=nranks,
                          myrank=rank, name="A")
    _start_after(ctx, rank, nranks)
    if recover:
        A.set_init(lambda m, nn: torch.from_numpy(
            spd[m * mb:(m + 1) * mb, nn * mb:(nn + 1) * mb].copy()))
    for m, nn in A.local_tiles():
        A.data_of(m, nn).copy_on(0).payload.copy_(torch.from_numpy(
            spd[m * mb:(m + 1) * mb, nn * mb:(nn + 1) * mb]))
    _add_pool(ctx, rank, potrf_taskpool(A, device=_body_device(ctx)))
    ctx.wait(timeout=_wait_s())
    # every rank knows the full answer (same seed): validate the LOCAL
    # tiles — a silently wrong tile fails ITS rank
    Lref = np.linalg.cholesky(spd.astype(np.float64))
    for m, nn in A.local_tiles():
        if nn > m:
            continue
        got = _host(A.data_of(m, nn).pull_to_host().payload).astype(
            np.float64)
        ref = Lref[m * mb:(m + 1) * mb, nn * mb:(nn + 1) * mb]
        if m == nn:
            got, ref = np.tril(got), np.tril(ref)
        np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-2)
    return "ok"


def potrf_recover_workload(ctx, rank, nranks):
    return potrf_workload(ctx, rank, nranks, recover=True)


def dtd_chain_workload(ctx, rank, nranks):
    """2-rank DTD increment chain bouncing between ranks — the
    lane/surrogate path, with an EXACT final-value check."""
    from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic
    from parsec_tpu_torch.dsl.dtd import AFFINITY, INOUT, DTDTaskpool

    steps = 40
    V = VectorTwoDimCyclic(mb=4, lm=4, nodes=nranks, myrank=rank)
    if rank == 0:
        V.data_of(0).copy_on(0).payload[:] = 0.0
    tp = DTDTaskpool("chaos-chain")
    _start_after(ctx, rank, nranks)
    _add_pool(ctx, rank, tp)
    ctx.start()
    t = tp.tile_of(V, 0)
    for i in range(steps):
        tp.insert_task(lambda T: T + 1.0, (t, INOUT),
                       (i % nranks, AFFINITY))
    tp.wait(timeout=_wait_s())
    ctx.wait(timeout=_wait_s())
    if rank == 0:
        np.testing.assert_allclose(
            _host(V.data_of(0).pull_to_host().payload), float(steps))
    return "ok"


def dtd_chain_recover_workload(ctx, rank, nranks):
    """The DTD increment chain with a recovery spec: the insertion
    stream doubles as the ``recovery_replay`` lineage, so a killed rank
    mid-chain re-executes the whole chain on the survivor against the
    snapshot-restored tile — EXACT final value required."""
    from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic
    from parsec_tpu_torch.dsl.dtd import AFFINITY, INOUT, DTDTaskpool

    steps = 40
    V = VectorTwoDimCyclic(mb=4, lm=4, nodes=nranks, myrank=rank)
    if rank == 0:
        V.data_of(0).copy_on(0).payload[:] = 0.0
    tp = DTDTaskpool("chaos-chain-r")
    _start_after(ctx, rank, nranks)

    def insert_stream(pool, V=V, steps=steps, nranks=nranks):
        t = pool.tile_of(V, 0)
        for i in range(steps):
            pool.insert_task(lambda T: T + 1.0, (t, INOUT),
                             (i % nranks, AFFINITY))

    tp.recovery_collections = [V]
    tp.recovery_replay = insert_stream
    _add_pool(ctx, rank, tp)
    ctx.start()
    insert_stream(tp)
    tp.wait(timeout=_wait_s())
    ctx.wait(timeout=_wait_s())
    if rank == 0:
        np.testing.assert_allclose(
            _host(V.data_of(0).pull_to_host().payload), float(steps))
    return "ok"


def _dtd_chain_step(T):
    """Named DTD chain body: the function name lands in the task key,
    so keyed fault directives (``delay_dispatch=key~_dtd_chain_step``)
    can stall exactly these bodies."""
    return T + 1.0


def dtd_ab_chain_workload(ctx, rank, nranks):
    """Multi-rank DTD increment chain with keyed 100 ms bodies and a
    recovery spec — the DTD minimal-vs-full A/B DAG.  Inserts
    alternate between ranks 0 and 1 (rank 2+, when present, tracks the
    SPMD stream as a pure observer and participates in the skip
    agreement over the wire).  A mid-chain kill leaves the survivor a
    completed skippable prefix at any kill point; replay-from-restore-
    point re-runs the whole stream either way, so minimal < full
    deterministically.  Returns the survivor's replay accounting:
    ("ok", tasks re-executed, minimal replays, full replays, skip
    agreements)."""
    from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic
    from parsec_tpu_torch.dsl.dtd import AFFINITY, INOUT, DTDTaskpool

    steps = int(os.environ.get("PARSEC_CHAOS_DTD_STEPS", 40))
    V = VectorTwoDimCyclic(mb=4, lm=4, nodes=nranks, myrank=rank,
                           name="Vdtdab")
    # re-runnable v0 source: an ADOPTING survivor with no attach
    # snapshot of the tile (it was never local) restores from here
    V.set_init(lambda m, n=0: torch.zeros(4))
    if rank == 0:
        V.data_of(0).copy_on(0).payload[:] = 0.0
    tp = DTDTaskpool("chaos-dtd-ab")
    _start_after(ctx, rank, nranks)

    def insert_stream(pool, V=V, steps=steps):
        t = pool.tile_of(V, 0)
        for i in range(steps):
            pool.insert_task(_dtd_chain_step, (t, INOUT),
                             (i % 2, AFFINITY))

    tp.recovery_collections = [V]
    tp.recovery_replay = insert_stream
    _add_pool(ctx, rank, tp)
    ctx.start()
    insert_stream(tp)
    tp.wait(timeout=_wait_s())
    ctx.wait(timeout=_wait_s())
    if rank == 0:
        np.testing.assert_allclose(
            _host(V.data_of(0).pull_to_host().payload), float(steps))
    st = ctx.recovery.stats() if ctx.recovery is not None else {}
    return ("ok", st.get("tasks_reexecuted", 0),
            st.get("minimal_replays", 0), st.get("full_replays", 0),
            st.get("skip_agreements", 0))


def dtd_minimal_recover_workload(ctx, rank, nranks):
    """The DTD A/B chain under a kill, with the SKIP-AGREEMENT path
    asserted on every survivor: a full-replay fallback FAILS the case
    (observed-outcome discipline — the counters prove which path ran,
    a silent fallback is a regression, not a pass)."""
    r = dtd_ab_chain_workload(ctx, rank, nranks)
    if r[2] < 1 or r[3] > 0 or r[4] < 1:
        raise AssertionError(
            f"DTD minimal replay did not engage (minimal={r[2]}, "
            f"full={r[3]}, skip_agreements={r[4]}) — silent fallback "
            "to full insert-stream replay")
    return r


def _chain_hook(es, task):
    """Shared CPU incarnation of the dyn and A/B chains' W(i): own
    tile T := predecessor P + 1 (P is READ — never mutated, so sharing
    the producer's copy on local edges is safe)."""
    p = task.data.get("P")
    base = 0.0 if p is None else float(p.payload.reshape(-1)[0])
    t = task.data["T"]
    t.payload = torch.full_like(t.payload, base + 1.0)
    return None


def dyn_chain_recover_workload(ctx, rank, nranks):
    """Distributed DynamicTaskpool chain (runtime task discovery, the
    dyn-hold pool-scoped quiescence round) with a recovery spec: a
    mid-chain kill must restart the pool on the survivor, RE-ARM the
    distributed termination hold across the restart, and end with the
    exact final values on every surviving rank."""
    from parsec_tpu_torch.core.task import (Dep, FromDesc, FromTask, READ,
                                            RW, TaskClass, ToDesc, ToTask)
    from parsec_tpu_torch.core.taskpool import DynamicTaskpool
    from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic

    steps = 12
    V = VectorTwoDimCyclic(mb=2, lm=2 * steps, nodes=nranks,
                           myrank=rank, name="Vdyn")
    V.set_init(lambda m, n=0: torch.zeros(2))
    # each W(i) reads its predecessor's T (task-fed READ, discovered
    # at delivery — never enumerated) and writes its OWN tile
    # V(i) = i + 1, handing T on across the 1D-cyclic owners
    tc = TaskClass(
        "W", params=[("i", lambda g, l: range(steps))],
        affinity=lambda loc, V=V: V(loc["i"]),
        flows=[READ("P",
                    inputs=[Dep(FromTask("W", "T",
                                         lambda loc:
                                         {"i": loc["i"] - 1}),
                                guard=lambda loc: loc["i"] > 0)]),
               RW("T",
                  inputs=[Dep(FromDesc(lambda loc, V=V: V(loc["i"])))],
                  outputs=[Dep(ToTask("W", "P",
                                      lambda loc: {"i": loc["i"] + 1}),
                               guard=lambda loc, s=steps:
                               loc["i"] < s - 1),
                           Dep(ToDesc(lambda loc, V=V: V(loc["i"])))])],
        incarnations=[("cpu", _chain_hook)],
        properties={"startup_fn":
                    lambda g, r: [{"i": 0}] if r == 0 else []})
    tp = DynamicTaskpool("dyn-chain")
    tp.add_task_class(tc)
    tp.recovery_collections = [V]
    _start_after(ctx, rank, nranks)
    _add_pool(ctx, rank, tp)
    ctx.wait(timeout=_wait_s())
    for m, _n in V.local_tiles():
        np.testing.assert_allclose(
            _host(V.data_of(m).pull_to_host().payload), float(m + 1))
    return "ok"


def potrf_recover_count_workload(ctx, rank, nranks):
    """The recover potrf plus this rank's replay accounting — the
    minimal-vs-full A/B leg reads the survivor's re-execution count."""
    r = potrf_workload(ctx, rank, nranks, recover=True)
    st = ctx.recovery.stats() if ctx.recovery is not None else {}
    return (r, st.get("tasks_reexecuted", 0),
            st.get("minimal_replays", 0), st.get("full_replays", 0))


def ab_chain_recover_workload(ctx, rank, nranks):
    """The minimal-vs-full A/B DAG: a 20-step chain whose FIRST half
    lives entirely on rank 0 and second half on rank 1 (tabular
    placement), each body stalled 100 ms by a keyed delay_dispatch.
    Built so the survivor PROVABLY holds completed-and-not-needed work
    at ANY mid-run kill point: a kill during rank 0's half leaves its
    completed prefix skippable (no remote send happened yet), and a
    kill during rank 1's half leaves everything before the one
    cross-rank edge skippable (the re-feed closure stops at the
    boundary producer, whose output synthesizes from the live tile).
    Replay-from-restore-point re-runs the WHOLE local partition either
    way, so minimal < full deterministically.  Returns ("ok", tasks
    re-executed, minimal replays, full replays)."""
    from parsec_tpu_torch.core.task import (Dep, FromDesc, FromTask, READ,
                                            WRITE, TaskClass, ToDesc, ToTask)
    from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
    from parsec_tpu_torch.data.matrix import TwoDimTabular

    # PARSEC_CHAOS_AB_STEPS scales the chain (a bigger DAG with an
    # earlier kill, where the survivor's skippable share dominates)
    steps = int(os.environ.get("PARSEC_CHAOS_AB_STEPS", 20))
    half = steps // 2
    V = TwoDimTabular(2, 1, 2 * steps, 1,
                      table=[0] * half + [1] * (steps - half),
                      nodes=nranks, myrank=rank, name="Vab")
    V.set_init(lambda m, n=0: torch.zeros((2, 1)))
    tc = TaskClass(
        "W", params=[("i", lambda g, l: range(steps))],
        affinity=lambda loc, V=V: V(loc["i"], 0),
        flows=[READ("P",
                    inputs=[Dep(FromTask("W", "T",
                                         lambda loc:
                                         {"i": loc["i"] - 1}),
                                guard=lambda loc: loc["i"] > 0)]),
               # WRITE access (full overwrite): a mid-body kill's
               # stale-mutation taint on this tile must not force the
               # minimal path into its fallback — the re-run rewrites
               # the tile from P alone
               WRITE("T",
                     inputs=[Dep(FromDesc(lambda loc, V=V:
                                          V(loc["i"], 0)))],
                     outputs=[Dep(ToTask("W", "P",
                                         lambda loc:
                                         {"i": loc["i"] + 1}),
                                  guard=lambda loc, s=steps:
                                  loc["i"] < s - 1),
                              Dep(ToDesc(lambda loc, V=V:
                                         V(loc["i"], 0)))])],
        incarnations=[("cpu", _chain_hook)])
    p = ParameterizedTaskpool("ab-chain")
    p.add_task_class(tc)
    p.recovery_collections = [V]
    _start_after(ctx, rank, nranks)
    _add_pool(ctx, rank, p)
    ctx.wait(timeout=_wait_s())
    for m, nn in V.local_tiles():
        np.testing.assert_allclose(
            _host(V.data_of(m, nn).pull_to_host().payload), float(m + 1))
    st = ctx.recovery.stats() if ctx.recovery is not None else {}
    return ("ok", st.get("tasks_reexecuted", 0),
            st.get("minimal_replays", 0), st.get("full_replays", 0))


def ab_chain_minimal_workload(ctx, rank, nranks):
    """The A/B chain under a kill, with the MINIMAL path asserted: on
    this DAG a survivor that fell back to full replay is a regression,
    not a pass (the fallback counters prove which path ran)."""
    r = ab_chain_recover_workload(ctx, rank, nranks)
    if r[2] < 1 or r[3] > 0:
        raise AssertionError(
            f"minimal replay did not engage (minimal={r[2]}, "
            f"full={r[3]}) — silent fallback to restore-point replay")
    return r


WORKLOADS = {"potrf": potrf_workload, "dtd": dtd_chain_workload,
             "potrf-recover": potrf_recover_workload,
             "dtd-recover": dtd_chain_recover_workload,
             "dyn-recover": dyn_chain_recover_workload,
             "potrf-recover-count": potrf_recover_count_workload,
             "ab-chain-minimal": ab_chain_minimal_workload,
             "dtd-ab-chain": dtd_ab_chain_workload,
             "dtd-minimal": dtd_minimal_recover_workload}


# ---------------------------------------------------------------------------
# environment of one run: the plan, its kills moved by START_S, the
# harness knobs; saved and restored around the launch
# ---------------------------------------------------------------------------

_CHAOS_ENV = ("PARSEC_MCA_FAULT_PLAN", "PARSEC_CHAOS_WAIT_S",
              "PARSEC_CHAOS_START_S", "PARSEC_CHAOS_KILL_AFTER",
              "PARSEC_MCA_COMM_PEER_TIMEOUT_S",
              "PARSEC_MCA_TASK_RETRY_MAX",
              "PARSEC_MCA_COMM_EAGER_LIMIT",
              "PARSEC_MCA_COMM_ADAPTIVE_EAGER",
              "PARSEC_MCA_COMM_RDV_RETRY_S",
              "PARSEC_MCA_COMM_TRANSPORT",
              "PARSEC_MCA_RECOVERY_ENABLE",
              "PARSEC_MCA_RECOVERY_MINIMAL",
              "PARSEC_MCA_RECOVERY_MAX_ATTEMPTS",
              "PARSEC_MCA_JOURNAL_DIR")

_KILL_AT = re.compile(r"(kill_rank=\d+@t\+)([0-9.]+)s")


def shift_kills(plan: str, by: float) -> str:
    """``plan`` with every ``kill_rank=R@t+Xs`` at ``t+(X+by)s``."""
    return _KILL_AT.sub(lambda m: f"{m.group(1)}{float(m.group(2)) + by:g}s",
                        plan)


class _Env:
    """``with _Env(plan, env):`` — the run's environment, restored on
    exit: the plan with its kills moved by START_S, START_S itself, and
    ``env``."""

    def __init__(self, plan: str, env: dict):
        self.env = {"PARSEC_MCA_FAULT_PLAN": shift_kills(plan, START_S),
                    "PARSEC_CHAOS_START_S": str(START_S), **env}

    def __enter__(self):
        self.saved = {k: os.environ.get(k)
                      for k in set(_CHAOS_ENV) | set(self.env)}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# kill -> restart -> rejoin scenario (all transports, incl. shm ring
# re-creation) — not a fault-plan case: the victim RESTARTS in-process
# with a bumped incarnation epoch and must serve its partition again
# ---------------------------------------------------------------------------

def _rejoin_phase(ctx, rank, nranks, name):
    """One full 2-rank potrf with per-rank numeric validation."""
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    n, mb = 64, 16
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n)).astype(np.float32)
    spd = (a @ a.T + n * np.eye(n)).astype(np.float32)
    A = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, nodes=nranks,
                          myrank=rank, name=name)
    for m, nn in A.local_tiles():
        A.data_of(m, nn).copy_on(0).payload.copy_(torch.from_numpy(
            spd[m * mb:(m + 1) * mb, nn * mb:(nn + 1) * mb]))
    ctx.add_taskpool(potrf_taskpool(A, device=_body_device(ctx)))
    ctx.wait(timeout=60)
    Lref = np.linalg.cholesky(spd.astype(np.float64))
    for m, nn in A.local_tiles():
        if nn > m:
            continue
        got = _host(A.data_of(m, nn).pull_to_host().payload).astype(
            np.float64)
        ref = Lref[m * mb:(m + 1) * mb, nn * mb:(nn + 1) * mb]
        if m == nn:
            got, ref = np.tril(got), np.tril(ref)
        np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-2)


def rejoin_workload(ctx, rank, nranks):
    """Kill -> restart -> TAG_REJOIN -> serves again: a potrf, then
    rank 1's engine goes down and comes back as incarnation 1 over the
    same transport (on shm: the survivor's re-created rings), rank 0
    sees the death and then the rejoin, and a second potrf runs on the
    rejoined rank.  Returns this rank's view: rejoins counted, the dead
    set afterwards, the engine's epoch and the transport."""
    from parsec_tpu_torch.comm.engine import make_ce
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.utils.mca import params

    rde = ctx.comm
    ce = rde.ce
    _rejoin_phase(ctx, rank, nranks, "A")
    ce.barrier()
    if rank == 1:
        port_base = ce.port_base
        rde.fini()                    # the rank goes down
        time.sleep(1.0)
        params.set("comm_epoch", 1)   # restarted incarnation
        try:
            ce = make_ce(rank, nranks, port_base)
            rde = RemoteDepEngine(ce, ctx)
            table = ctx.recovery.rejoin(timeout=30.0)
        finally:
            params.unset("comm_epoch")
        assert isinstance(table, dict)
    else:
        deadline = time.monotonic() + 25
        while 1 not in ce.dead_peers:
            if time.monotonic() > deadline:
                raise RuntimeError("rank 1 death never detected")
            time.sleep(0.02)
        # the dead mark clears in the handshake just before the rejoin
        # is counted
        while 1 in ce.dead_peers or ctx.recovery.rejoins < 1:
            if time.monotonic() > deadline + 35:
                raise RuntimeError("rank 1 never rejoined")
            time.sleep(0.02)
    ce.barrier(timeout=30)
    # the REJOINED rank serves its partition again, over the RE-CREATED
    # transport state (fresh shm rings on shm)
    _rejoin_phase(ctx, rank, nranks, "B")
    return {"rejoins": ctx.recovery.rejoins, "dead": sorted(ce.dead_peers),
            "epoch": ce.epoch, "transport": ctx.comm.stats()["transport"]}


def rejoin_scenario(transport="shm", timeout=150.0, device="cuda"):
    """Run the kill -> restart -> TAG_REJOIN -> serves-again scenario
    on one transport; returns (ok, detail)."""
    try:
        with _Env("", {"PARSEC_MCA_COMM_TRANSPORT": transport,
                       "PARSEC_MCA_RECOVERY_ENABLE": "1"}):
            res = run_distributed(rejoin_workload, 2, timeout=timeout,
                                  device=device)
    except (RuntimeError, TimeoutError) as exc:
        return False, str(exc)[:400]
    ok = (res[0]["rejoins"] == 1 and res[0]["dead"] == []
          and res[1]["epoch"] == 1 and res[1]["dead"] == []
          and {r["transport"] for r in res} == {transport})
    return ok, repr(res)


# ---------------------------------------------------------------------------
# degrade -> drain-before-death scenario (the predictive health plane's
# validation workload): rank 1 is DYING, not dead — a seeded ramped
# degrade inflates its task latencies and every outbound frame
# (heartbeats included) while staying far under the death timeout.  The
# fabric on rank 0 must journal a pre-emptive health_drain with its
# below-threshold evidence, stop placing onto rank 1, and the heartbeat
# detector must NEVER fire — then the offline auditor (incl. the H1
# health invariant) replays the whole decision trail clean.
# ---------------------------------------------------------------------------

def _health_job_factory():
    """Tiny local 4-task pool: enough to produce real fabric_place
    records (with their gang stamps) around the drain."""
    from parsec_tpu_torch.dsl.ptg import PTG, Range
    p = PTG("hjob", N=4)
    p.task("T", i=Range(0, 3)).body(lambda: None)
    return p.build()


def degrade_workload(ctx, rank, nranks):
    """One rank of the degrade scenario: rank 1 idles (alive; the armed
    plan's ramped degrade delays its frames), rank 0 runs the fabric,
    the health monitor and the auditor.  Returns "ok" on rank 1 and the
    drain's summary on rank 0; raises with every failed check."""
    from parsec_tpu_torch.service.fabric import ServingFabric

    run_s = float(os.environ.get("PARSEC_CHAOS_DEGRADE_RUN_S", "45"))
    ce = ctx.comm.ce
    t0 = time.monotonic()
    if rank != 0:
        # the degrading rank: idle but ALIVE.  The armed fault plan's
        # ramped degrade directive is doing the work — every outbound
        # frame (TAG_HB included) gains a growing, seeded-jittered delay
        # that stays far below comm_peer_timeout_s
        while time.monotonic() - t0 < run_s + 8.0:
            time.sleep(0.2)
        return "ok"

    svc = ServingFabric(ctx)
    hm = getattr(ctx.metrics, "_health", None)
    assert hm is not None, "health plane disarmed on the consumer"
    # one placement BEFORE the degradation bites: its gang stamp must
    # carry BOTH ranks (the healthy baseline the audit's
    # drained-placement check contrasts against)
    pre = svc.submit(_health_job_factory, name="pre-degrade")
    pre_ok = pre.wait(timeout=30)
    assert pre_ok, "pre-degrade job never finished"

    deadline = t0 + run_s
    drained_at = None
    while time.monotonic() < deadline:
        if svc.drains >= 1:
            drained_at = round(time.monotonic() - t0, 1)
            break
        time.sleep(0.2)
    checks = []
    if drained_at is None:
        snap = hm.snapshot().get(1, {})
        checks.append(f"drain never fired within {run_s}s "
                      f"(rank 1 health: {snap!r})")
    # drain-before-DEATH: the liveness detector must never have seen
    # anything — the rank is slow, not silent
    if 1 in ce.dead_peers:
        checks.append("rank 1 declared DEAD — the drain did not beat the "
                      "heartbeat detector")
    st = svc.stats()["fabric"]
    if drained_at is not None and st["drained_ranks"] != [1]:
        checks.append(f"drained_ranks={st['drained_ranks']!r}, "
                      "expected [1]")
    # one placement AFTER the drain: its gang stamp must exclude the
    # drained rank (the H1 invariant audited below)
    if drained_at is not None:
        post = svc.submit(_health_job_factory, name="post-drain")
        if not post.wait(timeout=30):
            checks.append("post-drain job never finished")
    events = ctx.journal.snapshot()["events"]
    if any(e.get("e") == "peer_dead" and e.get("peer") == 1
           for e in events):
        checks.append("peer_dead journaled for the degrading rank")
    drains = [e for e in events if e.get("e") == "health_drain"]
    if drained_at is not None:
        if not drains:
            checks.append("health_drain missing from the journal")
        elif not drains[0].get("evidence"):
            checks.append("health_drain carries no evidence")
    places = [e for e in events if e.get("e") == "fabric_place"]
    if drained_at is not None and \
            not any(e.get("ranks") == [0] for e in places):
        checks.append("no post-drain placement with gang [0] "
                      f"(placements: {[e.get('ranks') for e in places]!r})")
    violations = journal_audit.audit({0: [ctx.journal.snapshot()]})
    if violations:
        checks.append("journal audit: " + "; ".join(violations[:4]))
    svc.shutdown(timeout=5.0)
    if checks:
        raise AssertionError("; ".join(checks))
    return (f"drained rank 1 at t+{drained_at}s "
            f"(evidence pts={len(drains[0]['evidence'])}, "
            f"placements={len(places)}, events={len(events)})")


def degrade_scenario(seed=7, timeout=120.0, device="cuda"):
    """Run the seeded degrade -> drain-before-death case; returns
    (ok, detail).  Replayable: the ramp's jitter stream is seeded, so
    the same seed degrades the same way."""
    env = {
        "PARSEC_MCA_COMM_PEER_TIMEOUT_S": "30",
        # heartbeat cadence rides min(clock_probe, timeout/3): probe at
        # 0.3 s so the gap/jitter baseline learns fast and the jitter
        # penalty reads against a tight cadence
        "PARSEC_MCA_COMM_CLOCK_PROBE_S": "0.3",
        "PARSEC_MCA_HEALTH_INTERVAL_S": "0.5",
        # evidence strictly precedes the drain: the 'degraded'
        # transition fires at 0.9, the drain only below 0.85 sustained
        # (healthy ranks sit at 1.0 — the margin is against fold noise,
        # not against health)
        "PARSEC_MCA_HEALTH_DEGRADED": "0.9",
        "PARSEC_MCA_FABRIC_DRAIN_SCORE": "0.85",
        "PARSEC_MCA_FABRIC_DRAIN_SUSTAIN_S": "2.0",
    }
    # the dying-not-dead plan: frame+task delays ramp 0 -> 5 s over
    # 10 s starting at t+4 s — far under the 30 s death timeout
    plan = f"seed={seed};degrade=rank=1,ms=5000,ramp=10,at=4"
    try:
        with _Env(plan, env):
            res = run_distributed(degrade_workload, 2, timeout=timeout,
                                  device=device)
    except (RuntimeError, TimeoutError) as exc:
        return False, str(exc)[:600]
    return res[1] == "ok", str(res[0])


# ---------------------------------------------------------------------------
# minimal-vs-full replay A/B (the --ab-minimal leg)
# ---------------------------------------------------------------------------

def _ab_plan() -> str:
    """The A/B kill plan; PARSEC_CHAOS_AB_KILL_S moves the kill point
    (earlier kill = more completed-and-skippable survivor work on the
    default tabular split) and PARSEC_CHAOS_AB_BODY_MS the per-body
    stall for bigger-DAG runs."""
    kill_s = os.environ.get("PARSEC_CHAOS_AB_KILL_S", "1.0")
    body_ms = os.environ.get("PARSEC_CHAOS_AB_BODY_MS", "100")
    return (f"seed=11;kill_rank=1@t+{kill_s}s,mode=close;"
            f"delay_dispatch=key~W(,ms={body_ms}")


def _run_ab_legs(plan: str, workload, nranks: int, timeout: float,
                 label: str = "", device: str = "cuda"):
    """The shared A/B scaffolding: run one kill plan twice — minimal
    replay vs forced replay-from-restore-point — with env save/restore
    and the kill-actually-fired validation.  Returns
    ``{mode: {"reexec", "minimal", "full", ["skip"], "makespan_s"}}``;
    raises RuntimeError when either leg fails or the kill never fired
    (a run that outpaced its trigger exercised no recovery)."""
    out = {}
    for mode, knob in (("minimal", "1"), ("full", "0")):
        t0 = time.monotonic()
        with _Env(plan, {"PARSEC_CHAOS_WAIT_S": "45",
                         "PARSEC_MCA_RECOVERY_ENABLE": "1",
                         "PARSEC_MCA_RECOVERY_MINIMAL": knob}):
            res = run_distributed(workload, nranks, timeout=timeout,
                                  tolerate_ranks=[1], device=device)
        dt = time.monotonic() - t0
        surv = res[0]
        if surv is None or surv[0] != "ok":
            raise RuntimeError(f"{label}{mode} leg failed: {res!r}")
        if res[1] is not None:
            raise RuntimeError(
                f"{label}{mode} leg outpaced its kill trigger (victim "
                "completed) — no recovery was exercised")
        ent = {"reexec": surv[1], "minimal": surv[2],
               "full": surv[3], "makespan_s": round(dt, 2)}
        if len(surv) > 4:
            ent["skip"] = surv[4]
        out[mode] = ent
    return out


def run_ab_pair(timeout=120.0, device="cuda"):
    """The PTG A/B: recorded-lineage minimal replay vs forced
    replay-from-restore-point on the same deterministic chain kill."""
    return _run_ab_legs(_ab_plan(), ab_chain_recover_workload, 2,
                        timeout, device=device)


def _dtd_ab_plan() -> str:
    """The DTD A/B kill plan: keyed 100 ms chain bodies make the
    40-step chain's makespan >= 4 s, so the t+2.0s kill always lands
    mid-stream — late enough that the survivor provably holds a
    completed, skippable prefix even on a loaded host."""
    kill_s = os.environ.get("PARSEC_CHAOS_AB_KILL_S", "2.0")
    body_ms = os.environ.get("PARSEC_CHAOS_AB_BODY_MS", "100")
    return (f"seed=11;kill_rank=1@t+{kill_s}s,mode=close;"
            f"delay_dispatch=key~_dtd_chain_step,ms={body_ms}")


def run_ab_pair_dtd(timeout=120.0, nranks=3, device="cuda"):
    """The DTD insert-stream A/B: the same mid-chain kill under the
    cross-rank skip agreement vs forced full replay.  3 ranks by
    default so the skip round runs OVER THE WIRE between two survivors
    (2 ranks would short-circuit at the sole survivor)."""
    return _run_ab_legs(_dtd_ab_plan(), dtd_ab_chain_workload, nranks,
                        timeout, label="dtd ", device=device)


def run_ab_minimal(timeout=120.0, device="cuda") -> int:
    """CI leg: assert tasks_reexecuted(minimal) < tasks_reexecuted(full)
    on the acceptance DAG — BOTH A/B lines: the PTG chain (recorded-
    lineage plan) and the DTD chain (insert-stream skip agreement) —
    with each leg provably taking its intended path."""
    try:
        ab = run_ab_pair(timeout=timeout, device=device)
    except RuntimeError as exc:
        print(f"[FAIL] ab-minimal: {exc}")
        return 1
    ok = (ab["minimal"]["minimal"] >= 1 and ab["minimal"]["full"] == 0
          and ab["full"]["full"] >= 1
          and ab["minimal"]["reexec"] < ab["full"]["reexec"])
    status = "PASS" if ok else "FAIL"
    print(f"[{status}] ab-minimal: minimal re-executed "
          f"{ab['minimal']['reexec']} vs full {ab['full']['reexec']} "
          f"task(s) on the same kill "
          f"(paths: minimal={ab['minimal']['minimal']}/"
          f"{ab['minimal']['full']}, full={ab['full']['minimal']}/"
          f"{ab['full']['full']}; makespans "
          f"{ab['minimal']['makespan_s']}s vs "
          f"{ab['full']['makespan_s']}s)")
    rc = 0 if ok else 1
    try:
        dab = run_ab_pair_dtd(timeout=timeout, device=device)
    except RuntimeError as exc:
        print(f"[FAIL] ab-minimal-dtd: {exc}")
        return 1
    dok = (dab["minimal"]["minimal"] >= 1
           and dab["minimal"]["full"] == 0
           and dab["minimal"]["skip"] >= 1
           and dab["full"]["full"] >= 1
           and dab["minimal"]["reexec"] < dab["full"]["reexec"])
    status = "PASS" if dok else "FAIL"
    print(f"[{status}] ab-minimal-dtd: skip-agreed replay re-executed "
          f"{dab['minimal']['reexec']} vs full "
          f"{dab['full']['reexec']} task(s) on the same kill "
          f"(paths: minimal={dab['minimal']['minimal']}/"
          f"{dab['minimal']['full']} skip={dab['minimal']['skip']}, "
          f"full={dab['full']['minimal']}/{dab['full']['full']}; "
          f"makespans {dab['minimal']['makespan_s']}s vs "
          f"{dab['full']['makespan_s']}s)")
    return rc or (0 if dok else 1)


# ---------------------------------------------------------------------------
# the plan catalog
# ---------------------------------------------------------------------------

#: the potrf recovery legs' activation delays (the module docstring)
_POTRF_DELAY = ("delay_frame=tag:ACT,p=1,ms=400;"
                "delay_frame=tag:BATCH,p=1,ms=400")

#: (name, plan template, workload, expected outcome, extra env).
#: {s} is the seed.  Expected outcomes:
#:   complete     both ranks return "ok" (numbers validated in-worker)
#:   peer-failed  >= 1 rank reports a structured PeerFailedError
#:   task-failed  >= 1 rank reports TaskRetryExhausted
#:   recovered    the survivors complete, the tolerated victims died
CATALOG = [
    ("delay-frames",
     "seed={s};delay_frame=tag:ACT,p=0.4,ms=40;"
     "delay_frame=tag:DTD,p=0.4,ms=40",
     "dtd", "complete", {}),
    ("delay-v0",
     "seed={s};delay_frame=tag:DTD,pm='ver': 0,ms=800",
     "dtd", "complete", {}),
    ("delay-recv",
     # RECEIVE-side holds: frames arrive in TCP order but dispatch out
     # of order (utils/faultinject delay_recv) — the reorder coverage
     # send-side delays cannot reach.  The DTD lane landing-order
     # guards and versioned surrogates must still converge exactly.
     "seed={s};delay_recv=tag:DTD,p=0.5,ms=150;"
     "delay_recv=tag:ACT,p=0.3,ms=80",
     "dtd", "complete", {}),
    ("dup-frames",
     "seed={s};dup_frame=tag:ACT,p=0.5;dup_frame=tag:DTD,p=0.5",
     "dtd", "complete", {}),
    ("dup-potrf",
     "seed={s};dup_frame=tag:ACT,p=0.5;dup_frame=tag:GET_REQ,p=0.5",
     "potrf", "complete", {}),
    ("drop-getrep",
     "seed={s};drop_frame=tag:GET_REP,p=0.5,n=3",
     "potrf", "complete",
     {"PARSEC_MCA_COMM_EAGER_LIMIT": "512",
      "PARSEC_MCA_COMM_ADAPTIVE_EAGER": "0",
      "PARSEC_MCA_COMM_RDV_RETRY_S": "0.5"}),
    ("trunc-act",
     "seed={s};trunc_frame=tag:ACT,n=1",
     "potrf", "peer-failed", {}),
    ("kill-close",
     "seed={s};kill_rank=1@t+1.2s,mode=close;"
     "delay_frame=tag:DTD,p=1,ms=60",
     "dtd", "peer-failed", {"PARSEC_CHAOS_WAIT_S": "30"}),
    ("kill-hang",
     "seed={s};kill_rank=1@t+1.2s,mode=hang;"
     "delay_frame=tag:DTD,p=1,ms=60",
     "dtd", "peer-failed",
     {"PARSEC_CHAOS_WAIT_S": "25",
      "PARSEC_MCA_COMM_PEER_TIMEOUT_S": "2"}),
    ("fail-task-retry",
     "seed={s};fail_task=p=0.25,n=6",
     "potrf", "complete", {"PARSEC_MCA_TASK_RETRY_MAX": "8"}),
    ("fail-task-exhaust",
     "seed={s};fail_task=key~POTRF(k=0),n=3",
     "potrf", "task-failed", {"PARSEC_MCA_TASK_RETRY_MAX": "1"}),
    # shm-transport legs: the ring transport must produce the SAME
    # structured detectors and containment as TCP — hard kill
    # (closed-ring EOF path), silent hang (heartbeat-timeout path), and
    # recv-side reorder holds hooking the ring's dispatch
    ("kill-close-shm",
     "seed={s};kill_rank=1@t+1.2s,mode=close;"
     "delay_frame=tag:DTD,p=1,ms=60",
     "dtd", "peer-failed",
     {"PARSEC_CHAOS_WAIT_S": "30",
      "PARSEC_MCA_COMM_TRANSPORT": "shm"}),
    ("kill-hang-shm",
     "seed={s};kill_rank=1@t+1.2s,mode=hang;"
     "delay_frame=tag:DTD,p=1,ms=60",
     "dtd", "peer-failed",
     {"PARSEC_CHAOS_WAIT_S": "25",
      "PARSEC_MCA_COMM_PEER_TIMEOUT_S": "2",
      "PARSEC_MCA_COMM_TRANSPORT": "shm"}),
    ("delay-recv-shm",
     "seed={s};delay_recv=tag:DTD,p=0.5,ms=150;"
     "delay_recv=tag:ACT,p=0.3,ms=80",
     "dtd", "complete", {"PARSEC_MCA_COMM_TRANSPORT": "shm"}),
    # RECOVERY legs: kill_rank plans that END IN COMPLETED JOBS with
    # correct numerics — the surviving rank re-maps the dead rank's
    # partition onto itself, restores the lineage base, and
    # re-executes; the killed rank's own (expected) failure is
    # tolerated by the harness (_TOLERATE).  recovery off reproduces
    # the kill-close/kill-hang containment entries above exactly.
    ("kill-close-recover",
     "seed={s};kill_rank=1@t+1.0s,mode=close;" + _POTRF_DELAY,
     "potrf-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "45",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    ("kill-hang-recover",
     "seed={s};kill_rank=1@t+1.0s,mode=hang;" + _POTRF_DELAY,
     "potrf-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "25",
      "PARSEC_MCA_COMM_PEER_TIMEOUT_S": "2",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    ("kill-dtd-recover",
     "seed={s};kill_rank=1@t+1.2s,mode=close;"
     "delay_frame=tag:DTD,p=1,ms=60",
     "dtd-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "30",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    ("kill-close-recover-shm",
     "seed={s};kill_rank=1@t+1.0s,mode=close;" + _POTRF_DELAY,
     "potrf-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "45",
      "PARSEC_MCA_COMM_TRANSPORT": "shm",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    ("kill-close-recover-threads",
     "seed={s};kill_rank=1@t+1.0s,mode=close;" + _POTRF_DELAY,
     "potrf-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "45",
      "PARSEC_MCA_COMM_TRANSPORT": "threads",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    ("kill-hang-recover-shm",
     "seed={s};kill_rank=1@t+1.0s,mode=hang;" + _POTRF_DELAY,
     "potrf-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "25",
      "PARSEC_MCA_COMM_PEER_TIMEOUT_S": "2",
      "PARSEC_MCA_COMM_TRANSPORT": "shm",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    ("kill-hang-recover-threads",
     "seed={s};kill_rank=1@t+1.0s,mode=hang;" + _POTRF_DELAY,
     "potrf-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "25",
      "PARSEC_MCA_COMM_PEER_TIMEOUT_S": "2",
      "PARSEC_MCA_COMM_TRANSPORT": "threads",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    # minimal replay: the deterministic A/B chain DAG, where the
    # survivor MUST take the recorded-lineage minimal path — the
    # workload raises if recovery silently fell back to full replay
    # (the quantitative minimal<full check is chaos --ab-minimal)
    ("kill-minimal-recover",
     "seed={s};kill_rank=1@t+1.0s,mode=close;"
     "delay_dispatch=key~W(,ms=100",
     "ab-chain-minimal", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "45",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    # DTD skip agreement: a 3-rank DTD chain kill down the cross-rank
    # skip-agreement path — two survivors agree the skippable insert
    # prefix OVER THE WIRE and the workload RAISES if recovery silently
    # fell back to the full insert-stream replay
    ("kill-dtd-minimal",
     "seed={s};kill_rank=1@t+2.0s,mode=close;"
     "delay_dispatch=key~_dtd_chain_step,ms=100",
     "dtd-minimal", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "45", "_NRANKS": "3",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    # dyn-hold recovery: a DynamicTaskpool killed with its distributed
    # termination hold outstanding restarts on the survivor with the
    # hold RE-ARMED
    ("kill-dyn-recover",
     "seed={s};kill_rank=1@t+0.8s,mode=close;"
     "delay_frame=tag:ACT,p=1,ms=150;delay_frame=tag:BATCH,p=1,ms=150",
     "dyn-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "40",
      "PARSEC_MCA_RECOVERY_ENABLE": "1", "_TOLERATE": "1"}),
    # dead-set agreement: two NEAR-SIMULTANEOUS deaths on a 4-rank gang
    # — the two survivors must converge on one confirmed dead set
    # (coordinator broadcast) and complete with validated numerics
    ("multi-death-agreement",
     "seed={s};kill_rank=2@t+1.0s,mode=close;"
     "kill_rank=3@t+1.05s,mode=close;" + _POTRF_DELAY,
     "potrf-recover", "recovered",
     {"PARSEC_CHAOS_WAIT_S": "60", "_NRANKS": "4", "_TOLERATE": "2,3",
      "PARSEC_MCA_RECOVERY_ENABLE": "1",
      "PARSEC_MCA_RECOVERY_MAX_ATTEMPTS": "3"}),
    # survivor exhaustion: a second kill past the recovery budget must
    # end in a CLEAN structured failure, never a loop or a hang
    ("double-kill",
     "seed={s};kill_rank=1@t+1.0s,mode=close;kill_rank=2@t+2.0s,"
     "mode=close;" + _POTRF_DELAY,
     "potrf-recover", "peer-failed",
     {"PARSEC_CHAOS_WAIT_S": "30", "_NRANKS": "3",
      "PARSEC_MCA_RECOVERY_ENABLE": "1",
      "PARSEC_MCA_RECOVERY_MAX_ATTEMPTS": "1"}),
]

_QUICK = ("delay-v0", "delay-recv", "kill-close", "fail-task-retry",
          "kill-close-shm", "delay-recv-shm", "kill-close-recover",
          "kill-dtd-recover")

_RECOVER = ("kill-close-recover", "kill-hang-recover",
            "kill-dtd-recover", "kill-close-recover-shm",
            "kill-close-recover-threads", "kill-hang-recover-shm",
            "kill-hang-recover-threads", "double-kill",
            "kill-minimal-recover", "kill-dyn-recover",
            "kill-dtd-minimal", "multi-death-agreement")


def _audit_journals(jdir: str):
    """Run the offline invariant auditor (tools/journal_audit.py) over
    one case's per-rank journal bundle.  Returns (violations, nevents)
    — a missing bundle reads as zero events, and the caller treats
    zero EVENTS (not just zero files) as a disarmed black box: a
    header-only dump must not let an audit pass vacuously."""
    try:
        per_rank = journal_audit.load_bundle([jdir])
    except FileNotFoundError:
        return [], 0
    nevents = sum(len(s.get("events", ()))
                  for snaps in per_rank.values() for s in snaps)
    return journal_audit.audit(per_rank), nevents


def run_case(name, plan, workload, expect, env, timeout,
             audit_journal=False, device="cuda"):
    """One seeded plan against one workload; returns (ok, outcome,
    detail).  Harness-private env keys: ``_NRANKS`` (gang size,
    default 2) and ``_TOLERATE`` (comma-separated ranks whose failure
    is the EXPECTED kill — recovery cases require the survivors to
    complete with validated numbers while the victim's own error is
    ignored).  ``audit_journal`` arms the control-plane journal for
    the run (PARSEC_MCA_JOURNAL_DIR, a fresh bundle per case) and
    runs tools/journal_audit.py over it afterwards: any invariant
    violation fails the case even if the workload outcome matched."""
    env = dict(env)
    nranks = int(env.pop("_NRANKS", 2))
    tolerate = [int(r) for r in env.pop("_TOLERATE", "").split(",")
                if r != ""]
    jdir = None
    if audit_journal:
        jdir = tempfile.mkdtemp(prefix="parsec-journal-")
        env["PARSEC_MCA_JOURNAL_DIR"] = jdir
    with _Env(plan, env):
        try:
            res = run_distributed(WORKLOADS[workload], nranks,
                                  timeout=timeout, tolerate_ranks=tolerate,
                                  device=device)
            if expect == "recovered":
                # 'recovered' is OBSERVED, not assumed: the kill victim
                # must actually have died (its tolerated slot is None).
                # A run that outpaced its kill_rank trigger completed
                # WITHOUT exercising recovery and must not pass as if
                # it had
                killed = bool(tolerate) and \
                    all(res[r] is None for r in tolerate)
                outcome = "recovered" if killed else "complete"
            else:
                outcome = "complete"
            detail = repr(res)
        except TimeoutError as exc:
            # the harness deadline fired with ranks unreported: a HANG —
            # the invariant violation this tool exists to catch
            outcome, detail = "hang", str(exc)[:300]
        except RuntimeError as exc:
            # one structured failure commonly cascades (a rank failing
            # its pool tears its engine down, the PEER then reports the
            # death): classify by which structured markers appear, with
            # the EXPECTED one winning when present
            text = str(exc)
            found = [m for m, marker in
                     (("task-failed", "TaskRetryExhausted"),
                      ("peer-failed", "PeerFailedError"))
                     if marker in text]
            if expect in found:
                outcome = expect
            else:
                outcome = found[0] if found else "error"
            detail = text[:400]
    ok = outcome == expect
    if jdir is not None:
        try:
            violations, jevents = _audit_journals(jdir)
            if ok and jevents == 0:
                # the run held its invariant but journaled ZERO events:
                # the black box was silently disarmed (env not
                # inherited, journal_enabled=0 leaked, dump path
                # broken) — an un-audited pass must not read as an
                # audited one
                ok = False
                outcome = f"{outcome}+journal-missing"
                detail = (f"zero journal events under {jdir} "
                          f"(journal disarmed?) | {detail}")
            if violations:
                ok = False
                outcome = f"{outcome}+journal-violations"
                detail = (f"journal audit ({jevents} event(s)): "
                          + "; ".join(violations[:6])
                          + (f" (+{len(violations) - 6} more)"
                             if len(violations) > 6 else "")
                          + f" | {detail}")
        except Exception as exc:   # the auditor must not mask the run
            ok = False
            outcome = f"{outcome}+journal-audit-error"
            detail = f"journal audit failed: {exc!r} | {detail}"
        shutil.rmtree(jdir, ignore_errors=True)
    return ok, outcome, detail


def run_soak(n: int, timeout: float, device: str = "cuda") -> int:
    """``--soak N``: N RANDOMLY seeded schedules drawn from the recover
    catalog, each with the full per-run invariant checks (numerics
    validated in-worker, no hang, recovery OBSERVED when expected).
    The master seed and every (case, seed) pair are printed so any
    failure replays exactly:

        PARSEC_CHAOS_SOAK_SEED=<master> python -m \\
            parsec_tpu_torch.tools.chaos --soak N
        # or one case: --only <case> --seeds 1 with the printed plan
    """
    import random
    master = int(os.environ.get("PARSEC_CHAOS_SOAK_SEED",
                                str(int(time.time()) % 1000000)))
    rng = random.Random(master)
    cases = [c for c in CATALOG if c[0] in _RECOVER]
    print(f"soak: {n} random recover schedules "
          f"(PARSEC_CHAOS_SOAK_SEED={master})")
    failures = 0
    for i in range(n):
        name, plan_t, wl, expect, env = rng.choice(cases)
        seed = rng.randrange(1, 1000000)
        plan = plan_t.format(s=seed)
        t0 = time.monotonic()
        ok, outcome, detail = run_case(name, plan, wl, expect, env,
                                       timeout, device=device)
        dt = time.monotonic() - t0
        status = "PASS" if ok else "FAIL"
        print(f"[{status}] soak {i + 1}/{n} {name:20s} seed={seed} "
              f"expect={expect} got={outcome} ({dt:.1f}s)", flush=True)
        if not ok:
            failures += 1
            print(f"       plan: {plan}", flush=True)
            print(f"       {detail}", flush=True)
    print(f"soak: {n - failures}/{n} random schedules held the "
          f"invariants (replay: PARSEC_CHAOS_SOAK_SEED={master})")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks run: the card (each rank its "
                         "own CUDA context; without a card the run "
                         "fails) or the CPU")
    ap.add_argument("--seeds", type=int, default=12,
                    help="seeded plan runs (rotating over the catalog)")
    ap.add_argument("--soak", type=int, default=0, metavar="N",
                    help="N randomly seeded schedules from the recover "
                         "catalog with per-run invariant checks; "
                         "seeds printed for replay "
                         "(PARSEC_CHAOS_SOAK_SEED pins the draw)")
    ap.add_argument("--quick", action="store_true",
                    help="premerge smoke: only the quick catalog subset")
    ap.add_argument("--recover", action="store_true",
                    help="only the RECOVERY catalog subset: kill plans "
                         "that must end in COMPLETED jobs with correct "
                         "numerics (plus survivor exhaustion)")
    ap.add_argument("--timeout", type=float, default=90.0,
                    help="per-run harness deadline (hang detector)")
    ap.add_argument("--audit-journal", action="store_true",
                    help="arm the control-plane journal for every run "
                         "(PARSEC_MCA_JOURNAL_DIR per case) and run "
                         "tools/journal_audit.py over the bundle "
                         "afterwards — invariant violations fail the "
                         "case even when the workload outcome matched")
    ap.add_argument("--ab-minimal", action="store_true",
                    help="minimal-vs-full replay A/B on the acceptance "
                         "kill: asserts tasks_reexecuted(minimal) < "
                         "tasks_reexecuted(full) (the premerge leg)")
    ap.add_argument("--rejoin", default="",
                    help="run the kill->restart->TAG_REJOIN scenario "
                         "on one transport (threads/evloop/shm)")
    ap.add_argument("--degrade", action="store_true",
                    help="run the seeded degrade -> drain-before-death "
                         "scenario: a ramped slowdown on rank 1 must "
                         "trigger a journaled, evidence-carrying "
                         "pre-emptive fabric drain STRICTLY before the "
                         "heartbeat detector fires, and the offline "
                         "audit (incl. the H1 health invariant) must "
                         "replay clean")
    ap.add_argument("--degrade-seed", type=int, default=7,
                    help="seed of the degrade ramp's jitter stream")
    ap.add_argument("--only", default="",
                    help="comma-separated catalog entry names")
    ap.add_argument("--transport", default="",
                    help="force every case onto one transport "
                         "(threads/evloop/shm) — runs the whole "
                         "catalog against it")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    dev = args.device

    catalog = CATALOG
    if args.quick:
        catalog = [c for c in CATALOG if c[0] in _QUICK]
    if args.recover:
        catalog = [c for c in CATALOG if c[0] in _RECOVER]
    if args.only:
        keep = set(args.only.split(","))
        unknown = keep - {c[0] for c in CATALOG}
        if unknown:
            ap.error(f"unknown catalog entries: {sorted(unknown)}")
        catalog = [c for c in CATALOG if c[0] in keep]
    if args.transport:
        catalog = [(n, p, wl, ex,
                    {**env, "PARSEC_MCA_COMM_TRANSPORT": args.transport})
                   for n, p, wl, ex, env in catalog]
    if args.list:
        for name, plan, wl, expect, env in catalog:
            print(f"{name:20s} [{wl}] expect={expect}  {plan}")
        return 0
    if dev == "cuda" and not torch.cuda.is_available():
        print("chaos: --device cuda and no CUDA device is visible (pass "
              "--device cpu to run the ranks on the CPU)", file=sys.stderr)
        return 2

    if args.soak:
        return run_soak(args.soak, args.timeout, device=dev)
    if args.ab_minimal:
        return run_ab_minimal(timeout=args.timeout, device=dev)
    if args.rejoin:
        ok, detail = rejoin_scenario(args.rejoin,
                                     timeout=max(args.timeout, 150.0),
                                     device=dev)
        print(f"[{'PASS' if ok else 'FAIL'}] rejoin-{args.rejoin}: "
              f"{detail}")
        return 0 if ok else 1
    if args.degrade:
        ok, detail = degrade_scenario(seed=args.degrade_seed,
                                      timeout=max(args.timeout, 120.0),
                                      device=dev)
        print(f"[{'PASS' if ok else 'FAIL'}] degrade-drain: "
              f"{detail[:400]}")
        return 0 if ok else 1

    failures = 0
    for i in range(args.seeds):
        name, plan_t, wl, expect, env = catalog[i % len(catalog)]
        plan = plan_t.format(s=i + 1)
        t0 = time.monotonic()
        ok, outcome, detail = run_case(name, plan, wl, expect, env,
                                       args.timeout,
                                       audit_journal=args.audit_journal,
                                       device=dev)
        dt = time.monotonic() - t0
        status = "PASS" if ok else "FAIL"
        print(f"[{status}] seed={i + 1} {name:20s} [{wl}] "
              f"expect={expect} got={outcome} ({dt:.1f}s)", flush=True)
        if not ok:
            failures += 1
            print(f"       {detail}", flush=True)
    total = args.seeds
    if args.recover:
        # the rejoin leg rides the recover acceptance run: shm was the
        # one transport that could not rejoin before the ring
        # re-creation landed (comm/shm.py)
        total += 1
        t0 = time.monotonic()
        ok, detail = rejoin_scenario("shm",
                                     timeout=max(args.timeout, 150.0),
                                     device=dev)
        dt = time.monotonic() - t0
        print(f"[{'PASS' if ok else 'FAIL'}] rejoin-shm ({dt:.1f}s)",
              flush=True)
        if not ok:
            failures += 1
            print(f"       {detail[:400]}", flush=True)
    print(f"chaos: {total - failures}/{total} plans held the "
          "no-hang invariant")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
