"""Multiprocess SPMD launcher for distributed runs and tests.

The mpiexec analog (reference: tests run distributed cases under
``${MPI_TEST_CMD_LIST} <nranks>`` = mpiexec -n N on one node,
CMakeLists.txt:921-952): spawns N python processes, wires each into a
comm engine + RemoteDepEngine + Context, runs ``fn(ctx, rank, nranks)``
SPMD, and gathers per-rank results (or the first traceback).

Deliberate difference from the JAX package's launcher, whose children
force JAX onto the CPU: here each child runs on the card unless the
caller asks for the CPU.  ``device`` sets the port's ``device`` knob
(the one ``PARSEC_MCA_DEVICE`` sets) in every child, so its Context attaches
the CUDA device module ("cuda", the default) or the CPU-backed one
("cpu", what the tests ask for); a child asked for the card that finds
no CUDA device raises, and so the run fails.  On a host with N cards,
rank r sees card ``r % N`` alone (``CUDA_VISIBLE_DEVICES`` in the
environment it starts with); on one card every rank shares ``cuda:0``.
Children start by spawn, so the parent may hold a CUDA context of its
own.
"""

from __future__ import annotations

import errno
import multiprocessing as mp
import os
import random
import socket
import traceback
from typing import Any, Callable, List, Optional


def _probe_port_base(nranks: int, tries: int = 32) -> int:
    """Pick a base port with every rank's port currently bindable: an
    in-use port would make SocketCE.bind fail or cross-talk with an
    unrelated listener.  A port can still be taken between this probe
    and the rank's bind; ``run_distributed`` relaunches the gang then."""
    for _ in range(tries):
        base = random.randrange(20000, 60000 - nranks)
        socks = []
        try:
            for r in range(nranks):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", base + r))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    return random.randrange(20000, 60000 - nranks)


#: how a rank whose listening port was taken reports it (the head of its
#: error), so that the parent relaunches the gang on a fresh base
ADDR_IN_USE = "EADDRINUSE"

#: gang launches ``run_distributed`` makes before a taken port fails it
LAUNCH_ATTEMPTS = 3


def _worker(rank: int, nranks: int, port_base: int, nb_cores: int,
            device: str, fn: Callable, args: tuple, outq) -> None:
    os.environ.setdefault("PARSEC_COMM_PORT_BASE", str(port_base))
    try:
        from parsec_tpu_torch.comm.engine import make_ce
        from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
        from parsec_tpu_torch.core.context import Context
        from parsec_tpu_torch.utils.mca import params
        # set, not the environment: the knob may be registered already
        # (unpickling ``fn`` imported its module), which reads the
        # environment once
        params.set("device", device)

        # the Context first (the JAX package makes the engine first): a
        # rank without its device then fails before it has a socket its
        # peers would dial for their 30 s connect deadline
        ctx = Context(nb_cores=nb_cores, rank=rank, nranks=nranks)
        # transport selected by PARSEC_MCA_COMM_TRANSPORT (inherited by
        # the spawned children): evloop (default), threads or shm
        try:
            ce = make_ce(rank, nranks, port_base)
        except OSError as exc:
            if exc.errno != errno.EADDRINUSE:
                raise
            # nothing ran yet: the parent relaunches the gang
            outq.put((rank, f"{ADDR_IN_USE}: port {port_base + rank}\n"
                      + traceback.format_exc(), None))
            ctx.fini()
            return
        rde = RemoteDepEngine(ce, ctx)
        ce.barrier()   # every rank's handlers are wired before user code
        try:
            result = fn(ctx, rank, nranks, *args)
            # a rank that went down and rejoined inside ``fn`` (elastic
            # rejoin, core/recovery.py) holds a new engine: the closing
            # barrier and the teardown use the context's current one
            rde = ctx.comm or rde
            ce = rde.ce
            ce.barrier()
            # past the final barrier every rank is done: peers closing
            # their sockets now (possibly while we still serialize the
            # result below) is orderly shutdown, not a failure
            ce._stop = True
            outq.put((rank, None, result))
        finally:
            rde = ctx.comm or rde
            rde.ce._stop = True
            ctx.fini()
            rde.fini()
    except Exception:
        outq.put((rank, traceback.format_exc(), None))


def _visible_cards(device: str) -> List[str]:
    """The card ids the children spread over (``CUDA_VISIBLE_DEVICES``
    values), counted without creating a CUDA context in this, the
    parent, process."""
    if device not in ("cuda", "gpu"):
        return []
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()]
    try:
        import torch
        return [str(i) for i in range(torch.cuda.device_count())]
    except ImportError:
        return []


def _card_of(rank: int, cards: List[str]) -> Optional[str]:
    """``CUDA_VISIBLE_DEVICES`` for ``rank``: card ``rank % N`` on a
    host with N > 1 cards, None (leave it alone) with one or none."""
    return cards[rank % len(cards)] if len(cards) > 1 else None


def _start_gang(fn: Callable, nranks: int, args: tuple, nb_cores: int,
                port_base: int, device: str, cards: List[str]):
    """Spawn the ``nranks`` children of one launch: (processes, queue)."""
    mpctx = mp.get_context("spawn")
    outq = mpctx.Queue()
    procs = [mpctx.Process(target=_worker,
                           args=(r, nranks, port_base, nb_cores, device,
                                 fn, args, outq),
                           daemon=True)
             for r in range(nranks)]
    # a child inherits the environment at start: its card is set there,
    # before anything in it (unpickling CUDA tensors among ``args``
    # included) can initialize CUDA
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    try:
        for r, p in enumerate(procs):
            card = _card_of(r, cards)
            if card is not None:
                os.environ["CUDA_VISIBLE_DEVICES"] = card
            p.start()
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    return procs, outq


def _stop_gang(procs, now: bool = False) -> None:
    for p in procs:
        if now:
            p.terminate()
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)


def run_distributed(fn: Callable, nranks: int, args: tuple = (),
                    nb_cores: int = 2, timeout: float = 120.0,
                    port_base: Optional[int] = None,
                    device: str = "cuda",
                    tolerate_ranks=()) -> List[Any]:
    """Run ``fn(ctx, rank, nranks, *args)`` on ``nranks`` processes;
    returns the per-rank results in rank order.  ``device`` is each
    child's ``device`` knob: "cuda" (the card; the default) or "cpu".

    ``tolerate_ranks``: ranks whose failure is EXPECTED (kill victims
    under recovery — the survivors' completion is the result that
    matters); their slot in the returned list is None when they
    errored.  An error on any other rank still fails the run.

    Deliberate difference from the JAX package's launcher: a rank whose
    listening port was taken between the probe and its bind reports
    ``ADDR_IN_USE`` before anything ran, and the gang is relaunched on a
    fresh base, up to ``LAUNCH_ATTEMPTS`` launches in all (a base the
    caller pinned is not replaced: the run fails)."""
    device = str(device).lower()
    if device not in ("cuda", "gpu", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    pinned = port_base is not None
    cards = _visible_cards(device)
    tolerate = set(tolerate_ranks)
    for attempt in range(1, LAUNCH_ATTEMPTS + 1):
        base = port_base if pinned else _probe_port_base(nranks)
        procs, outq = _start_gang(fn, nranks, args, nb_cores, base, device,
                                  cards)
        results: dict = {}
        errors: List[str] = []
        in_use = None
        try:
            for _ in range(nranks):
                rank, err, res = outq.get(timeout=timeout)
                if err is not None and err.startswith(ADDR_IN_USE):
                    in_use = f"rank {rank}:\n{err}"
                    break
                if err is not None and rank in tolerate:
                    results[rank] = None   # expected casualty (a kill)
                elif err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                else:
                    results[rank] = res
        except Exception as exc:
            _stop_gang(procs, now=True)
            raise TimeoutError(
                f"distributed run incomplete ({len(results)}/{nranks} "
                f"ranks): {errors or exc}")
        # a gang relaunched for a taken port is stopped at once: its
        # other ranks wait on the one that never bound
        _stop_gang(procs, now=in_use is not None)
        if in_use is None:
            break
        if pinned or attempt == LAUNCH_ATTEMPTS:
            raise RuntimeError(f"distributed run failed after {attempt} "
                               f"launch(es):\n{in_use}")
    if errors:
        raise RuntimeError("distributed run failed:\n" + "\n".join(errors))
    return [results[r] for r in range(nranks)]
