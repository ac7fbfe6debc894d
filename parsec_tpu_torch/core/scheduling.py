"""Task lifecycle progression and the worker loop.

Rebuild of the reference's scheduling core (reference: parsec/scheduling.c):
``task_progress`` is __parsec_task_progress:472 (prepare_input -> execute ->
complete), ``execute`` iterates incarnations like __parsec_execute:124, and
``worker_loop`` is the hot loop of __parsec_context_wait:537-676 with
exponential backoff on scheduler misses.  ``schedule`` is __parsec_schedule,
entering tasks through the pluggable scheduler and ringing the doorbell.
"""

from __future__ import annotations

import time
from threading import get_ident
from time import perf_counter
from typing import List, Optional

import torch

from parsec_tpu_torch.core import engine
from parsec_tpu_torch.core.errors import FaultInjected, TaskRetryExhausted
from parsec_tpu_torch.core.task import HookReturn, Task, TaskStatus
from parsec_tpu_torch.data.data import ACCESS_WRITE
from parsec_tpu_torch.utils import faultinject as _fi
from parsec_tpu_torch.utils.output import debug_verbose, warning


#: hoisted enum constants: a class-attribute load per task adds up at
#: 100k+ tasks/s
_READY = TaskStatus.READY
_PREPARED = TaskStatus.PREPARED
_RUNNING = TaskStatus.RUNNING
_COMPLETE = TaskStatus.COMPLETE
_DONE = HookReturn.DONE
_ASYNC = HookReturn.ASYNC
_AGAIN = HookReturn.AGAIN
_NEXT = HookReturn.NEXT
_DISABLE = HookReturn.DISABLE


def schedule(es, tasks: List[Task], distance: int = 0) -> None:
    """Enter ready tasks into the scheduler (reference: __parsec_schedule)."""
    if not tasks:
        return
    ctx = es.context
    sched = ctx.scheduler
    if sched.NATIVE_BATCH:
        # native ready queue (sched/native.py): READY transition,
        # ready_at stamping, and the priority-ordered insert all ride
        # ONE C crossing for the whole ring
        sched.schedule(es, tasks, distance)
        ctx.ring_doorbell(len(tasks))
        return
    if ctx._ready_stamp:
        # one stamp for the batch: the tasks became ready at this same
        # moment; the causal tracer closes select - ready_at into a
        # queue-wait span and the metrics registry samples it into the
        # latency histogram.  Gated (Context._ready_stamp) so a
        # telemetry-disabled hot path stays free
        now = perf_counter()
        for t in tasks:
            t.status = _READY
            t.ready_at = now
    else:
        for t in tasks:
            t.status = _READY
    sched.schedule(es, tasks, distance)
    ctx.ring_doorbell(len(tasks))


def execute(es, task: Task) -> HookReturn:
    """Iterate incarnations by preference until one takes the task
    (reference: __parsec_execute chore loop, scheduling.c:138-198)."""
    tc = task.task_class
    host_staged = False
    # no list() copy: NEXT/DISABLE mutate masks, never the list itself
    for idx, (dev_type, hook) in enumerate(tc.incarnations):
        if not (task.chore_mask & (1 << idx)):
            continue
        if tc.chore_disabled_mask & (1 << idx):
            continue
        if dev_type == "cpu" and not host_staged:
            engine.stage_in_host(task)
            host_staged = True
        ret = hook(es, task)
        if not isinstance(ret, HookReturn):
            # bodies opt into lifecycle control by returning HookReturn/int;
            # any other return value (arrays, bools, None...) means DONE
            ret = (HookReturn(ret)
                   if isinstance(ret, int) and not isinstance(ret, bool)
                   else _DONE)
        if ret == _NEXT:
            task.chore_mask &= ~(1 << idx)
            continue
        if ret == _DISABLE:
            # disable class-wide without mutating the list (indices — and
            # other tasks' chore masks — stay stable)
            tc.chore_disabled_mask |= 1 << idx
            continue
        return ret
    warning("%s: no incarnation accepted the task", task)
    return HookReturn.ERROR


def task_progress(es, task: Task, distance: int = 0) -> None:
    """Run one task through its lifecycle
    (reference: __parsec_task_progress)."""
    tp = task.taskpool
    # claim BEFORE the fence check: the recovery drain polls
    # running_task, and a worker descheduled between reading run_epoch
    # and publishing its claim would execute a stale body over
    # already-restored tiles — claimed-then-checked, the drain either
    # sees the claim and waits, or the check runs after the bump and
    # discards (the restore happens strictly after the bump)
    es.running_task = task
    try:
        if task.pool_epoch != tp.run_epoch:
            # recovery fence: the pool restarted (core/recovery.py)
            # after this task was scheduled.  Discard WITHOUT executing
            # and WITHOUT decrementing — the restart re-counted
            # nb_tasks from scratch and this instance belongs to the
            # torn generation (its repo/input holds died with the old
            # structures too)
            task.status = _COMPLETE
            es.pins("task_discard", task)
            return
        if tp.cancelled:
            # cancelled pool: drop the task without executing or
            # releasing successors; the termdet was force-quiesced, so
            # this decrement clamps at zero.  The ready task holds
            # predecessor repo entries (input_sources, filled at dep
            # delivery) — release them or the arena tiles leak
            task.status = _COMPLETE
            es.pins("task_discard", task)
            try:
                engine.consume_inputs(task)
            except Exception as exc:
                debug_verbose(2, "discard %s: consume_inputs: %s",
                              task, exc)
            # lint: ignore[PCL-HOT] cancelled-pool discard: cold path
            tp.termdet.taskpool_addto_nb_tasks(tp, -1)
            return
        cbs = es._pins_map.get("exec_begin")   # inlined es.pins (hot path)
        if cbs:
            for cb in cbs:
                cb(es, "exec_begin", task)
        try:
            if task.status < _PREPARED:
                engine.prepare_input(es, task)
                task.status = _PREPARED
            if es.context._retry_max > 0 and task.retries == 0:
                _snapshot_write_flows(task)
            if _fi.ARMED:
                # fault plan hooks (utils/faultinject.py): keyed
                # delay_dispatch stalls a matching body (deterministic
                # straggler injection); fail_task raises a transient,
                # retryable failure
                _fi.task_delay(task)
                if _fi.task_fault(task):
                    raise FaultInjected(f"{task}: injected transient "
                                        "fault")
            task.status = _RUNNING
            ret = execute(es, task)
        except Exception as exc:  # body/binding error: retry or fail pool
            if _maybe_retry(es, task, exc, distance):
                return
            if task.retries:
                exc = TaskRetryExhausted(
                    f"{task}: still failing after {task.retries + 1} "
                    "attempts", attempts=task.retries + 1, last=exc)
            es.context.record_error(exc, task)
            complete_execution(es, task, failed=True)
            return
        if ret == _DONE:
            cbs = es._pins_map.get("exec_end")   # inlined es.pins
            if cbs:
                for cb in cbs:
                    cb(es, "exec_end", task)
            complete_execution(es, task)
        elif ret == _ASYNC:
            # device module owns the task; it calls complete_execution
            es.pins("exec_async", task)
        elif ret == _AGAIN:
            task.status = _READY
            schedule(es, [task], distance + 1)
        else:
            es.context.record_error(
                RuntimeError(f"{task} failed with {ret!r}"), task)
            complete_execution(es, task, failed=True)
    finally:
        es.running_task = None


def _snapshot_write_flows(task: Task) -> None:
    """Transient-retry support: snapshot host write-flow payloads before
    the first execution attempt, so a retried body re-runs against the
    ORIGINAL inputs even if the failed attempt mutated them in place
    (read-only and task-fed versioned inputs are already safe — the
    datarepo pins their version).  Only armed when task_retry_max > 0.
    The port's payloads are tensors: the snapshot clones host tensors
    where the JAX package copies numpy arrays, and skips card tensors as
    it skips device arrays (a device task's tile is not retried here, so
    a clone would only cost card memory and bandwidth)."""
    snap = {}
    for flow in task.task_class.flows:
        if not flow.access & ACCESS_WRITE:
            continue
        copy = task.data.get(flow.name)
        p = copy.payload if copy is not None else None
        if isinstance(p, torch.Tensor) and p.device.type == "cpu":
            snap[flow.name] = p.clone()
    task.retry_snap = snap


def _maybe_retry(es, task: Task, exc: Exception, distance: int) -> bool:
    """Transient-failure retry: reschedule an idempotent task whose body
    raised, up to ``task_retry_max`` attempts.  Device-owned (ASYNC)
    tasks are not retried here — the device layer has its own degrade
    path."""
    limit = es.context._retry_max
    if limit <= 0 or task.retries >= limit or task.taskpool.cancelled:
        return False
    if not task.task_class.properties.get("idempotent", True):
        return False
    snap = task.retry_snap
    for fname, arr in (snap or {}).items():
        copy = task.data.get(fname)
        if copy is not None:
            copy.payload = arr.clone()
    task.retries += 1
    task.status = TaskStatus.READY
    warning("%s: transient failure (%s: %s); retrying %d/%d", task,
            type(exc).__name__, exc, task.retries, limit)
    es.pins("task_retry", task)
    schedule(es, [task], distance + 1)
    return True


def complete_execution(es, task: Task, failed: bool = False,
                       ran: bool = True) -> None:
    """Completion: version bumps, release deps, repo holds, termdet
    (reference: __parsec_complete_execution:441).  ``ran`` False is a
    stale task the device module's recovery drain dropped unlaunched
    (devices/cuda.py ``drop_stale``, a deliberate difference from the
    JAX package, which has no such drop): no byte of its tiles was
    written, so the DTD taint below must not claim its write landed."""
    tc = task.task_class
    tp = task.taskpool
    if task.pool_epoch != tp.run_epoch:
        # recovery fence (async arm): a device completer or retry path
        # finishing a pre-restart task must neither release successors
        # into the rebuilt dep structures nor decrement the re-counted
        # termdet — the restart owns every count of the new generation.
        # Its BODY ran, though, and may have mutated write-flow tiles
        # in place: bump their version clocks so the payloads can
        # never masquerade as the (unmutated) recorded version — the
        # minimal-replay planner then sees an unrecorded writer and
        # takes the restore-point fallback instead of synthesizing
        # from silently-corrupted "live" bytes
        for flow in tc._write_flows:
            copy = task.data.get(flow.name)
            if copy is not None and copy.data is not None \
                    and copy.data.collection is not None:
                copy.data.complete_write(copy.device)
        if ran and task.dtd is not None and tp._lineage is not None:
            # DTD twin of the version taint: a SUCCESSFUL body's
            # in-place tile writes are LANDED bytes — advance the
            # tiles' applied_ver so the skip-agreement landed map
            # cannot claim an older version over mutated payloads.  A
            # FAILED body's bytes are indeterminate (it may have
            # mutated partway): they match NO version, so the pool
            # votes full instead
            taint = getattr(tp, "dtd_taint_stale", None)
            if taint is not None:
                taint(task.dtd, failed=failed)
        task.status = _COMPLETE
        es.pins("task_discard", task)
        return
    # recovery lineage (core/recovery.py LineageLog; None = zero work):
    # read versions snap BEFORE the write-flow bump below — an RW flow's
    # bound copy still carries the version the body consumed.  The C
    # chain hands a pool with a lineage log back to this path
    # (native/schedext.c: the "lineage" bailout), so every completion
    # of a registered pool is recorded here
    lin = tp._lineage
    lin_reads = None if (lin is None or failed) \
        else lin.snap_reads(task)
    if not failed:
        try:
            for flow in tc._write_flows:
                copy = task.data.get(flow.name)
                if copy is not None and copy.data is not None:
                    copy.data.complete_write(copy.device)
            ready = engine.release_deps(es, task)
            if ready:
                schedule(es, ready)
        except Exception as exc:
            # a dep-expression or write-back error must fail the context,
            # not silently kill the worker thread
            es.context.record_error(exc, task)
    if task.input_sources:
        try:
            engine.consume_inputs(task)
        except Exception as exc:
            es.context.record_error(exc, task)
    if lin is not None and not failed:
        # record AFTER release_deps: write versions are final (the
        # writeback path may have superseded the bound copy) and
        # flush_activations already noted this task's remote dests
        lin.record(task, lin_reads)
    task.status = _COMPLETE
    cbs = es._pins_map.get("complete_exec")   # inlined es.pins
    if cbs:
        for cb in cbs:
            cb(es, "complete_exec", task)
    es.nb_tasks_done += 1
    # batched termdet: decrements accumulate per WORKER and flush at
    # batch boundaries/idle (worker_loop) instead of paying a
    # threading.Lock round-trip per task.  Only the stream's OWNING
    # worker thread may touch the accumulator — an ASYNC device
    # completer finishing a task on its own thread with a borrowed es
    # takes the locked path (no flush guarantee there, and the dict is
    # single-writer by contract)
    acc = es._td_acc
    if acc is not None and get_ident() == es._td_tid:
        ent = acc.get(tp)
        if ent is not None and ent[0] == task.pool_epoch:
            ent[1] += 1
        else:
            acc[tp] = [task.pool_epoch, 1]
    else:
        # lint: ignore[PCL-HOT] off-worker/batch=1 path: no accumulator
        tp.termdet.taskpool_addto_nb_tasks(tp, -1)


def _native_body_failed(es, task, exc, distance: int = 0) -> None:
    """C-chain twin of ``task_progress``'s except branch: the trivial
    hook raised (called from schedext's fast path so retry/containment
    semantics stay byte-identical to the Python chain)."""
    if _maybe_retry(es, task, exc, distance):
        return
    if task.retries:
        exc = TaskRetryExhausted(
            f"{task}: still failing after {task.retries + 1} "
            "attempts", attempts=task.retries + 1, last=exc)
    es.context.record_error(exc, task)
    complete_execution(es, task, failed=True)


def _native_hook_return(es, task, ret, distance: int = 0) -> None:
    """C-chain twin of ``execute``'s return normalization plus
    ``task_progress``'s dispatch, for a non-None return from a trivial
    single-incarnation hook (AGAIN/ASYNC/DISABLE and raw values)."""
    tc = task.task_class
    if not isinstance(ret, HookReturn):
        if isinstance(ret, int) and not isinstance(ret, bool):
            try:
                ret = HookReturn(ret)
            except ValueError as exc:
                # Python-chain parity: execute()'s HookReturn(ret) of
                # an invalid code raises under task_progress's try and
                # becomes a contained task failure — NOT an exception
                # out of the worker loop (which would kill the thread
                # and hang the run with zero recorded errors)
                _native_body_failed(es, task, exc, distance)
                return
        else:
            ret = _DONE
    if ret == _NEXT or ret == _DISABLE:
        # single-incarnation class: declining it leaves no taker
        if ret == _DISABLE:
            tc.chore_disabled_mask |= 1
        else:
            task.chore_mask &= ~1
        warning("%s: no incarnation accepted the task", task)
        ret = HookReturn.ERROR
    if ret == _DONE:
        cbs = es._pins_map.get("exec_end")   # inlined es.pins
        if cbs:
            for cb in cbs:
                cb(es, "exec_end", task)
        complete_execution(es, task)
    elif ret == _ASYNC:
        es.pins("exec_async", task)
    elif ret == _AGAIN:
        task.status = _READY
        schedule(es, [task], distance + 1)
    else:
        es.context.record_error(
            RuntimeError(f"{task} failed with {ret!r}"), task)
        complete_execution(es, task, failed=True)


def _td_flush(es) -> None:
    """Apply the worker's batched termdet decrements — the batch
    boundary (quantum end / idle / worker exit).  Each entry carries
    the generation it accumulated under; the termdet drops
    torn-generation deltas under its own lock (recovery rewind).

    RE-ENTRANT: a flushed decrement can fire a pool termination whose
    completion callback synchronously completes an ASYNC parent task
    on THIS thread (core/recursive.py `_done`), appending to the
    accumulator mid-flush — so the accumulator is snapshotted and
    cleared FIRST, and re-entrant appends land in the fresh dict for
    the next boundary (worker_loop's idle branch flushes whenever the
    accumulator is non-empty, so they cannot strand)."""
    acc = es._td_acc
    if not acc:
        return
    items = list(acc.items())
    acc.clear()
    for tp, ent in items:
        # the amortized lock round-trip the per-task path no longer pays
        tp.termdet.taskpool_addto_nb_tasks(  # lint: ignore[PCL-HOT]
            tp, -ent[1], epoch=ent[0])


def _spin_poll(probe, window_s: float,
               _perf=time.perf_counter, _sleep=time.sleep):
    """Worker-inlined poll: briefly re-poll the ready queue, yielding
    the GIL each round so the comm loop can park its deliveries —
    an activation landing inside the window is picked up at
    GIL-handoff latency instead of a condvar wakeup (the shm
    doorbell's waiting-flag discipline, generalized to the worker
    doorbell)."""
    end = _perf() + window_s
    while _perf() < end:
        t = probe()
        if t is not None:
            return t
        _sleep(0)   # lint: allow-blocking (GIL yield, not a wait)
    return None


def worker_loop(es) -> None:
    """Steady-state worker (reference: __parsec_context_wait hot loop).

    Native path: ``schedext.run_quantum`` runs pop + select-PINS + the
    whole prepare/execute/complete chain of a single-cpu-incarnation
    class for up to ``termdet_batch`` tasks in ONE GIL crossing; tasks
    the C chain cannot take (device classes among them) pop out, select
    already fired, for ``task_progress``.  Termdet decrements accumulate
    per worker and flush at quantum boundaries and idle moments instead
    of locking per task."""
    ctx = es.context
    sched = ctx.scheduler
    native = sched.NATIVE_BATCH
    # native hot path: pop straight off the C ready queue, skipping the
    # select() frame (one Python call per task at 100k+ tasks/s)
    pop = sched._q.pop if native else None
    quantum = q = None
    if native:
        from parsec_tpu_torch.native import load_schedext
        quantum, q = load_schedext().run_quantum, sched._q
    batch = ctx._termdet_batch
    es._td_tid = get_ident()
    es._td_acc = {} if batch > 1 else None
    probe = pop if pop is not None else (lambda: sched.select(es))
    pins_map = es._pins_map
    misses = 0
    done_since = 0
    n = 0
    while not ctx.finished:
        sel_fired = False
        if quantum is not None:
            n, task = quantum(es, q, batch)
            # the C quantum fires select before handing a task back
            sel_fired = task is not None
            if n:
                misses = 0
                done_since += n
                if done_since >= batch:
                    _td_flush(es)
                    done_since = 0
        else:
            task = probe()
        if task is None and quantum is not None and n:
            continue   # progressed this quantum; go straight back
        if task is None:
            # idle moment: flush batched termdet (termination needs the
            # final decrements) — unconditionally on a non-empty
            # accumulator: a flush-fired completion callback may have
            # re-entered complete_execution and deposited a decrement
            # AFTER the counting reset
            if es._td_acc:
                _td_flush(es)
                done_since = 0
            misses += 1
            # then drain deferred wavefront placements (comm/ici.py
            # defer_place)
            ctx.flush_ici()
            # re-read per idle moment, not cached at loop start: a comm
            # engine attaching after workers spin up re-probes the core
            # count and flips this on — the running workers must see it
            spin_s = ctx._db_spin_s
            if misses <= 2 and spin_s > 0 and ctx.comm is not None:
                # worker-inlined comm poll (comm_inline_poll): cover
                # the just-went-idle window before paying a condvar
                # round-trip — the rtt wakeup-latency lever
                task = _spin_poll(probe, spin_s)
            if task is None:
                # exponential backoff on miss (reference:
                # scheduling.c:596-635); the probe re-checks the queue
                # under the doorbell lock so a push racing the
                # waiting-flag cannot be lost
                task = ctx.doorbell_wait(
                    min(0.0002 * (1 << min(misses, 8)), 0.05), probe)
            if task is None:
                continue
            if quantum is not None:
                es.probe_pops += 1     # popped past the C chain
        misses = 0
        # select fires exactly once per task: the C quantum already
        # fired it for tasks IT hands back; doorbell tasks and the whole
        # Python path arrive unfired
        if not sel_fired:
            cbs = pins_map.get("select")   # inlined es.pins
            if cbs:
                for cb in cbs:
                    cb(es, "select", task)
        task_progress(es, task)
        done_since += 1
        if done_since >= batch:
            _td_flush(es)
            done_since = 0
    while es._td_acc:   # worker exit: drain re-entrant deposits too
        _td_flush(es)
    debug_verbose(9, "worker %d: %d tasks", es.th_id, es.nb_tasks_done)
