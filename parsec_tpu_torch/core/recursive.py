"""Recursive device: task bodies that spawn inner taskpools.

Rebuild of the reference's recursive-call machinery (reference:
parsec/recursive.h:45 ``parsec_recursivecall`` + ``PARSEC_DEV_RECURSIVE``
device type, mca/device/device.h:64): a task body may decide its work is
better expressed as a whole task graph — e.g. factorizing one large tile
as a tiled algorithm over its sub-tiles — and hands the runtime an inner
taskpool.  The outer task completes when the inner pool does, re-entering
the normal release-deps path, so recursion nests to any depth.

Usage, from a CPU body that declared the ``es``/``task`` magic args::

    def body(T, es, task):
        sub = SubtileMatrix(task.data["T"].data, mb=inner_mb, nb=inner_mb)
        inner = potrf_taskpool(sub, device="cuda")
        return recursive_call(es, task, inner,
                              callback=lambda _t: sub.commit())

The callback runs on inner-pool completion BEFORE the outer task's deps
release (reference: parsec_recursivecall_callback, recursive.h:25) —
the place to ``SubtileMatrix.commit()`` the parent tile.
"""

from __future__ import annotations

from typing import Callable, Optional

from parsec_tpu_torch.core.task import HookReturn, Task


def recursive_call(es, task: Task, inner_tp,
                   callback: Optional[Callable[[Task], None]] = None
                   ) -> HookReturn:
    """Enqueue ``inner_tp``; complete ``task`` on its completion.

    Returns ``HookReturn.ASYNC`` for the body to return: the runtime —
    not the body's return — completes the task (the same ownership
    contract as a device module; reference: PARSEC_HOOK_RETURN_ASYNC).
    """
    from parsec_tpu_torch.core import scheduling
    ctx = es.context

    def _done(_inner):
        try:
            if callback is not None:
                callback(task)
        except Exception as exc:
            ctx.record_error(exc, task)
            scheduling.complete_execution(es, task, failed=True)
            return
        scheduling.complete_execution(es, task)

    inner_tp.on_complete(_done)
    ctx.add_taskpool(inner_tp, start=True)
    return HookReturn.ASYNC
