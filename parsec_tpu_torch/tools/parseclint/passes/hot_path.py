"""PCL-HOT — per-task lock acquisitions reachable from hot-path code.

Batched termination detection removed a ``threading.Lock`` round-trip
PER TASK from the completion chain (``termdet.taskpool_addto_nb_tasks`` called from
``complete_execution`` — decrements now accumulate per worker and
flush at batch boundaries).  At 500k tasks/s one locked counter move
is ~30% of the whole per-task budget, and the cost hides: the probe
headline drops with no failure anywhere.  This pass encodes the bug
class so a per-task lock cannot quietly return to the hot chain.

Roots of the reachability analysis:

* the canonical scheduler-core chain, by MODULE-LEVEL name:
  ``task_progress``, ``complete_execution``, ``execute``, ``schedule``,
  ``worker_loop`` (the __parsec_task_progress lineage — any file
  defining one of these at module level owns a task hot loop);
* any function or method marked ``# lint: hot-path`` on its ``def``
  line (ReadyQueue callbacks — scheduler ``schedule``/``select``
  methods — and future hot entry points static analysis cannot name).
  The health SCRAPE path is rooted this way (``HealthMonitor.refresh``
  / ``section`` / ``samples`` in prof/health.py): it is not per-task,
  but the fabric's dispatcher tick and every metrics pull run it, so
  per-fold lock or allocation creep silently taxes every scrape — the
  deliberate rate-limited monitor/liveattr locks carry waivers; any
  NEW acquisition in the fold chain gets flagged.

From the roots the pass follows same-file calls (the PCL-EVLOOP
resolution: ``self.method`` through same-file bases, plus module-level
functions) and flags:

* ``with <x>`` where the context manager's name looks like a lock
  (``lock``/``cond``/``mutex``/``sem`` suffixes — the ``_lock`` /
  ``_cond`` conventions of this codebase);
* ``<x>.acquire(...)`` calls;
* ``threading.Lock()`` / ``RLock()`` / ``Condition()`` / ``Semaphore()``
  constructions (allocating a lock per task is as bad as taking one);
* calls to the termdet counter API (``taskpool_addto_nb_tasks`` /
  ``taskpool_addto_runtime_actions``) — the exact per-task round-trip
  batched termdet removed; batched flushes live OUTSIDE the per-task chain or
  carry a waiver.

Waiver: ``lint: ignore[PCL-HOT] (reason)`` on the flagged line — the
batch-boundary flush and the deliberate ``termdet_batch=1`` A/B
fallback are the legitimate carriers.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding
from parsec_tpu_torch.tools.parseclint.passes.evloop_blocking import (
    _Index, FuncKey)

PASS_ID = "PCL-HOT"

#: the scheduler-core chain, rooted by module-level name, with
#: the engine functions the extended C chain now has C-resident twins
#: for (prepare_input / release_deps' delivery walk / deliver_dep) and
#: the native-path containment helpers: per-task lock or dict work
#: creeping into a Python twin silently diverges it from the C chain
#: it must stay byte-identical with — and still costs every bailed-out
#: task.
_ROOT_NAMES = frozenset(("task_progress", "complete_execution",
                         "execute", "schedule", "worker_loop",
                         "deliver_dep", "release_deps", "prepare_input",
                         "_native_body_failed", "_native_hook_return"))

#: lock-ish context-manager / attribute name shapes
_LOCKY = re.compile(r"(?:^|_)(?:lock|cond|mutex|sem(?:aphore)?)\d*$",
                    re.IGNORECASE)

#: lock constructors under the threading module
_LOCK_CTORS = frozenset(("Lock", "RLock", "Condition", "Semaphore",
                         "BoundedSemaphore"))

#: the per-task termdet round-trip this pass exists to keep out
_TERMDET_API = frozenset(("taskpool_addto_nb_tasks",
                          "taskpool_addto_runtime_actions"))


def _tail_name(node: ast.AST) -> Optional[str]:
    """The last name component of a Name/Attribute expression."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _roots(ctx: FileCtx, index: _Index) -> List[FuncKey]:
    roots: List[FuncKey] = []
    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in _ROOT_NAMES or \
                    ctx.has_marker(node.lineno, "hot-path"):
                roots.append((None, node.name))
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        ctx.has_marker(item.lineno, "hot-path"):
                    roots.append((node.name, item.name))
    return roots


def _scan_func(ctx: FileCtx, index: _Index, key: FuncKey, fn: ast.AST,
               findings: List[Finding], reach_from: str) -> Set[FuncKey]:
    callees: Set[FuncKey] = set()
    cls = key[0]

    def flag(line: int, what: str) -> None:
        if ctx.ignored(line, PASS_ID):
            return
        where = f"{cls + '.' if cls else ''}{key[1]}"
        via = "" if where == reach_from else f" (reached from {reach_from})"
        findings.append(Finding(
            ctx.rel, line, PASS_ID,
            f"{what} in {where}{via}: a per-task lock round-trip in the "
            "task hot path — batch it out or waive with a reason"))

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.With):
            for item in node.items:
                cm = item.context_expr
                if isinstance(cm, ast.Call):
                    cm = cm.func
                name = _tail_name(cm)
                if name and _LOCKY.search(name):
                    flag(node.lineno, f"'with {name}' lock acquisition")
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                base = f.value
                base_name = base.id if isinstance(base, ast.Name) else None
                if f.attr == "acquire":
                    flag(node.lineno, ".acquire()")
                elif f.attr in _TERMDET_API:
                    flag(node.lineno, f"termdet .{f.attr}()")
                elif base_name == "threading" and f.attr in _LOCK_CTORS:
                    flag(node.lineno, f"threading.{f.attr}() construction")
                elif base_name == "self":
                    target = index.resolve(cls, f.attr)
                    if target is not None:
                        callees.add(target)
            elif isinstance(f, ast.Name):
                target = index.resolve(None, f.id)
                if target is not None:
                    callees.add(target)
        for child in ast.iter_child_nodes(node):
            walk(child)

    for stmt in fn.body:   # skip the def line/decorators
        walk(stmt)
    return callees


def check(ctx: FileCtx) -> List[Finding]:
    # cheap gate: only files naming a root or carrying the marker pay
    if "hot-path" not in ctx.source and \
            not any(n in ctx.source for n in _ROOT_NAMES):
        return []
    index = _Index(ctx)
    findings: List[Finding] = []
    seen: Set[FuncKey] = set()
    for root in _roots(ctx, index):
        root_name = f"{root[0] + '.' if root[0] else ''}{root[1]}"
        stack = [root]
        while stack:
            key = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            fn = index.funcs.get(key)
            if fn is None:
                continue
            stack.extend(_scan_func(ctx, index, key, fn, findings,
                                    root_name))
    uniq = {}
    for f in findings:
        uniq.setdefault((f.line, f.message.split(" (reached")[0]), f)
    return sorted(uniq.values(), key=lambda f: f.line)
