"""PCL-EXCEPT — containment-path exception hygiene.

``PeerFailedError`` is the structured, CONTAINED failure: the transport
routes it into the taskpools that touch the dead rank (per-pool
``error_sink``) so one job's dead peer never poisons concurrently
running jobs.  The bug class is handlers undoing that
containment — catching the structured error and re-recording it
context-globally (``record_error(exc, None)``), or silently swallowing
it so nothing surfaced at all.

Rules (scoped to runtime code, not tests):

* an ``except`` catching ``PeerFailedError`` — explicitly, or via
  ``Exception``/``BaseException``/bare — whose handler calls
  ``record_error(..., None)`` (no task attribution = context-global)
  flags: route through ``record_pool_error`` instead;
* an ``except`` naming ``PeerFailedError`` explicitly whose handler
  only ``pass``es / ``return``s / ``continue``s (a swallow) flags
  UNLESS the handler carries ``# lint: contained (reason)`` — the
  waiver documents WHY the loss is already routed elsewhere (e.g. the
  transport's death path recorded it before the send raised).

``record_error(exc, task)`` with a real task is NOT flagged — task
attribution routes through the pool's error sink, which is the
contained path.
"""

from __future__ import annotations

import ast
from typing import List

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding

PASS_ID = "PCL-EXCEPT"

_BROAD = frozenset(("Exception", "BaseException"))


def _caught_names(handler: ast.ExceptHandler) -> List[str]:
    t = handler.type
    if t is None:
        return ["<bare>"]
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for e in elts:
        if isinstance(e, ast.Name):
            out.append(e.id)
        elif isinstance(e, ast.Attribute):
            out.append(e.attr)
    return out


def _catches_peer_failed(names: List[str]) -> bool:
    return "PeerFailedError" in names or "<bare>" in names or \
        bool(set(names) & _BROAD)


def _global_records(handler: ast.ExceptHandler) -> List[ast.Call]:
    """record_error(..., None) calls in the handler body."""
    hits = []
    for node in ast.walk(handler):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "record_error":
            if len(node.args) >= 2 and \
                    isinstance(node.args[1], ast.Constant) and \
                    node.args[1].value is None:
                hits.append(node)
    return hits


def _is_swallow(handler: ast.ExceptHandler) -> bool:
    """Body is only pass/return/continue/warning-style logging."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Return) and stmt.value is None:
            continue
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Call):
            f = stmt.value.func
            name = f.id if isinstance(f, ast.Name) else \
                (f.attr if isinstance(f, ast.Attribute) else "")
            if name in ("warning", "debug_verbose", "mark", "inform"):
                continue
        return False
    return True


def check(ctx: FileCtx) -> List[Finding]:
    if "PeerFailedError" not in ctx.source:
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        names = _caught_names(node)
        if not _catches_peer_failed(names):
            continue
        line = node.lineno
        for call in _global_records(node):
            if not ctx.ignored(call.lineno, PASS_ID):
                findings.append(Finding(
                    ctx.rel, call.lineno, PASS_ID,
                    f"handler catching {'/'.join(names)} records the "
                    "failure CONTEXT-GLOBALLY (record_error(exc, None) "
                    "poisons every pool on the rank) — route through "
                    "record_pool_error"))
        # the waiver may sit on the except line or anywhere in the
        # handler body (the natural place for the "why" comment)
        end = getattr(node, "end_lineno", line) or line
        waived = any(
            "lint: contained" in ctx.comments.get(ln, "")
            for ln in range(line, end + 1))
        if "PeerFailedError" in names and _is_swallow(node) and \
                not ctx.ignored(line, PASS_ID) and not waived:
            findings.append(Finding(
                ctx.rel, line, PASS_ID,
                "PeerFailedError swallowed (pass/return) — a contained "
                "failure must reach record_pool_error somewhere; if the "
                "death was already routed, waive with "
                "'lint: contained (reason)'"))
    return findings
