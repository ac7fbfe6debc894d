"""PCL-EVLOOP — blocking calls reachable from event-loop callbacks.

The single-threaded comm engine (``EventLoopCE``) owns accept/recv/send
for EVERY peer socket on one thread; anything that blocks that thread
wedges the whole comm plane — including the hung-peer detector that is
supposed to catch exactly such wedges (the blocking-``sendmsg``
heartbeat bug), and ``select.select`` dies outright at fd >= 1024.

Roots of the reachability analysis:

* every method of a class with a ``FUNNELLED = True`` class attribute
  (the event-loop transport convention), except methods marked
  ``# off-loop`` on their ``def`` line (constructors/teardown/dial
  helpers that run on other threads; ``__init__``/``fini`` are exempt
  by default);
* any function or method marked ``# on-loop`` on its ``def`` line (AM
  callbacks and periodic hooks the loop invokes through registration
  tables static analysis cannot see).

From the roots, the pass follows same-file ``self.method(...)`` calls
(resolved through same-file base classes, upward only) and module-level
function calls, then flags:

* ``time.sleep(...)``
* ``select.select(...)``   (FD_SETSIZE: raises at fd >= 1024)
* ``<lock>.acquire()`` without ``blocking=False``
* socket-blocking methods (``sendall``/``sendmsg``/``send``/``sendto``/
  ``recv``/``recv_into``/``recvfrom``/``accept``/``connect``) UNLESS
  the call sits in a ``try`` whose handlers catch ``BlockingIOError``
  — the nonblocking-socket discipline the loop requires.

Waiver: ``# lint: allow-blocking (reason)`` on the call line — e.g. the
bounded post-stop ``_shutdown_drain`` sleep.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding

PASS_ID = "PCL-EVLOOP"

_SOCK_BLOCKING = frozenset((
    "sendall", "sendmsg", "send", "sendto", "recv", "recv_into",
    "recvfrom", "accept", "connect",
))

#: teardown/bring-up methods that run off the loop by convention
_DEFAULT_OFF_LOOP = frozenset(("__init__", "fini"))

FuncKey = Tuple[Optional[str], str]   # (class name or None, func name)


def _catches_blocking(handler_types: List[ast.expr]) -> bool:
    for t in handler_types:
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        for e in elts:
            name = e.id if isinstance(e, ast.Name) else \
                (e.attr if isinstance(e, ast.Attribute) else None)
            if name in ("BlockingIOError", "InterruptedError"):
                return True
    return False


class _Index:
    """Per-file function index + static call graph."""

    def __init__(self, ctx: FileCtx):
        self.ctx = ctx
        self.funcs: Dict[FuncKey, ast.AST] = {}
        self.bases: Dict[str, List[str]] = {}
        for node in ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs[(None, node.name)] = node
            elif isinstance(node, ast.ClassDef):
                self.bases[node.name] = [
                    b.id for b in node.bases if isinstance(b, ast.Name)]
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.funcs[(node.name, item.name)] = item

    def resolve(self, cls: Optional[str], name: str) -> Optional[FuncKey]:
        """self.<name> resolution: the caller's class, then same-file
        bases (upward only — a base method never dispatches DOWN into a
        transport the loop does not run)."""
        seen: Set[str] = set()
        stack = [cls] if cls else []
        while stack:
            c = stack.pop(0)
            if c is None or c in seen:
                continue
            seen.add(c)
            if (c, name) in self.funcs:
                return (c, name)
            stack.extend(self.bases.get(c, []))
        if (None, name) in self.funcs:
            return (None, name)
        return None


def _roots(ctx: FileCtx, index: _Index) -> List[FuncKey]:
    roots: List[FuncKey] = []
    for node in ctx.tree.body:
        if isinstance(node, ast.ClassDef):
            funnelled = any(
                isinstance(s, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "FUNNELLED"
                    for t in s.targets)
                and isinstance(s.value, ast.Constant)
                and s.value.value is True
                for s in node.body)
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                on = ctx.has_marker(item.lineno, "on-loop")
                off = item.name in _DEFAULT_OFF_LOOP or \
                    ctx.has_marker(item.lineno, "off-loop")
                if on or (funnelled and not off):
                    roots.append((node.name, item.name))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if ctx.has_marker(node.lineno, "on-loop"):
                roots.append((None, node.name))
    return roots


def _scan_func(ctx: FileCtx, index: _Index, key: FuncKey,
               fn: ast.AST, findings: List[Finding],
               reach_from: str) -> Set[FuncKey]:
    """Flag blocking calls in ``fn``; return same-file callees."""
    callees: Set[FuncKey] = set()
    cls = key[0]

    def flag(line: int, what: str) -> None:
        if ctx.ignored(line, PASS_ID) or \
                ctx.has_marker(line, "allow-blocking"):
            return
        where = f"{cls + '.' if cls else ''}{key[1]}"
        via = "" if where == reach_from else f" (reached from {reach_from})"
        findings.append(Finding(
            ctx.rel, line, PASS_ID,
            f"{what} in {where}{via}: would wedge the single-threaded "
            "event loop"))

    def walk(node: ast.AST, guarded: bool) -> None:
        if isinstance(node, ast.Try):
            g = guarded or _catches_blocking(
                [h.type for h in node.handlers if h.type is not None])
            for child in node.body:
                walk(child, g)
            for h in node.handlers:
                for child in h.body:
                    walk(child, guarded)
            for child in node.orelse + node.finalbody:
                walk(child, guarded)
            return
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                base = f.value
                base_name = base.id if isinstance(base, ast.Name) else None
                if base_name == "time" and f.attr == "sleep":
                    flag(node.lineno, "time.sleep()")
                elif base_name == "select" and f.attr == "select":
                    flag(node.lineno,
                         "select.select() (FD_SETSIZE: dies at fd>=1024; "
                         "use select.poll)")
                elif f.attr == "acquire":
                    nonblocking = any(
                        kw.arg == "blocking" and
                        isinstance(kw.value, ast.Constant) and
                        kw.value.value is False
                        for kw in node.keywords) or (
                        node.args and
                        isinstance(node.args[0], ast.Constant) and
                        node.args[0].value is False)
                    if not nonblocking:
                        flag(node.lineno, "blocking .acquire()")
                elif f.attr in _SOCK_BLOCKING and not guarded:
                    flag(node.lineno,
                         f"socket .{f.attr}() with no BlockingIOError "
                         "handler (nonblocking discipline)")
                elif base_name == "self":
                    target = index.resolve(cls, f.attr)
                    if target is not None:
                        callees.add(target)
            elif isinstance(f, ast.Name):
                target = index.resolve(None, f.id)
                if target is not None:
                    callees.add(target)
        for child in ast.iter_child_nodes(node):
            walk(child, guarded)

    for stmt in fn.body:   # skip the def line/decorators
        walk(stmt, False)
    return callees


def check(ctx: FileCtx) -> List[Finding]:
    # cheap gate: only files that define a funnelled class or carry
    # on-loop annotations pay the graph walk
    if "FUNNELLED" not in ctx.source and "on-loop" not in ctx.source:
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
    # dedup: one function reachable from several roots flags once
    uniq = {}
    for f in findings:
        uniq.setdefault((f.line, f.message.split(" (reached")[0]), f)
    return sorted(uniq.values(), key=lambda f: f.line)
