"""PCL-LOCK — ``# guarded-by:`` lock discipline on shared mutable state.

Annotation convention (source-level, checked here):

* In ``__init__``, a shared mutable attribute carries a ``guarded-by:``
  comment naming the lock attribute(s) that protect it — trailing on the
  assignment, or in the ``#:`` doc-comment block directly above it::

      #: peer sockets, lazily dialed  (guarded-by: _plock)
      self._peers = {}
      self._bar_gen = 0   # guarded-by: _bar_cond

  Several alternatives (``guarded-by: _lock, _cond``) mean ANY of them
  suffices — the idiom for a Condition wrapping the same underlying
  lock.

* Every WRITE to an annotated attribute (assignment, augmented
  assignment, subscript store/delete, or a mutating method call such as
  ``.append``/``.pop``/``.clear``) outside the declaring ``__init__``
  must sit inside ``with self.<lock>:`` for one of the named locks.

* A method whose CALLER holds the lock declares it on its ``def`` line:
  ``def _apply_locked(self, ...):  # holds-lock: _apply_lock`` — its
  whole body is then treated as guarded.

Bug class: review repeatedly re-found unlocked writes
to comm/termdet shared state (Safra counters, barrier generations,
handle tables) by eyeball; this pass makes the discipline mechanical.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding, self_attr

PASS_ID = "PCL-LOCK"

_GUARDED_RE = re.compile(r"guarded-by:\s*([A-Za-z_][\w]*(?:\s*,\s*[\w]+)*)")
_HOLDS_RE = re.compile(r"holds-lock:\s*([A-Za-z_][\w]*(?:\s*,\s*[\w]+)*)")

#: method names that mutate their receiver (write-through on the
#: annotated container itself)
_MUTATORS = frozenset((
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
))


def _names(m: "re.Match") -> Set[str]:
    return {s.strip() for s in m.group(1).split(",") if s.strip()}


def _collect_annotations(ctx: FileCtx, cls: ast.ClassDef) -> Dict[str, Set[str]]:
    """attr -> lock names, from guarded-by comments in ``__init__``."""
    out: Dict[str, Set[str]] = {}
    for fn in cls.body:
        if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name == "__init__"):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            attrs = [a for a in (self_attr(t) for t in targets) if a]
            if not attrs:
                continue
            text = ctx.comment_near(node.lineno) + " " + \
                ctx.comment_block_above(node.lineno)
            m = _GUARDED_RE.search(text)
            if m:
                for a in attrs:
                    out.setdefault(a, set()).update(_names(m))
    return out


def _writes_of(stmt: ast.AST) -> List[Tuple[int, str, str]]:
    """(line, attr, kind) for every self-attribute write in ``stmt``
    itself (not recursing — the caller walks)."""
    hits: List[Tuple[int, str, str]] = []

    def target_attr(t: ast.AST) -> Optional[str]:
        # self.x = / self.x[...] =  (subscript store mutates the
        # container the annotation names)
        a = self_attr(t)
        if a is not None:
            return a
        if isinstance(t, ast.Subscript):
            return self_attr(t.value)
        return None

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                a = target_attr(el)
                if a:
                    hits.append((stmt.lineno, a, "write"))
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        a = target_attr(stmt.target)
        if a:
            hits.append((stmt.lineno, a, "write"))
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            a = target_attr(t)
            if a:
                hits.append((stmt.lineno, a, "del"))
    elif isinstance(stmt, ast.Call):
        f = stmt.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            a = self_attr(f.value)
            if a:
                hits.append((stmt.lineno, a, f".{f.attr}()"))
    return hits


class _MethodChecker(ast.NodeVisitor):
    """Walk one method tracking the set of locks held via nested
    ``with self.<lock>:`` blocks."""

    def __init__(self, ctx: FileCtx, cls_name: str,
                 annotations: Dict[str, Set[str]], seed_locks: Set[str]):
        self.ctx = ctx
        self.cls_name = cls_name
        self.ann = annotations
        self.held: List[str] = list(seed_locks)
        self.findings: List[Finding] = []

    def visit_With(self, node: ast.With) -> None:
        got = []
        for item in node.items:
            a = self_attr(item.context_expr)
            if a is not None:
                got.append(a)
        self.held.extend(got)
        for stmt in node.body:
            self.visit(stmt)
        if got:
            del self.held[-len(got):]

    def generic_visit(self, node: ast.AST) -> None:
        for line, attr, kind in _writes_of(node):
            locks = self.ann.get(attr)
            if locks and not (locks & set(self.held)) \
                    and not self.ctx.ignored(line, PASS_ID):
                want = "' or 'with self.".join(sorted(locks))
                self.findings.append(Finding(
                    self.ctx.rel, line, PASS_ID,
                    f"{kind} to {self.cls_name}.{attr} outside "
                    f"'with self.{want}' (guarded-by annotation)"))
        super().generic_visit(node)


def check(ctx: FileCtx) -> List[Finding]:
    findings: List[Finding] = []
    classes: Dict[str, ast.ClassDef] = {
        n.name: n for n in ast.walk(ctx.tree)
        if isinstance(n, ast.ClassDef)}
    ann_by_class: Dict[str, Dict[str, Set[str]]] = {
        name: _collect_annotations(ctx, cls)
        for name, cls in classes.items()}

    def resolved(cls: ast.ClassDef) -> Dict[str, Set[str]]:
        """Own annotations plus same-file base classes' (a subclass
        writing base-annotated state obeys the base's discipline)."""
        out: Dict[str, Set[str]] = {}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes:
                out.update(resolved(classes[base.id]))
        out.update(ann_by_class.get(cls.name, {}))
        return out

    for cls in classes.values():
        ann = resolved(cls)
        if not ann:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue   # construction precedes sharing
            seed: Set[str] = set()
            m = _HOLDS_RE.search(ctx.comment_near(fn.lineno))
            if m:
                seed = _names(m)
            checker = _MethodChecker(ctx, cls.name, ann, seed)
            for stmt in fn.body:
                checker.visit(stmt)
            findings.extend(checker.findings)
    return findings
