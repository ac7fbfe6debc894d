"""PCL-ASSERT — asserts ``python -O`` silently deletes.

``-O`` strips every ``assert``: a load-bearing guard (the TAG_NAMES
wire-tag drift check that is now an explicit raise in comm/engine.py)
or an assert whose CONDITION has side effects simply vanishes in
optimized deployments.  Two shapes flag:

* a module-level assert (import-time invariant): these guard protocol/
  registry consistency and must be explicit ``raise`` statements;
* an assert whose condition CALLS anything outside a small pure
  whitelist (``len``/``isinstance``/``getattr``/... and read-only
  method names like ``.get``/``.keys``): the call's effect — a queue
  pop, a state transition, an RPC — disappears under ``-O`` together
  with the check.

Waiver: ``# lint: ignore[PCL-ASSERT] reason`` on the assert line.
Tests are outside the default scan scope (pytest runs without ``-O``).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding

PASS_ID = "PCL-ASSERT"

_PURE_FUNCS = frozenset((
    "len", "isinstance", "issubclass", "getattr", "hasattr", "min",
    "max", "abs", "all", "any", "sorted", "sum", "tuple", "list", "set",
    "dict", "frozenset", "str", "int", "float", "bool", "repr", "id",
    "type", "callable", "round", "divmod", "format", "ord", "chr",
    "enumerate", "zip", "range",
))

_PURE_METHODS = frozenset((
    "get", "keys", "values", "items", "count", "index", "startswith",
    "endswith", "strip", "lstrip", "rstrip", "lower", "upper", "split",
    "join", "as_dict", "is_deleted", "isdigit", "copy",
))


def _impure_call(test: ast.AST) -> Optional[ast.Call]:
    for node in ast.walk(test):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in _PURE_FUNCS:
            continue
        if isinstance(f, ast.Attribute) and f.attr in _PURE_METHODS:
            continue
        return node
    return None


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f".{f.attr}"
    return "<call>"


def check(ctx: FileCtx) -> List[Finding]:
    findings: List[Finding] = []

    def in_function(node: ast.Assert) -> bool:
        # module-level asserts have col_offset 0 and sit in tree.body
        # or in top-level if/for/try blocks; detect by walking scopes
        return node in func_asserts

    func_asserts = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assert):
                    func_asserts.add(sub)

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assert):
            continue
        if ctx.ignored(node.lineno, PASS_ID):
            continue
        if not in_function(node):
            findings.append(Finding(
                ctx.rel, node.lineno, PASS_ID,
                "module-level assert guards an import-time invariant — "
                "python -O strips it (the TAG_NAMES class); use an "
                "explicit raise"))
            continue
        call = _impure_call(node.test)
        if call is not None:
            findings.append(Finding(
                ctx.rel, node.lineno, PASS_ID,
                f"assert condition calls {_call_name(call)}() — the "
                "call (and its side effects) vanish under python -O; "
                "hoist the call or use an explicit raise"))
    return findings
