"""PCL-JRNL — control-plane journal schema drift.

The journal (prof/journal.py) is only as auditable as its schema: the
offline invariant auditor (tools/journal_audit.py) groups events by
type and ROUND, so an emit whose type never entered the event-schema
table — or a round-scoped protocol emit that forgot its ``round=`` —
is an event the auditor silently cannot check.  That is the
schema-drift bug class this pass encodes, tree-wide:

* every ``journal.emit("<type>", ...)`` call (any receiver named
  ``jr``/``journal`` or an attribute access ending in ``.journal``,
  the repo's journal-handle convention) must pass a STRING LITERAL
  event type that appears in ``EVENT_SCHEMA``;
* every field the schema lists as required for that type must be
  passed as an explicit keyword — in particular ``round`` on every
  round-scoped emit (mode votes, skip offers/cuts, need rounds):
  an emit built from ``**kwargs`` hides exactly the drift this pass
  exists to catch;
* a computed (non-literal) event type is flagged too: the auditor
  and this pass can only reason about literals.

Scope-gated like PCL-MCA/PCL-PROM: the cross-check runs only when
``parsec_tpu_torch/prof/journal.py`` (the schema's home) is in the scanned
set, so partial scans stay silent.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding

PASS_ID = "PCL-JRNL"

SCHEMA_FILE = "parsec_tpu_torch/prof/journal.py"

#: receiver names that mark a call as a journal emit (the repo
#: convention: ``jr = self.context.journal`` / ``context.journal``)
_JOURNAL_NAMES = frozenset(("jr", "jr2", "journal"))


def _is_journal_recv(node: ast.expr) -> bool:
    """Is this ``.emit``'s receiver a journal handle?  A bare name in
    the convention set, or any attribute chain ending in ``journal``
    (``self.context.journal``, ``ctx.journal``)."""
    if isinstance(node, ast.Name):
        return node.id in _JOURNAL_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr == "journal"
    return False


def _schema_from_tree(tree: ast.AST) -> Dict[str, List[str]]:
    """Parse the EVENT_SCHEMA dict literal out of the schema module."""
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "EVENT_SCHEMA"
                   for t in targets):
            continue
        value = node.value
        if not isinstance(value, ast.Dict):
            continue
        schema: Dict[str, List[str]] = {}
        for k, v in zip(value.keys, value.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            fields: List[str] = []
            if isinstance(v, (ast.Tuple, ast.List)):
                for el in v.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        fields.append(el.value)
            schema[k.value] = fields
        return schema
    return {}


def facts(ctx: FileCtx) -> Dict[str, list]:
    rel = ctx.rel.replace("\\", "/")
    out: Dict[str, list] = {"rel": rel, "emits": []}
    if rel == SCHEMA_FILE:
        out["schema"] = _schema_from_tree(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit"
                and _is_journal_recv(node.func.value)):
            continue
        etype = None
        literal = False
        if node.args:
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                etype = a0.value
                literal = True
        kwargs = [kw.arg for kw in node.keywords if kw.arg is not None]
        has_star = any(kw.arg is None for kw in node.keywords)
        out["emits"].append({"line": node.lineno, "type": etype,
                             "literal": literal, "kwargs": kwargs,
                             "star": has_star})
    return out


def tree_check(all_facts: List[Dict[str, list]], repo_root: str,
               ctxs: Dict[str, FileCtx]) -> List[Finding]:
    schema: Dict[str, List[str]] = {}
    seen_schema_file = False
    for fx in all_facts:
        if fx.get("rel") == SCHEMA_FILE:
            seen_schema_file = True
            schema = fx.get("schema") or {}
    if not seen_schema_file:
        return []   # partial scan: the schema universe is incomplete
    findings: List[Finding] = []

    def ignored(rel: str, line: int) -> bool:
        c = ctxs.get(rel)
        return c is not None and c.ignored(line, PASS_ID)

    for fx in all_facts:
        rel = fx.get("rel", "")
        if rel == SCHEMA_FILE or not rel.startswith("parsec_tpu_torch/"):
            # the schema module's own docstrings/tests stay out; so do
            # tools/tests (their emits build corpus events on purpose)
            continue
        for em in fx.get("emits", ()):
            line = em["line"]
            if ignored(rel, line):
                continue
            if not em["literal"]:
                findings.append(Finding(
                    rel, line, PASS_ID,
                    "journal.emit with a non-literal event type — the "
                    "offline auditor can only check literal types in "
                    "EVENT_SCHEMA"))
                continue
            etype = em["type"]
            if etype not in schema:
                findings.append(Finding(
                    rel, line, PASS_ID,
                    f"journal.emit({etype!r}) is not in the "
                    "EVENT_SCHEMA table (prof/journal.py) — add the "
                    "type and its required fields so journal_audit "
                    "can attribute it"))
                continue
            required = schema[etype]
            missing = [f for f in required if f not in em["kwargs"]]
            if missing and em["star"]:
                # **kwargs MAY carry them, but hides the drift this
                # pass encodes: required fields must be explicit
                findings.append(Finding(
                    rel, line, PASS_ID,
                    f"journal.emit({etype!r}) passes required "
                    f"field(s) {missing} via **kwargs — make them "
                    "explicit keywords"))
            elif missing:
                what = ("round-scoped emit must carry round="
                        if "round" in missing else "missing required")
                findings.append(Finding(
                    rel, line, PASS_ID,
                    f"journal.emit({etype!r}) is missing required "
                    f"field(s) {missing} ({what}; see EVENT_SCHEMA)"))
    return findings
