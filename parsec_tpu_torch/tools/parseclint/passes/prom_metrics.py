"""PCL-PROM — metric-family drift between the exporters and the docs.

The telemetry plane's contract with operators is the README/COMPONENTS
family tables: dashboards and alert rules are written against them.
Dropping ``parsec_tasks_enabled_total`` from the registry
(it violated counter monotonicity) reconciled nothing in the docs, and
a stale doc row pointing at a family no scrape serves (or a shipped
family no doc names) is exactly the silent drift class PCL-MCA
encodes for knobs.  This pass reconciles, tree-wide:

* every ``parsec_*`` metric-family string literal exported from
  ``prof/metrics.py`` / ``prof/liveattr.py`` (plain literals full-match
  ``parsec_[a-z0-9_]+``; f-string templates like
  ``f"parsec_comm_{key}_total"`` become ``parsec_comm_*_total``
  wildcards) must be mentioned in README.md or COMPONENTS.md — an
  exact mention, a family-prefix mention (``parsec_comm_``), or a
  wildcard-matching one all satisfy it;
* every doc token that CLAIMS to be a family — ``parsec_*`` ending in
  a series suffix (``_total``/``_seconds``/``_bytes``/``_count``) —
  must match an exported literal or wildcard (doc tokens without a
  series suffix are treated as prose prefixes and only checked in the
  export->doc direction, so reference-C symbol mentions like
  ``parsec_matrix_block_cyclic_kview`` stay out of scope).

Scope-gated like PCL-MCA: the cross-check only runs when every
exporter module that exists under the repo root was scanned, so a
subtree scan stays silent instead of flagging families exported
outside its view.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Dict, List, Tuple

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding

PASS_ID = "PCL-PROM"

#: the modules whose ``parsec_*`` string literals ARE the scrape
#: surface (prof/metrics.py collectors, prof/liveattr.py stragglers,
#: and the recovery coordinator's scrape-time collector, whose
#: families are part of the documented README/COMPONENTS contract)
EXPORT_FILES = ("parsec_tpu_torch/prof/metrics.py",
                "parsec_tpu_torch/prof/liveattr.py",
                "parsec_tpu_torch/core/recovery.py")

DOC_FILES = ("README.md", "COMPONENTS.md")

_NAME_RE = re.compile(r"^parsec_[a-z0-9_]+$")
_DOC_RE = re.compile(r"parsec_[a-z0-9_]+")
#: doc tokens carrying one of these suffixes claim to name a concrete
#: series and must resolve against the exporters
_SERIES_SUFFIXES = ("_total", "_seconds", "_bytes", "_count")

#: not metric families: the package names (the docs name both)
_EXCLUDE = frozenset(("parsec_tpu", "parsec_tpu_torch"))


def _fstring_pattern(node: ast.JoinedStr) -> str:
    """f-string -> fnmatch pattern (constant parts kept, each
    formatted placeholder a ``*``); empty when it cannot be a family
    template."""
    parts: List[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append("*")
    pat = "".join(parts)
    return pat if pat.startswith("parsec_") else ""


def facts(ctx: FileCtx) -> Dict[str, List]:
    """Exported family literals of one exporter module (empty for
    every other file)."""
    if ctx.rel.replace("\\", "/") not in EXPORT_FILES:
        return {}
    names: List[Tuple[str, int]] = []
    patterns: List[Tuple[str, int]] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if _NAME_RE.match(node.value) \
                    and node.value not in _EXCLUDE:
                names.append((node.value, node.lineno))
        elif isinstance(node, ast.JoinedStr):
            pat = _fstring_pattern(node)
            if pat and "*" in pat:
                patterns.append((pat, node.lineno))
    return {"names": names, "patterns": patterns,
            "rel": ctx.rel.replace("\\", "/")}


def _doc_mentions(repo_root: str) -> List[Tuple[str, str, int]]:
    out: List[Tuple[str, str, int]] = []
    for doc in DOC_FILES:
        path = os.path.join(repo_root, doc)
        if not os.path.exists(path):
            continue
        with open(path, encoding="utf-8") as fh:
            for ln, text in enumerate(fh, 1):
                for m in _DOC_RE.finditer(text):
                    tok = m.group(0)
                    if tok not in _EXCLUDE:
                        out.append((tok, doc, ln))
    return out


def _covered(name: str, tokens: List[str]) -> bool:
    """An exported family is documented when some doc token names it
    exactly or is a prefix of it (the README writes whole families as
    ``parsec_comm_...`` prefixes)."""
    return any(name == t or name.startswith(t) for t in tokens)


def _resolves(tok: str, names: List[str], patterns: List[str]) -> bool:
    """A doc series token resolves against an exported literal, an
    exported prefix of it, or a template wildcard."""
    if any(tok == n or n.startswith(tok) or tok.startswith(n)
           for n in names):
        return True
    return any(fnmatch.fnmatchcase(tok, p) or p.startswith(tok)
               for p in patterns)


def _suppressed(ctxs: Dict[str, FileCtx], rel: str, line: int) -> bool:
    c = ctxs.get(rel)
    return c is not None and c.ignored(line, PASS_ID)


def tree_check(all_facts: List[Dict[str, List]], repo_root: str,
               ctxs: Dict[str, FileCtx]) -> List[Finding]:
    scanned = {rel.replace("\\", "/") for rel in ctxs}
    exporters_present = [f for f in EXPORT_FILES
                         if os.path.exists(os.path.join(repo_root, f))]
    if not exporters_present:
        return []
    if any(f not in scanned for f in exporters_present):
        return []   # partial scan: the export set would be incomplete
    names: List[Tuple[str, int, str]] = []
    patterns: List[Tuple[str, int, str]] = []
    for fx in all_facts:
        rel = fx.get("rel")
        if not rel:
            continue
        names.extend((n, ln, rel) for n, ln in fx.get("names", ()))
        patterns.extend((p, ln, rel)
                        for p, ln in fx.get("patterns", ()))
    mentions = _doc_mentions(repo_root)
    tokens = [t for t, _d, _l in mentions]
    findings: List[Finding] = []

    for name, line, rel in names:
        if not _covered(name, tokens) \
                and not _suppressed(ctxs, rel, line):
            findings.append(Finding(
                rel, line, PASS_ID,
                f"metric family {name!r} is exported but mentioned in "
                "neither README.md nor COMPONENTS.md (operators write "
                "dashboards against the doc tables — document it or "
                "drop the series)"))
    for pat, line, rel in patterns:
        prefix = pat.split("*", 1)[0]
        if not any(t.startswith(prefix) or prefix.startswith(t)
                   for t in tokens) \
                and not _suppressed(ctxs, rel, line):
            findings.append(Finding(
                rel, line, PASS_ID,
                f"metric-family template {pat!r} has no README.md/"
                "COMPONENTS.md mention covering its prefix"))

    name_list = [n for n, _l, _r in names]
    pat_list = [p for p, _l, _r in patterns]
    for tok, doc, line in mentions:
        if not tok.endswith(_SERIES_SUFFIXES):
            continue
        if not _resolves(tok, name_list, pat_list):
            findings.append(Finding(
                doc, line, PASS_ID,
                f"doc mentions metric family {tok!r} but the "
                "exporters serve no such series (the "
                "parsec_tasks_enabled_total drop class — stale doc "
                "row, or a renamed family)"))
    return findings
