"""PCL-MCA — knob drift between registration, read sites, env, and docs.

The MCA registry (utils/mca.py) resolves UNREGISTERED names to the raw
environment string or the caller's fallback, so a typo'd
``params.get("comm_eagr_limit")`` silently returns the default forever
— and a registered knob nobody reads is dead configuration surface.
Both classes shipped and were caught only at runtime (or not at
all).  This pass reconciles, across the whole scanned tree:

* every literal ``params.get/set/unset("name")`` site against literal
  ``params.register("name", ...)`` / ``reg_int``/``reg_str``/``reg_bool``
  registrations — an unregistered reference flags at the read site, a
  never-referenced registration flags at the registration;
* ``params.get("name", default)`` fallbacks against the registered
  default — a mismatch is misleading (the registered default always
  wins at runtime), so drift between the two literals flags;
* ``PARSEC_MCA_<NAME>`` string literals (env reads, docstrings, shell
  helpers) — the lowercased knob must be registered;
* ``PARSEC_MCA_<NAME>`` mentions in COMPONENTS.md / README.md (the knob
  tables) — doc drift flags at the doc line.

Dynamic names (``params.get(framework)``, ComponentRepository's
framework registrations) are invisible to this pass by design; only
literals participate, so there are no false "unregistered" findings for
computed lookups.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Any, Dict, List, Tuple

from parsec_tpu_torch.tools.parseclint import _SKIP_DIRS, FileCtx, Finding

PASS_ID = "PCL-MCA"

_ENV_RE = re.compile(r"PARSEC_MCA_([A-Z0-9_]+)")
_REG_FNS = frozenset(("register", "reg_int", "reg_str", "reg_bool"))


def _literal(node: ast.AST) -> Any:
    return node.value if isinstance(node, ast.Constant) else None


def facts(ctx: FileCtx) -> Dict[str, List]:
    """Per-file collection, merged tree-wide by ``tree_check``."""
    registers: List[Tuple[str, Any, int, str]] = []   # name, default, line, rel
    refs: List[Tuple[str, str, Any, int, str]] = []   # name, kind, default, ...
    envs: List[Tuple[str, int, str]] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in _ENV_RE.finditer(node.value):
                envs.append((m.group(1).lower(), node.lineno, ctx.rel))
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and
                isinstance(f.value, ast.Name) and f.value.id == "params"):
            continue
        if f.attr in _REG_FNS and node.args:
            if f.attr == "register":
                name = _literal(node.args[0])
                default = _literal(node.args[1]) \
                    if len(node.args) > 1 else None
            else:   # reg_int/reg_str/reg_bool join three literal parts
                parts = [_literal(a) for a in node.args[:3]]
                if any(not isinstance(p, str) for p in parts):
                    continue
                name = "_".join(p for p in parts if p)
                default = _literal(node.args[3]) \
                    if len(node.args) > 3 else None
            if isinstance(name, str):
                registers.append((name, default, node.lineno, ctx.rel))
        elif f.attr in ("get", "set", "unset") and node.args:
            name = _literal(node.args[0])
            if isinstance(name, str):
                default = _literal(node.args[1]) \
                    if f.attr == "get" and len(node.args) > 1 else None
                refs.append((name, f.attr, default, node.lineno, ctx.rel))
    return {"registers": registers, "refs": refs, "envs": envs}


def _suppressed(ctxs: Dict[str, FileCtx], rel: str, line: int) -> bool:
    c = ctxs.get(rel)
    return c is not None and c.ignored(line, PASS_ID)


def _full_package_in_scope(repo_root: str, ctxs: Dict) -> bool:
    """Registrations are spread across the whole package, so the
    cross-checks are only sound when EVERY parsec_tpu_torch module was
    scanned — a subtree scan (``parseclint parsec_tpu_torch/utils``)
    must stay silent rather than flag knobs registered outside its
    scope.  The linter's own directory is never scanned, so it does not
    count.  A repo_root with no parsec_tpu_torch package (the synthetic
    trees the corpus tests build) is vacuously fully in scope."""
    pkg = os.path.join(repo_root, "parsec_tpu_torch")
    scanned = {rel.replace("\\", "/") for rel in ctxs}
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fn), repo_root)
            if rel.replace("\\", "/") not in scanned:
                return False
    return True


def tree_check(all_facts: List[Dict[str, List]], repo_root: str,
               ctxs: Dict[str, FileCtx]) -> List[Finding]:
    if not _full_package_in_scope(repo_root, ctxs):
        return []
    registers: Dict[str, Tuple[Any, int, str]] = {}
    refs: List[Tuple[str, str, Any, int, str]] = []
    envs: List[Tuple[str, int, str]] = []
    for fx in all_facts:
        for name, default, line, rel in fx.get("registers", ()):
            registers.setdefault(name, (default, line, rel))
        refs.extend(fx.get("refs", ()))
        envs.extend(fx.get("envs", ()))

    findings: List[Finding] = []
    referenced = {name for name, *_ in refs} | {name for name, *_ in envs}

    for name, kind, default, line, rel in refs:
        if name not in registers:
            if not _suppressed(ctxs, rel, line):
                findings.append(Finding(
                    rel, line, PASS_ID,
                    f"params.{kind}({name!r}) reads an UNREGISTERED "
                    "knob (typo, or missing params.register)"))
        elif kind == "get" and default is not None:
            reg_default = registers[name][0]
            if reg_default is not None and default != reg_default \
                    and not _suppressed(ctxs, rel, line):
                findings.append(Finding(
                    rel, line, PASS_ID,
                    f"params.get({name!r}, {default!r}) fallback drifted "
                    f"from the registered default {reg_default!r} "
                    "(the registration always wins at runtime — align "
                    "the literals)"))

    for name, (default, line, rel) in sorted(registers.items()):
        if name not in referenced and not _suppressed(ctxs, rel, line):
            findings.append(Finding(
                rel, line, PASS_ID,
                f"registered knob {name!r} is never read "
                "(dead configuration surface, or the read site uses a "
                "different spelling)"))

    for name, line, rel in envs:
        if name not in registers and not _suppressed(ctxs, rel, line):
            findings.append(Finding(
                rel, line, PASS_ID,
                f"PARSEC_MCA_{name.upper()} names an unregistered knob "
                f"({name!r})"))

    # knob tables in the docs must match the registry
    for doc in ("COMPONENTS.md", "README.md"):
        path = os.path.join(repo_root, doc)
        if not os.path.exists(path):
            continue
        with open(path, encoding="utf-8") as fh:
            for ln, text in enumerate(fh, 1):
                for m in _ENV_RE.finditer(text):
                    name = m.group(1).lower()
                    if name not in registers:
                        findings.append(Finding(
                            doc, ln, PASS_ID,
                            f"doc mentions PARSEC_MCA_{m.group(1)} but "
                            f"no knob {name!r} is registered (doc "
                            "drift)"))
    return findings
