"""parseclint — project-specific static analysis for parsec_tpu_torch.

Encodes the runtime's concurrency, aliasing, and knob invariants as
AST-level passes (stdlib ``ast`` only, no dependencies).  Each pass
corresponds to a bug class this runtime has actually shipped and fixed:

  PCL-LOCK    ``# guarded-by:`` lock discipline on shared mutable state
  PCL-EVLOOP  blocking calls reachable from event-loop callbacks
  PCL-HOT     per-task lock round-trips in the task hot path
  PCL-ALIAS   torch stage-ins that can alias a host buffer
              (``torch.from_numpy``, same-device ``.to()``,
              ``.contiguous()``, ``non_blocking`` copies) outside the
              sanctioned stage-in wrappers
  PCL-MCA     MCA knob drift: unregistered reads, unread registrations,
              default mismatches, env/doc typos
  PCL-PROM    metric-family drift between the exporters and the docs
  PCL-JRNL    control-plane journal schema drift
  PCL-EXCEPT  containment-path exception hygiene (PeerFailedError must
              stay per-pool, never swallowed or context-global)
  PCL-ASSERT  asserts ``python -O`` would strip: side-effecting
              conditions and module-level (import-time) invariants

Run:        python -m parsec_tpu_torch.tools.parseclint [paths]
            (default path: the parsec_tpu_torch package)
Suppress:   trailing ``# lint: ignore[PCL-XXX] reason`` on the flagged
            line (or the line above), or record the finding in
            parsec_tpu_torch/tools/parseclint/baseline.txt — which holds
            only deliberate divergences, each under a ``#`` line giving
            its reason.
Annotate:   see each pass module's docstring for its source-level
            annotation conventions (guarded-by / holds-lock / on-loop /
            off-loop / alias-wrapper and the per-pass waivers).
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Optional

#: directories never scanned: the linter itself stays out of its own
#: view (its pass docstrings and tests quote the hazards it flags)
_SKIP_DIRS = frozenset(("__pycache__", ".git", "parseclint"))

_IGNORE_RE = re.compile(r"lint:\s*ignore(?:\[([A-Z0-9, -]+)\])?")


@dataclass(frozen=True)
class Finding:
    """One structured finding: ``{path}:{line}: {pass_id} {message}``."""

    path: str        # repo-relative
    line: int
    pass_id: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.pass_id} {self.message}"

    def baseline_key(self) -> str:
        """Line-number-free identity so accepted findings survive
        unrelated edits shifting line numbers."""
        return f"{self.path}|{self.pass_id}|{self.message}"


class _CommentLookup:
    """Suppression/annotation lookups over a comment map.  Subclasses
    provide ``comments`` ({line: text}) and ``_comment_lines`` (line
    numbers that are comment-ONLY lines)."""

    comments: Dict[int, str]
    _comment_lines: frozenset

    def comment_near(self, line: int) -> str:
        """The comment text attached to ``line``: trailing, or the
        directly preceding comment-only line."""
        parts = []
        if line in self.comments:
            parts.append(self.comments[line])
        prev = line - 1
        if prev in self.comments and prev in self._comment_lines:
            parts.append(self.comments[prev])
        return " ".join(parts)

    def ignored(self, line: int, pass_id: str) -> bool:
        m = _IGNORE_RE.search(self.comment_near(line))
        if not m:
            return False
        ids = m.group(1)
        return ids is None or pass_id in {s.strip()
                                          for s in ids.split(",")}

    def has_marker(self, line: int, marker: str) -> bool:
        """True when ``line`` (or the comment line above) carries the
        given ``lint: <marker>`` waiver/annotation."""
        return f"lint: {marker}" in self.comment_near(line)

    def comment_block_above(self, line: int, span: int = 6) -> str:
        """The contiguous comment block ending just above ``line`` —
        where ``#:`` attribute doc-comments (and their ``guarded-by:``
        annotations) live."""
        parts: List[str] = []
        ln = line - 1
        while ln > 0 and ln >= line - span and ln in self.comments \
                and ln in self._comment_lines:
            parts.append(self.comments[ln])
            ln -= 1
        return " ".join(reversed(parts))


class CommentView(_CommentLookup):
    """Picklable comment/suppression view — the subset of FileCtx the
    driver's tree-level passes need, shipped back from analysis workers
    so the driver never re-parses a file."""

    def __init__(self, comments: Dict[int, str], comment_lines):
        self.comments = comments
        self._comment_lines = frozenset(comment_lines)


class FileCtx(_CommentLookup):
    """Everything a per-file pass needs: source, AST, and the comment
    map ``ast`` discards (annotations and waivers live in comments)."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.comments: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass   # ast.parse accepted it; comments stay best-effort
        self._comment_lines = frozenset(
            ln for ln in self.comments
            if self.lines[ln - 1].lstrip().startswith("#"))

    def comment_view(self) -> CommentView:
        return CommentView(self.comments, self._comment_lines)


def self_attr(node: ast.AST) -> Optional[str]:
    """``self.<name>`` -> name, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None
