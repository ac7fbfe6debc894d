"""PCL-ALIAS — torch stage-ins that can alias a host buffer.

A stage-in must hand the device a copy with storage of its own.  In
torch several calls that read like copies are not:

* ``torch.from_numpy(a)`` shares ``a``'s memory, and
  ``torch.as_tensor(x)`` shares it whenever dtype and device already
  match; ``data.to_host(payload)`` returns a CPU tensor or numpy
  array's own storage;
* ``t.to(...)`` returns ``t`` itself when the device and dtype already
  match (the CPU-backed module, tests, the dryrun), and
  ``t.contiguous()`` returns ``t`` when it is already contiguous;
* ``dst.copy_(src, non_blocking=True)`` from pinned host memory only
  enqueues the copy: a host that rewrites ``src`` before the stream runs
  changes what the device reads.

A later donation or in-place update of either side then corrupts the
other: the geqrf wrong-R class, which escaped more than once because
new stage-in sites kept calling the raw API instead of the wrapper.

Rule: in the device layer (``devices/``) and the ICI transport
(``comm/ici.py``), each of those calls — ``torch.from_numpy``,
``torch.as_tensor``, ``to_host``, any ``.to(...)`` or ``.contiguous()``,
and a ``copy_(..., non_blocking=...)`` — is a finding UNLESS

* it sits inside a sanctioned wrapper — a function whose ``def`` line
  carries ``# lint: alias-wrapper`` (``CudaDevice._to_device``,
  ``CudaDevice.copy_from`` and ``IciEngine._copy``, which copy into
  fresh ``torch.empty`` storage and order the copy on the streams that
  read and write both sides); or
* the call line carries ``# lint: private-ok (reason)`` — for sites
  that are alias-safe by construction (a host read that is copied
  down, a freshly created tensor nothing else holds).

Everything else must stage through those wrappers.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding

PASS_ID = "PCL-ALIAS"

_SCOPED = ("devices/", "comm/ici.py")

#: module-level functions whose result can share the argument's memory
_TORCH_ALIASING = frozenset(("from_numpy", "as_tensor"))


def _in_scope(rel: str) -> bool:
    r = rel.replace("\\", "/")
    return any(s in r for s in _SCOPED)


def _hazard(node: ast.Call) -> Optional[str]:
    """The name of the aliasing call ``node`` makes, else None."""
    f = node.func
    if isinstance(f, ast.Name):
        return "to_host" if f.id == "to_host" else None
    if not isinstance(f, ast.Attribute):
        return None
    if isinstance(f.value, ast.Name) and f.value.id == "torch" \
            and f.attr in _TORCH_ALIASING:
        return f"torch.{f.attr}"
    if f.attr == "to_host":
        return "to_host"
    if f.attr in ("to", "contiguous"):
        return f".{f.attr}()"
    if f.attr == "copy_" and any(kw.arg == "non_blocking"
                                 for kw in node.keywords):
        return ".copy_(non_blocking=...)"
    return None


def check(ctx: FileCtx) -> List[Finding]:
    if not _in_scope(ctx.rel):
        return []
    findings: List[Finding] = []

    def scan(node: ast.AST, wrapped: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            wrapped = wrapped or ctx.has_marker(node.lineno,
                                                "alias-wrapper")
        if isinstance(node, ast.Call) and not wrapped:
            what = _hazard(node)
            if what and not ctx.ignored(node.lineno, PASS_ID) and \
                    not ctx.has_marker(node.lineno, "private-ok"):
                findings.append(Finding(
                    ctx.rel, node.lineno, PASS_ID,
                    f"raw {what} stage-in can alias the host buffer "
                    "(geqrf wrong-R class) — stage through "
                    "CudaDevice._to_device / copy_from or "
                    "IciEngine._copy, or waive with "
                    "'lint: private-ok (reason)'"))
        for child in ast.iter_child_nodes(node):
            scan(child, wrapped)

    scan(ctx.tree, False)
    return findings
