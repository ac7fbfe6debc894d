"""parseclint driver: file discovery, per-file parallel analysis,
tree-level cross-checks, baseline filtering, reporting."""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from parsec_tpu_torch.tools.parseclint import _SKIP_DIRS, FileCtx, Finding
from parsec_tpu_torch.tools.parseclint.passes import ALL_PASSES

#: repo root = the directory holding parsec_tpu_torch/ (doc paths and
#: repo-relative finding paths anchor here, independent of cwd)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.txt")



def discover(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d not in _SKIP_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def analyze_file(path: str):
    """One file through every per-file pass; returns (rel, findings,
    {pass_id: facts}, comment-view, error-or-empty).  Runs in worker
    processes; the comment view rides back so the driver's tree-level
    passes never re-parse the file."""
    rel = os.path.relpath(path, REPO_ROOT)
    try:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        ctx = FileCtx(path, rel, source)
    except (OSError, SyntaxError, ValueError) as exc:
        return rel, [], {}, None, f"{rel}: unparseable: {exc}"
    findings: List[Finding] = []
    facts: Dict[str, dict] = {}
    for mod in ALL_PASSES:
        check = getattr(mod, "check", None)
        if check is not None:
            findings.extend(check(ctx))
        fact_fn = getattr(mod, "facts", None)
        if fact_fn is not None:
            facts[mod.PASS_ID] = fact_fn(ctx)
    return rel, findings, facts, ctx.comment_view(), ""


def _analyze_parallel(files: List[str], jobs: int):
    if jobs <= 1 or len(files) < 8:
        return [analyze_file(f) for f in files]
    try:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        mp_ctx = mp.get_context("fork") if hasattr(os, "fork") else None
        with ProcessPoolExecutor(max_workers=jobs,
                                 mp_context=mp_ctx) as pool:
            return list(pool.map(analyze_file, files, chunksize=4))
    except Exception:
        # any pool failure (sandbox, recursion in spawn) degrades to
        # serial — the analysis result must not depend on the executor
        return [analyze_file(f) for f in files]


def load_baseline(path: str) -> Dict[str, int]:
    """baseline key -> allowed count (a key listed N times admits N
    findings with that identity)."""
    out: Dict[str, int] = {}
    if not path or not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                out[line] = out.get(line, 0) + 1
    return out


def run(paths: Iterable[str], baseline_path: Optional[str] = None,
        jobs: Optional[int] = None,
        use_processes: bool = True) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Analyze ``paths``; returns (new_findings, baselined, errors)."""
    files = discover(paths)
    njobs = jobs if jobs is not None else min(8, os.cpu_count() or 1)
    if not use_processes:
        njobs = 1
    results = _analyze_parallel(files, njobs)

    findings: List[Finding] = []
    errors: List[str] = []
    all_facts: Dict[str, List[dict]] = {}
    ctxs: Dict[str, object] = {}   # rel -> CommentView (from the workers)
    for rel, per_file, facts, view, err in results:
        findings.extend(per_file)
        if err:
            errors.append(err)
        if view is not None:
            ctxs[rel] = view
        for pid, fx in facts.items():
            all_facts.setdefault(pid, []).append(fx)

    for mod in ALL_PASSES:
        tree_check = getattr(mod, "tree_check", None)
        if tree_check is not None:
            findings.extend(tree_check(all_facts.get(mod.PASS_ID, []),
                                       REPO_ROOT, ctxs))

    findings.sort(key=lambda f: (f.path, f.line, f.pass_id))
    allowed = load_baseline(baseline_path if baseline_path is not None
                            else DEFAULT_BASELINE)
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        key = f.baseline_key()
        if allowed.get(key, 0) > 0:
            allowed[key] -= 1
            baselined.append(f)
        else:
            new.append(f)
    return new, baselined, errors


_BASELINE_HEADER = (
    "# parseclint baseline for parsec_tpu_torch: deliberate divergences\n"
    "# only (line-number-free keys), each under '#' lines giving its\n"
    "# reason and its ROADMAP Queue 3 entry.  A fault is repaired, never\n"
    "# listed here.  Regenerate with:\n"
    "#   python -m parsec_tpu_torch.tools.parseclint --write-baseline\n"
    "#\n")


def baseline_reasons(path: str) -> Dict[str, List[str]]:
    """baseline key -> the ``#`` lines directly above it (its reason),
    after the last lone ``#`` line of that block (which ends the file's
    header)."""
    out: Dict[str, List[str]] = {}
    if not path or not os.path.exists(path):
        return out
    block: List[str] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line == "#":
                block = []
            elif line.startswith("#"):
                block.append(line)
            elif line:
                out.setdefault(line, block)
                block = []
    return out


def write_baseline(findings: List[Finding], path: str) -> None:
    """Write ``findings`` as the baseline, keeping the reason lines of
    the keys the old file already held.  Only deliberate divergences
    belong in it: a key written without a reason fails the clean-tree
    test until one is added above it."""
    reasons = baseline_reasons(path)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(_BASELINE_HEADER)
        for f in findings:
            key = f.baseline_key()
            for line in reasons.get(key, ()):
                fh.write(line + "\n")
            fh.write(key + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="parseclint",
        description="project-specific static analysis for parsec_tpu_torch")
    ap.add_argument("paths", nargs="*", default=["parsec_tpu_torch"],
                    help="files/directories to analyze "
                         "(default: parsec_tpu_torch)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baseline ignored")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline")
    ap.add_argument("--jobs", type=int, default=None,
                    help="parallel analysis processes (default: auto)")
    ap.add_argument("--serial", action="store_true",
                    help="single-process analysis (debugging)")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--list-passes", action="store_true")
    args = ap.parse_args(argv)

    if args.list_passes:
        for mod in ALL_PASSES:
            doc = (mod.__doc__ or "").strip().splitlines()[0]
            print(f"{mod.PASS_ID:12s} {doc}")
        return 0

    paths = args.paths or ["parsec_tpu_torch"]
    paths = [p if os.path.isabs(p) else
             (p if os.path.exists(p) else os.path.join(REPO_ROOT, p))
             for p in paths]
    files = discover(paths)   # once; run() passes file paths through
    baseline = "" if args.no_baseline else args.baseline
    new, baselined, errors = run(files, baseline_path=baseline,
                                 jobs=args.jobs,
                                 use_processes=not args.serial)

    if args.write_baseline:
        target = args.baseline or DEFAULT_BASELINE
        write_baseline(new + baselined, target)
        print(f"parseclint: wrote {len(new) + len(baselined)} finding(s)"
              f" to {target}")
        return 0

    for f in new:
        print(f.render())
    for e in errors:
        print(f"parseclint: ERROR {e}", file=sys.stderr)
    if not args.quiet:
        note = f", {len(baselined)} baselined" if baselined else ""
        status = "clean" if not new else f"{len(new)} finding(s)"
        print(f"parseclint: {status}{note} ({len(files)} files)",
              file=sys.stderr)
    return 1 if (new or errors) else 0
