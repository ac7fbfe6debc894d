"""Textual JDF front-end: parse the reference's task-graph language into
the embedded PTG API.

The reference's defining artifact is a compiler for the JDF language
(reference: parsec/interfaces/ptg/ptg-compiler/parsec.y grammar,
parsec.l:141-159 tokens, main.c) emitting C.  Here the same
surface syntax is parsed into the Python-embedded PTG API
(dsl/ptg/api.py) — no code generation: globals become taskpool globals,
execution-space ranges become ``Range`` params, partitioning becomes
affinity, dependency lines become guarded IN/OUT deps, and ``BODY``
blocks are mapped to caller-supplied Python/torch callables (inline C is
NOT executed; an unmapped body raises a clear error at execution).

Supported grammar subset (everything the reference's example corpus
uses — Ex01..Ex07, tests/apps/stencil/stencil_1D.jdf, and
tests/runtime/multichain.jdf, all golden-run in test_jdf_parser.py):

- ``extern "C" %{ ... %}`` prologue/epilogue blocks (captured verbatim,
  not executed),
- globals with ``[ type=... hidden=on default=... ]`` properties,
- task execution space: ``k = lo .. hi`` / ``lo .. hi .. step`` ranges
  and derived locals ``name = expr``,
- inline-C ``%{ ... return EXPR; %}`` blocks: a declaration /
  (compound-)assignment / return statement subset translates to one
  Python expression via sequenced assignment expressions; control flow
  is rejected,
- partitioning ``: data( exprs )``,
- flows ``RW|READ|WRITE|CTL name`` with guarded, possibly ternary
  endpoints ``(g) ? A Task(p) : B Other(p)``, range targets
  ``A Task( k, 0 .. NB .. 2 )``, ``NEW``/``NULL`` endpoints, and
  ``[ ... ]`` annotations (``type``/``type_remote`` looked up in the
  caller's ``dtts`` map),
- ``BODY [...] { ... } END`` (C source captured; annotation tolerated).

C expressions are translated to Python (&&/||/!/ternary/-> field
access), evaluated against the task's parameters, derived locals, and
the taskpool globals — the same binding rules the generated code uses
(reference: jdf2c.c expression evaluators, :2244).

The port's copy of the JAX package's dsl/ptg/jdf.py.  Its one deliberate
difference: a ``(device_kernel, cpu_fn)`` body binds the kernel as a
``device="cuda"`` body (the CUDA device module) where the JAX package
binds ``device="tpu"``.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from parsec_tpu_torch.dsl.ptg.api import (DATA, IN, NEW, NULL_END, OUT,
                                          PTG, Range, TASK)


class JdfError(ValueError):
    pass


# ---------------------------------------------------------------------------
# C-expression -> Python translation
# ---------------------------------------------------------------------------

_INLINE_C = re.compile(r"%\{(.*?)%\}", re.S)


#: C declaration/assignment statement: ``[type] name [op]= expr``
_C_STMT = re.compile(
    r"^\s*(?:(?:unsigned\s+|signed\s+|const\s+)*"
    r"(?:int|long|short|float|double|char|size_t|uint\d+_t|int\d+_t)\s+)?"
    r"(\w+)\s*(\+|-|\*|/|%)?=(?!=)\s*(.+)$", re.S)


def _inline_c_expr(body: str) -> str:
    """Translate an inline-C block to ONE Python expression.

    ``%{ return EXPR; %}`` maps directly.  A small statement subset —
    declarations, (compound) assignments, then a final return
    (reference compiles arbitrary C, jdf2c.c:8163; this covers the
    idioms the corpus uses) — translates via assignment expressions
    sequenced in a tuple: ``int r = k+1; r *= 2; return r;`` becomes
    ``((r := (k+1)), (r := r * (2)), (r))[-1]``.  Anything else
    (loops, calls with side effects, conditionals) is rejected."""
    stmts = [s.strip() for s in _split_top(body, ";") if s.strip()]
    if not stmts:
        raise JdfError("empty inline C block")
    if not re.match(r"^return\b", stmts[-1]):
        raise JdfError(
            f"inline C must end in 'return EXPR;': {body.strip()[:60]!r}")
    final = stmts[-1][len("return"):].strip()
    if len(stmts) == 1:
        return final
    parts = []
    for s in stmts[:-1]:
        m = _C_STMT.match(s)
        if not m:
            raise JdfError(
                f"inline C statement outside the declaration/assignment/"
                f"return subset: {s[:60]!r}")
        name, op, rhs = m.group(1), m.group(2), m.group(3)
        if op:
            parts.append(f"({name} := {name} {op} ({rhs}))")
        else:
            parts.append(f"({name} := ({rhs}))")
    parts.append(f"({final})")
    # immediately-invoked lambda: walrus targets stay lambda-local (no
    # collision with range-dep comprehension variables) and the result
    # is legal anywhere an expression is — a bare walrus would be a
    # SyntaxError in a comprehension's iterable position
    return ("(lambda: (" + ", ".join(parts) + ")[-1])()")


def _translate_ternary(s: str) -> str:
    """C ternary ``a ? b : c`` -> Python conditional, recursively,
    splitting only at paren-depth 0."""
    depth = 0
    for i, ch in enumerate(s):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "?" and depth == 0:
            cond = s[:i]
            rest = s[i + 1:]
            d2 = 0
            for j, c2 in enumerate(rest):
                if c2 in "([":
                    d2 += 1
                elif c2 in ")]":
                    d2 -= 1
                elif c2 == ":" and d2 == 0:
                    a, b = rest[:j], rest[j + 1:]
                    return (f"(({_translate_ternary(a)}) if "
                            f"({_translate_ternary(cond)}) else "
                            f"({_translate_ternary(b)}))")
            raise JdfError(f"ternary without ':' in {s!r}")
    return s


def _c_div(a, b):
    """C ``/`` semantics: truncation toward zero when both operands are
    integral (Python ``/`` would yield a float and silently build a
    wrong task space), true division otherwise."""
    if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
        q = abs(a) // abs(b)
        return -q if (a < 0) != (b < 0) else q
    return a / b


def _c_mod(a, b):
    """C ``%`` semantics: remainder truncates toward zero (Python floors)."""
    if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
        return a - _c_div(a, b) * b
    return a % b


#: names injected into every namespace that evaluates c2py() output
C_EVAL_HELPERS = {"_c_div": _c_div, "_c_mod": _c_mod}


class _CArithTransform(ast.NodeTransformer):
    """Rewrite ``a / b`` -> ``_c_div(a, b)`` and ``a % b`` ->
    ``_c_mod(a, b)`` so integral JDF index math keeps C semantics."""

    def visit_BinOp(self, node):
        self.generic_visit(node)
        fn = ("_c_div" if isinstance(node.op, ast.Div)
              else "_c_mod" if isinstance(node.op, ast.Mod) else None)
        if fn is None:
            return node
        return ast.copy_location(
            ast.Call(func=ast.Name(id=fn, ctx=ast.Load()),
                     args=[node.left, node.right], keywords=[]), node)


def _c_arith(expr: str) -> str:
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError:
        return expr     # let the later compile step surface the error
    if not any(isinstance(n, ast.BinOp) and
               isinstance(n.op, (ast.Div, ast.Mod))
               for n in ast.walk(tree)):
        return expr
    return ast.unparse(ast.fix_missing_locations(
        _CArithTransform().visit(tree)))


def c2py(expr: str) -> str:
    """Translate a C expression (as appearing in JDF ranges, guards and
    index expressions) to Python source."""
    expr = expr.strip()
    expr = _INLINE_C.sub(lambda m: "(" + _inline_c_expr(m.group(1)) + ")",
                         expr)
    expr = expr.replace("->", ".")
    expr = expr.replace("&&", " and ").replace("||", " or ")
    # logical not: '!' not part of '!='
    expr = re.sub(r"!(?!=)", " not ", expr)
    expr = _translate_ternary(expr)
    return _c_arith(expr.strip())


def _split_top(s: str, sep: str) -> List[str]:
    """Split on ``sep`` at paren-depth 0."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

class JdfGlobal:
    def __init__(self, name: str, props: Dict[str, str]):
        self.name = name
        self.props = props


class JdfEndpoint:
    """One side of a dependency arrow."""

    def __init__(self, kind: str, flow: Optional[str] = None,
                 target: Optional[str] = None,
                 args: Optional[List[str]] = None):
        self.kind = kind          # "task" | "data" | "new" | "null"
        self.flow = flow          # peer flow name (task kind)
        self.target = target      # task or data name
        self.args = args or []    # raw C argument expressions


class JdfDep:
    def __init__(self, direction: str, guard: Optional[str],
                 ep: JdfEndpoint, alt: Optional[JdfEndpoint],
                 props: Dict[str, str]):
        self.direction = direction            # "in" | "out"
        self.guard = guard                    # raw C guard or None
        self.ep = ep
        self.alt = alt                        # ':' branch of a ternary
        self.props = props                    # [ type=... ] annotations


class JdfFlow:
    def __init__(self, access: str, name: str):
        self.access = access                  # RW | READ | WRITE | CTL
        self.name = name
        self.deps: List[JdfDep] = []


class JdfTask:
    def __init__(self, name: str, params: List[str],
                 props: Optional[Dict[str, str]] = None):
        self.name = name
        self.params = params          # HEADER params: the free addressing
        self.props = props or {}      # [ make_key_fn=... startup_fn=... ]
        #: execution-space definitions in DECLARATION ORDER — ranges and
        #: derived locals interleave (BT_reduction.jdf: a local between
        #: two ranges feeds the later range's bounds)
        self.defs: List[Tuple] = []   # ("range", n, lo, hi, step) |
        #                               ("local", n, expr)
        self.partition: Optional[Tuple[str, List[str]]] = None
        self.flows: List[JdfFlow] = []
        self.body_src: str = ""
        self.body_props: Dict[str, str] = {}

    @property
    def ranges(self) -> List[Tuple[str, str, str, Optional[str]]]:
        return [(d[1], d[2], d[3], d[4]) for d in self.defs
                if d[0] == "range"]

    @property
    def locals(self) -> List[Tuple[str, str]]:
        return [(d[1], d[2]) for d in self.defs if d[0] == "local"]

    @property
    def def_names(self) -> List[str]:
        return [d[1] for d in self.defs]


class JdfFile:
    def __init__(self):
        self.externs: List[str] = []
        self.globals: List[JdfGlobal] = []
        self.tasks: List[JdfTask] = []
        self.options: Dict[str, str] = {}     # %option lines


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_PROPS = re.compile(r"(\w+)\s*=\s*(\"[^\"]*\"|\S+)")


def _parse_props(s: str) -> Dict[str, str]:
    out = {}
    for k, v in _PROPS.findall(s):
        out[k] = v.strip('"')
    return out


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def parse_jdf(text: str) -> JdfFile:
    """Parse JDF source into an AST (reference grammar: parsec.y)."""
    jdf = JdfFile()

    def grab_extern(m):
        jdf.externs.append(m.group(1))
        return ""
    text = re.sub(r"extern\s+\"C\"\s*%\{(.*?)%\}", grab_extern, text,
                  flags=re.S)
    # protect inline-C expressions from comment/line processing
    inlines: List[str] = []

    def protect(m):
        inlines.append(m.group(0))
        return f"\x00{len(inlines) - 1}\x00"
    text = _INLINE_C.sub(protect, text)
    text = _strip_comments(text)

    def unprotect(s: str) -> str:
        return re.sub(r"\x00(\d+)\x00", lambda m: inlines[int(m.group(1))],
                      s)

    # split off BODY blocks first (they contain arbitrary C)
    lines = text.splitlines()
    i = 0
    task: Optional[JdfTask] = None
    flow: Optional[JdfFlow] = None
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line:
            continue
        if line.startswith("BODY"):
            if task is None:
                raise JdfError("BODY outside a task")
            task.body_props = _parse_props(line[4:].strip(" []"))
            body: List[str] = []
            while i < len(lines):
                l2 = lines[i]
                i += 1
                if l2.strip() == "END":
                    break
                body.append(l2)
            else:
                raise JdfError(f"task {task.name}: BODY without END")
            task.body_src = unprotect("\n".join(body))
            flow = None
            continue
        # dependency continuation (<- / ->)
        if line.startswith("<-") or line.startswith("->"):
            if flow is None:
                raise JdfError(f"dangling dependency line: {line!r}")
            flow.deps.append(_parse_dep(unprotect(line)))
            continue
        # flow header: ACCESS name [deps...]
        m = re.match(r"^(RW|READ|WRITE|CTL)\s+(\w+)\s*(.*)$", line)
        if m and task is not None:
            flow = JdfFlow(m.group(1), m.group(2))
            task.flows.append(flow)
            rest = m.group(3).strip()
            if rest:
                flow.deps.append(_parse_dep(unprotect(rest)))
            continue
        # partitioning
        if line.startswith(":") and task is not None:
            mm = re.match(r":\s*(\w+)\s*\((.*)\)\s*$", line)
            if not mm:
                raise JdfError(f"bad partitioning line {line!r}")
            task.partition = (mm.group(1),
                              [unprotect(a.strip())
                               for a in _split_top(mm.group(2), ",")])
            continue
        # %option name = value (reference: parsec.y options rule; e.g.
        # "%option dynamic = ON", "%option no_taskpool_instance = true")
        if line.startswith("%option"):
            for k, v in _PROPS.findall(unprotect(line[len("%option"):])):
                jdf.options[k] = v.strip('"')
            continue
        # definition: name = range/expr
        m = re.match(r"^(\w+)\s*=\s*(.+)$", line)
        if m and task is not None:
            name, rhs = m.group(1), unprotect(m.group(2).strip())
            parts = [p.strip() for p in re.split(r"\.\.", rhs)]
            if name in task.params:
                if len(parts) == 2:
                    task.defs.append(("range", name, parts[0], parts[1],
                                      None))
                elif len(parts) == 3:
                    task.defs.append(("range", name, parts[0], parts[1],
                                      parts[2]))
                else:
                    raise JdfError(
                        f"task {task.name}: parameter {name} needs a "
                        f"'lo .. hi' range, got {rhs!r}")
            else:
                if len(parts) != 1:
                    raise JdfError(
                        f"task {task.name}: derived local {name} cannot "
                        f"be a range")
                task.defs.append(("local", name, rhs))
            continue
        # global: NAME [ props ]
        m = re.match(r"^(\w+)\s*\[(.*)\]\s*$", line)
        if m and task is None:
            jdf.globals.append(JdfGlobal(m.group(1),
                                         _parse_props(unprotect(m.group(2)))))
            continue
        # task header: Name(a, b) [ props... ] — the property block may
        # span lines (project_dyn.jdf:43-44)
        m = re.match(r"^(\w+)\s*\(([^)]*)\)\s*(\[.*)?$", line)
        if m:
            propsrc = m.group(3) or ""
            while propsrc.count("[") > propsrc.count("]") \
                    and i < len(lines):
                propsrc += " " + lines[i].strip()
                i += 1
            task = JdfTask(m.group(1),
                           [p.strip() for p in m.group(2).split(",")
                            if p.strip()],
                           props=_parse_props(
                               unprotect(propsrc.strip(" []"))))
            jdf.tasks.append(task)
            flow = None
            continue
        raise JdfError(f"unrecognized JDF line: {line!r}")
    return jdf


def _parse_dep(line: str) -> JdfDep:
    direction = "in" if line.startswith("<-") else "out"
    rest = line[2:].strip()
    props: Dict[str, str] = {}
    pm = re.search(r"\[([^\]]*)\]\s*$", rest)
    if pm:
        props = _parse_props(pm.group(1))
        rest = rest[:pm.start()].strip()
    guard = None
    alt = None
    # guard: any top-level '?' splits "<expr> ? endpoint [: alt]" — the
    # expression need not be parenthesized (project_dyn.jdf:52
    # "larger_than_thresh ? RL PROJECT(...)")
    depth = 0
    for i, ch in enumerate(rest):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "?" and depth == 0:
            guard = rest[:i].strip()
            rest = rest[i + 1:].strip()
            break
    if guard is not None:
        branches = _split_top(rest, ":")
        if len(branches) == 2:
            ep = _parse_endpoint(branches[0].strip())
            alt = _parse_endpoint(branches[1].strip())
        else:
            ep = _parse_endpoint(rest)
    else:
        ep = _parse_endpoint(rest)
    return JdfDep(direction, guard, ep, alt, props)


def _parse_endpoint(s: str) -> JdfEndpoint:
    s = s.strip()
    if s == "NEW":
        return JdfEndpoint("new")
    if s == "NULL":
        return JdfEndpoint("null")
    m = re.match(r"^(\w+)\s+(\w+)\s*\((.*)\)\s*$", s)
    if m:
        return JdfEndpoint("task", flow=m.group(1), target=m.group(2),
                           args=[a.strip()
                                 for a in _split_top(m.group(3), ",")])
    m = re.match(r"^(\w+)\s*\((.*)\)\s*$", s)
    if m:
        return JdfEndpoint("data", target=m.group(1),
                           args=[a.strip()
                                 for a in _split_top(m.group(2), ",")])
    raise JdfError(f"unparseable dependency endpoint {s!r}")


# ---------------------------------------------------------------------------
# AST -> embedded PTG
# ---------------------------------------------------------------------------

def _compile_fn(expr_py: str, params: List[str],
                derived: List[Tuple[str, str]], env: Dict[str, Any],
                list_wrap: Optional[List[Tuple[str, str, str, str]]] = None):
    """Build a real function ``f(params...)`` evaluating ``expr_py``
    after computing the task's derived locals (the JDF 'name = expr'
    definitions); ``list_wrap`` adds range-comprehension variables for
    range deps."""
    body = ["def _f(" + ", ".join(params) + "):"]
    for name, dexpr in derived:
        body.append(f"    {name} = ({c2py(dexpr)})")
    if list_wrap:
        comp = expr_py
        for var, lo, hi, step in list_wrap:
            comp += (f" for {var} in range(({c2py(lo)}), ({c2py(hi)}) + 1, "
                     f"({c2py(step) if step else 1}))")
        body.append(f"    return [{comp}]")
    else:
        body.append(f"    return ({expr_py})")
    ns: Dict[str, Any] = dict(env)
    exec("\n".join(body), ns)          # noqa: S102 — trusted build-time DSL
    return ns["_f"]


def _single_valued(vf, names: List[str]):
    """Derived local -> single-valued parameter range: the value function
    (over the preceding definition names) evaluated once per instance."""
    def fn(globals_, locals_):
        return [vf(*[locals_[n] for n in names])]
    return fn


def _missing_body(task_name: str):
    def body(*_a, **_k):
        raise RuntimeError(
            f"JDF task {task_name!r} has an inline-C body that was not "
            f"mapped to Python — pass bodies={{{task_name!r}: fn}} to "
            f"jdf_taskpool()")
    return body


def jdf_taskpool(source: str, *, globals: Optional[Dict[str, Any]] = None,
                 data: Optional[Dict[str, Any]] = None,
                 bodies: Optional[Dict[str, Any]] = None,
                 arenas: Optional[Dict[str, Tuple[Tuple[int, ...], Any]]]
                 = None,
                 dtts: Optional[Dict[str, Any]] = None,
                 funcs: Optional[Dict[str, Any]] = None,
                 name: Optional[str] = None):
    """Parse JDF ``source`` (text or a path ending in .jdf) and build a
    runnable taskpool.

    ``globals``: values for the JDF globals (collections included).
    ``data``: name -> data collection for partitioning/data endpoints
    (defaults to any collection-valued globals).
    ``bodies``: task name -> Python callable (or (device_kernel, cpu_fn)
    tuple) replacing the inline-C BODY.
    ``arenas``: arena name -> (shape, dtype) for NEW endpoints; a single
    ``"default"`` entry serves JDF NEW (which is untyped in the text).
    ``dtts``: annotation value (``type``/``type_remote``) -> dtt object.
    ``funcs``: C-function name -> Python callable for task-level
    properties (``make_key_fn`` over named params; ``startup_fn`` as
    ``fn(globals_, rank) -> iterable of seed param dicts`` for
    ``%option dynamic = ON`` pools — project_dyn.jdf:43-44,109-159).
    """
    if source.endswith(".jdf") and "\n" not in source:
        with open(source) as fh:
            text = fh.read()
        if name is None:
            name = re.sub(r"\.jdf$", "", source.rsplit("/", 1)[-1])
    else:
        text = source
    jdf = parse_jdf(text)
    gvals = dict(globals or {})
    for g in jdf.globals:
        if g.name in gvals:
            continue
        if data and g.name in data:
            gvals[g.name] = data[g.name]    # collection-typed global
        elif "default" in g.props:
            # defaults may reference earlier globals (kcyclic.jdf:111
            # "dA->super.mt-1"): evaluate against the values so far
            gvals[g.name] = eval(c2py(g.props["default"]),
                                 {**C_EVAL_HELPERS, **gvals}, {})
        else:
            raise JdfError(f"JDF global {g.name!r} has no value: pass "
                           f"globals={{{g.name!r}: ...}}")
    dmap = dict(data or {})
    for k, v in gvals.items():
        if hasattr(v, "data_of") and k not in dmap:
            dmap[k] = v
    env = dict(gvals)
    env.update(dmap)
    env["np"] = np
    env.update(C_EVAL_HELPERS)

    p = PTG(name or (jdf.tasks[0].name.lower() if jdf.tasks else "jdf"),
            **{k: v for k, v in gvals.items()
               if isinstance(v, (int, float, str, bool))})
    p.dynamic = str(jdf.options.get("dynamic", "")).lower() \
        in ("on", "true", "1", "yes")
    for aname, (shape, dtype) in (arenas or {}).items():
        p.arena(aname, shape, dtype)

    task_names = {t.name for t in jdf.tasks}

    for t in jdf.tasks:
        declared = [d[1] for d in t.defs if d[0] == "range"]
        for pname in t.params:
            if pname not in declared:
                raise JdfError(
                    f"task {t.name}: parameter {pname} has no range")
        # Execution space: EVERY definition — ranges and derived locals,
        # in declaration order — becomes a TaskClass parameter; derived
        # locals are single-valued ranges over the preceding names.  This
        # mirrors the reference exactly (locals live in
        # this_task->locals and bodies may overwrite them — the
        # project_dyn.jdf dynamic-pruning idiom), and lets later range
        # bounds use earlier derived locals (BT_reduction.jdf "s = 1 ..
        # sz" where sz derives from t).
        space: Dict[str, Any] = {}
        prior: List[str] = []
        for d in t.defs:
            if d[0] == "range":
                _, pname, lo, hi, step = d
                lo_f = _compile_fn(c2py(lo), list(prior), [], env)
                hi_f = _compile_fn(c2py(hi), list(prior), [], env)
                if step is not None:
                    space[pname] = Range(
                        lo_f, hi_f, _compile_fn(c2py(step), list(prior),
                                                [], env))
                else:
                    space[pname] = Range(lo_f, hi_f)
                prior.append(pname)
            else:
                _, lname, expr = d
                space[lname] = _single_valued(
                    _compile_fn(c2py(expr), list(prior), [], env),
                    list(prior))
                prior.append(lname)
        tb = p.task(t.name, **space)
        if "make_key_fn" in t.props:
            fn = (funcs or {}).get(t.props["make_key_fn"])
            if fn is None:
                raise JdfError(
                    f"task {t.name}: make_key_fn "
                    f"{t.props['make_key_fn']!r} not in funcs=")
            tb.make_key(fn)
        if "startup_fn" in t.props:
            fn = (funcs or {}).get(t.props["startup_fn"])
            if fn is None:
                raise JdfError(
                    f"task {t.name}: startup_fn "
                    f"{t.props['startup_fn']!r} not in funcs=")
            tb.property("startup_fn", fn)
        if t.partition is not None:
            dname, args = t.partition
            if dname not in dmap:
                raise JdfError(f"task {t.name}: partitioning data "
                               f"{dname!r} not provided")
            expr = f"{dname}(" + ", ".join(c2py(a) for a in args) + ")"
            tb.affinity(_compile_fn(expr, t.def_names, [], env))
        for f in t.flows:
            ends = []
            for dep in f.deps:
                ends.extend(_build_dep(t, f, dep, env, dmap, jdf.tasks,
                                       dtts or {}))
            tb.flow(f.name, f.access, *ends)
        body = (bodies or {}).get(t.name)
        if body is None:
            tb.body(_missing_body(t.name))
        elif isinstance(body, tuple):
            kern, cpu = body
            tb.body(kern, device="cuda")
            tb.body(cpu)
        else:
            tb.body(body)
    return p.build()


def _build_dep(t: JdfTask, f: JdfFlow, dep: JdfDep, env, dmap,
               all_tasks: List[JdfTask], dtts) -> List[Any]:
    """One JDF dependency line -> IN/OUT objects (a guarded ternary
    yields two, with complementary guards)."""
    task_names = {tt.name for tt in all_tasks}
    ctor = IN if dep.direction == "in" else OUT
    dtt = None
    for key in ("type_remote", "type"):
        if key in dep.props and dep.props[key] in dtts:
            dtt = dtts[dep.props[key]]
            break

    names = t.def_names   # guards/args see ranges AND derived locals,
    #                       all read from task.locals (body overwrites
    #                       of a local are visible to output guards)

    def one(ep: JdfEndpoint, guard_expr: Optional[str]):
        guard = _compile_fn(c2py(guard_expr), names, [], env) \
            if guard_expr is not None else None
        kw = {}
        if guard is not None:
            kw["when"] = guard
        if dtt is not None:
            kw["dtt"] = dtt
        if ep.kind == "new":
            if dep.direction != "in":
                raise JdfError(f"task {t.name}: NEW only valid on inputs")
            return ctor(NEW("default"), **kw)
        if ep.kind == "null":
            return ctor(NULL_END(), **kw)
        if ep.kind == "data":
            if ep.target not in dmap:
                raise JdfError(f"task {t.name}: data {ep.target!r} "
                               f"not provided")
            expr = (f"{ep.target}(" +
                    ", ".join(c2py(a) for a in ep.args) + ")")
            return ctor(DATA(_compile_fn(expr, names, [], env)), **kw)
        # task endpoint; range args become list-returning params fns
        if ep.target not in task_names:
            raise JdfError(f"task {t.name}: unknown peer task "
                           f"{ep.target!r}")
        tgt_params = next(tt.params for tt in all_tasks
                          if tt.name == ep.target)
        items = []
        wraps = []
        for pn, arg in zip(tgt_params, ep.args):
            parts = [x.strip() for x in re.split(r"\.\.", arg)]
            if len(parts) >= 2:
                var = f"__r_{pn}"
                wraps.append((var, parts[0], parts[1],
                              parts[2] if len(parts) > 2 else None))
                items.append(f"'{pn}': {var}")
            else:
                items.append(f"'{pn}': ({c2py(arg)})")
        expr = "{" + ", ".join(items) + "}"
        fn = _compile_fn(expr, names, [], env, list_wrap=wraps or None)
        return ctor(TASK(ep.target, ep.flow, fn), **kw)

    if dep.alt is not None:
        return [one(dep.ep, dep.guard),
                one(dep.alt, f" not ({dep.guard})")]
    return [one(dep.ep, dep.guard)]
