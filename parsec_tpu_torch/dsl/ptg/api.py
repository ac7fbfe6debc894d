"""PTG front-end: a Python-embedded JDF.

Rebuild of the reference's PTG/JDF interface (reference:
parsec/interfaces/ptg/ptg-compiler — grammar parsec.y/parsec.l, code
generator jdf2c.c).  Where the reference compiles a textual JDF into a
generated C taskpool, this front-end builds the same parameterized-task-
graph structures directly from Python declarations, preserving the JDF
concepts one-for-one:

  JDF                                  here
  ---------------------------------   ------------------------------------
  k = 0 .. NT-1                        k=Range(0, lambda NT: NT - 1)
  : A(k, k)        (partitioning)      .affinity(lambda k: A(k, k))
  RW T <- (k==0) ? A(k) : S(k-1)       .flow("T", "RW", IN(DATA(...),
        -> (k<NT-1) ? S(k+1) : A(k)        when=...), IN(TASK(...)), ...)
  -> TRSM(k+1..NT-1, k)                TASK("TRSM", "T", lambda k:
                                         [dict(m=m, k=k) for m in ...])
  BODY ... END                         .body(fn)  # named args by flow/param

All user lambdas take the task's parameters BY NAME (``lambda k, m: ...``);
bodies additionally receive flow payloads by flow name, plus the optional
``es`` and ``task`` magic names.  Taskpool globals (NT, ...) are visible to
Range bounds by name and to everything else via Python closures.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from parsec_tpu_torch.core.task import (CTL as _CTL_FLOW, Dep, Flow, FromDesc,
                                  FromTask, HookReturn, New, Null, TaskClass,
                                  ToDesc, ToTask, normalize_body_outputs)
from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.arena import Arena
from parsec_tpu_torch.data.collection import DataRef
from parsec_tpu_torch.data.data import (ACCESS_NONE, ACCESS_READ, ACCESS_RW,
                                        ACCESS_WRITE, to_host)

_MODES = {"RW": ACCESS_RW, "READ": ACCESS_READ, "WRITE": ACCESS_WRITE,
          "CTL": ACCESS_NONE}


def _named(fn: Callable) -> Callable[[Dict[str, int]], Any]:
    """Adapt a named-parameter lambda to a locals-dict callable.

    Parameters with defaults (the ``lambda k, NB=NT: ...`` capture idiom)
    keep their defaults when the name is not a task parameter.
    """
    if fn is None:
        return None
    sig = [(p.name, p.default is not inspect.Parameter.empty)
           for p in inspect.signature(fn).parameters.values()
           if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                         inspect.Parameter.KEYWORD_ONLY)]

    def wrapper(locals_: Dict[str, int]):
        kwargs = {}
        for name, has_default in sig:
            if name in locals_:
                kwargs[name] = locals_[name]
            elif not has_default:
                raise KeyError(
                    f"dep expression needs {name!r} but the task has "
                    f"params {sorted(locals_)}; capture globals with a "
                    f"default arg (lambda k, {name}={name}: ...)")
        return fn(**kwargs)
    return wrapper


def _resolve(v: Any, globals_: Dict[str, Any], locals_: Dict[str, int]) -> int:
    if callable(v):
        # signature introspection costs ~10us; Range bounds resolve once
        # per parameter per enumeration node, so memoize the name list
        # on the function itself (iter_space over an O(NT^3) space would
        # otherwise pay it millions of times)
        names = getattr(v, "_pt_argnames", None)
        if names is None:
            names = [p.name
                     for p in inspect.signature(v).parameters.values()]
            try:
                v._pt_argnames = names
            except AttributeError:
                pass   # builtins/bound methods: uncached, still correct
        scope = {**globals_, **locals_}
        return v(**{n: scope[n] for n in names})
    return int(v)


class Range:
    """JDF-style INCLUSIVE parameter range ``lo .. hi [.. step]``.
    Bounds may be ints or named lambdas over globals and earlier params."""

    def __init__(self, lo: Any, hi: Any, step: Any = 1):
        self.lo, self.hi, self.step = lo, hi, step

    def to_fn(self):
        def fn(globals_, locals_):
            lo = _resolve(self.lo, globals_, locals_)
            hi = _resolve(self.hi, globals_, locals_)
            st = _resolve(self.step, globals_, locals_)
            return range(lo, hi + (1 if st > 0 else -1), st)
        return fn


# -- dependency endpoint constructors ---------------------------------------

class _End:
    pass


class TASK(_End):
    """Reference to a peer task's flow: TASK("TRSM", "T", lambda k: dict(...))
    — a list-returning lambda expresses a JDF range dep."""

    def __init__(self, task_class: str, flow: str, params: Callable):
        self.task_class, self.flow = task_class, flow
        self.params = _named(params)


class DATA(_End):
    """Direct collection access: DATA(lambda k: A(k, k))."""

    def __init__(self, ref: Callable):
        self.ref = _named(ref)


class NEW(_End):
    """Fresh arena allocation (JDF NEW)."""

    def __init__(self, arena: str = "default"):
        self.arena = arena


class NULL_END(_End):
    """JDF NULL."""


def _to_core_end(e: Union[_End, Callable], is_input: bool):
    if isinstance(e, TASK):
        return (FromTask(e.task_class, e.flow, e.params) if is_input
                else ToTask(e.task_class, e.flow, e.params))
    if isinstance(e, DATA):
        return FromDesc(e.ref) if is_input else ToDesc(e.ref)
    if isinstance(e, NEW):
        if not is_input:
            # reference diagnostic (ptgpp output_NEW*.jdf golden cases)
            raise ValueError("Automatic data allocation with NEW only "
                             "supported in IN dependencies.")
        return New(e.arena)
    if isinstance(e, NULL_END) or e is NULL_END:
        if not is_input:
            # reference diagnostic (ptgpp output_NULL*.jdf golden cases)
            raise ValueError("NULL data only supported in IN dependencies.")
        return Null()
    if callable(e):   # bare lambda returning a DataRef == DATA shorthand
        return _to_core_end(DATA(e), is_input)
    raise TypeError(f"bad dependency endpoint {e!r}")


class IN:
    """Input dependency: IN(endpoint, when=guard, count=gather_multiplicity)."""

    def __init__(self, end, when: Optional[Callable] = None,
                 count: Optional[Callable] = None, dtt: Any = None):
        self.dep = Dep(_to_core_end(end, is_input=True), guard=_named(when),
                       count=_named(count), dtt=dtt)


class OUT:
    """Output dependency: OUT(endpoint, when=guard)."""

    def __init__(self, end, when: Optional[Callable] = None, dtt: Any = None):
        self.dep = Dep(_to_core_end(end, is_input=False), guard=_named(when),
                       dtt=dtt)


def _bind_body_outputs(task, ret: Any, writable: List[str]) -> None:
    """Store a functional body's return value(s) into the written flows'
    copies.  Host copies backed by collection storage are updated in place
    (``Tensor.copy_``) so backing-array views stay linked.  A body may
    return tensors or numpy arrays; numpy becomes a CPU tensor."""
    outs = normalize_body_outputs(ret, writable, what=str(task))
    for name, value in outs.items():
        copy = task.data.get(name)
        if copy is None:
            raise RuntimeError(f"{task}: flow {name!r} has no bound copy")
        arr = value if isinstance(value, torch.Tensor) else to_host(value)
        cur = copy.payload
        if isinstance(cur, torch.Tensor) and cur.device == arr.device \
                and arr.shape == cur.shape and arr.dtype == cur.dtype:
            if arr.data_ptr() != cur.data_ptr():
                cur.copy_(arr)
        else:
            # shape/dtype change (a dtt edge layout, or a device tensor):
            # rebind the payload; the writeback path converts home
            copy.payload = arr


# -- task-class builder ------------------------------------------------------

class TaskBuilder:
    def __init__(self, ptg: "PTG", name: str, params: Dict[str, Any]):
        self._ptg = ptg
        self.name = name
        self._params = []
        for pname, r in params.items():
            if isinstance(r, Range):
                self._params.append((pname, r.to_fn()))
            elif callable(r):
                self._params.append((pname, r))
            else:
                raise TypeError(f"param {pname}: expected Range or callable")
        self._affinity = None
        self._priority = None
        self._key_fn = None
        self._flows: List[Flow] = []
        self._incarnations: List = []
        self._properties: Dict[str, Any] = {}

    def affinity(self, fn: Callable) -> "TaskBuilder":
        """JDF partitioning line ``: A(k, n)``."""
        self._affinity = _named(fn)
        return self

    def priority(self, fn: Callable) -> "TaskBuilder":
        self._priority = _named(fn)
        return self

    def make_key(self, fn: Callable) -> "TaskBuilder":
        """User-defined task key (reference: the ``[make_key_fn = ...]``
        task-class property, user-defined-functions/udf.jdf:46): ``fn``
        maps the task's named parameters to any hashable key, replacing
        the default parameter tuple in dep tracking and the repo."""
        self._key_fn = _named(fn)
        return self

    def flow(self, name: str, mode: str, *deps: Union[IN, OUT]) -> "TaskBuilder":
        ins = [d.dep for d in deps if isinstance(d, IN)]
        outs = [d.dep for d in deps if isinstance(d, OUT)]
        self._flows.append(Flow(name, _MODES[mode.upper()], ins, outs))
        return self

    def body(self, fn: Callable, device: str = "cpu") -> "TaskBuilder":
        """Register an incarnation.  The function's named args are bound
        from task params, flow payloads, and the magic names es/task.

        ``device="cuda"`` (or ``"gpu"``) registers a device incarnation:
        ``fn`` must be a functional torch function over flow payloads
        (see CudaKernel); at runtime the task is handed to the best device
        module and completes asynchronously (reference: BODY [type=CUDA]
        bodies and the GPU hook of jdf2c.c:6556).  A context asked to run
        on the CPU attaches a CPU-backed instance of the same module, so
        the device body still runs there, on CPU tensors.  When no device
        is attached the incarnation declines (HookReturn.NEXT) and the
        next body runs instead.
        """
        if device in ("cuda", "gpu"):
            return self._device_body(fn, device)
        flow_names = {f.name for f in self._flows}
        names = [p.name for p in inspect.signature(fn).parameters.values()]
        writable = [f.name for f in self._flows if f.access & ACCESS_WRITE]

        if not names and not writable:
            # zero-arg, zero-write body (CTL-only probes, barriers):
            # skip the kwargs binding loop — the empty-task hot path
            def hook(es, task):
                ret = fn()
                return ret if ret is None or isinstance(ret, HookReturn) \
                    else None
            hook.__ptg_fn__ = fn
            hook.__ptg_writable__ = writable
            self._incarnations.append((device, hook))
            return self

        def hook(es, task):
            kwargs = {}
            for n in names:
                if n == "es":
                    kwargs[n] = es
                elif n == "task":
                    kwargs[n] = task
                elif n in flow_names:
                    copy = task.data.get(n)
                    kwargs[n] = None if copy is None else copy.payload
                elif n in task.locals:
                    kwargs[n] = task.locals[n]
                elif n in self._ptg.globals_:
                    kwargs[n] = self._ptg.globals_[n]
                # else: the parameter's own default (capture idiom) applies
            ret = fn(**kwargs)
            # Functional bodies return the new written-flow values (same
            # convention as device kernels); in-place bodies return None.
            # Only HookReturn instances pass through as lifecycle codes —
            # a plain int/bool is a VALUE (silently eating it as a code
            # would drop the write).
            if ret is None or isinstance(ret, HookReturn):
                return ret
            if not writable:
                return None   # nothing to write; ignore the return value
            _bind_body_outputs(task, ret, writable)
            return None

        hook.__ptg_fn__ = fn            # raw body, for the PTG->DTD bridge
        hook.__ptg_writable__ = writable
        self._incarnations.append((device, hook))
        return self

    def _device_body(self, fn: Callable, device: str) -> "TaskBuilder":
        from parsec_tpu_torch.core.task import HookReturn
        from parsec_tpu_torch.devices.cuda import CudaKernel
        # keyword-only parameters (``donate``) are the device module's to
        # pass, not bound from flows or task parameters
        names = [p.name for p in inspect.signature(fn).parameters.values()
                 if p.kind is not inspect.Parameter.KEYWORD_ONLY]
        flow_names = [f.name for f in self._flows]
        writable = [f.name for f in self._flows if f.access & ACCESS_WRITE]
        spec = CudaKernel(fn, names, flow_names, writable)

        def hook(es, task):
            reg = getattr(es.context, "device_registry", None)
            dev = reg.best_device(task) if reg is not None else None
            if dev is None:
                return HookReturn.NEXT
            return dev.submit(es, task, spec)

        self._incarnations.append((device, hook))
        return self

    def property(self, key: str, value: Any) -> "TaskBuilder":
        self._properties[key] = value
        return self

    def _build(self) -> TaskClass:
        return TaskClass(
            self.name, params=self._params, affinity=self._affinity,
            flows=self._flows, incarnations=self._incarnations,
            priority=self._priority, properties=self._properties,
            key_fn=self._key_fn)


class PTG:
    """A parameterized-task-graph taskpool under construction.

    ``PTG("name", NT=4, ...)`` declares globals; ``.task(...)`` declares
    task classes; ``.build()`` (or passing the PTG straight to
    Context.add_taskpool via ``.taskpool``) yields the runnable pool.
    """

    def __init__(self, name: str, **globals_):
        self.name = name
        self.globals_ = dict(globals_)
        self._tasks: List[TaskBuilder] = []
        self._arenas: Dict[str, Arena] = {}
        #: build a DynamicTaskpool instead (JDF ``%option dynamic = ON``):
        #: no startup enumeration; task classes seed via the
        #: ``startup_fn`` property and tasks are counted as discovered
        self.dynamic = False

    def task(self, name: str, **params) -> TaskBuilder:
        tb = TaskBuilder(self, name, params)
        self._tasks.append(tb)
        return tb

    def arena(self, name: str, shape: Sequence[int],
              dtype: Any = torch.float32) -> "PTG":
        self._arenas[name] = Arena(tuple(shape), dtype)
        return self

    def build(self) -> ParameterizedTaskpool:
        if self.dynamic:
            from parsec_tpu_torch.core.taskpool import DynamicTaskpool
            tp = DynamicTaskpool(self.name, globals_=self.globals_)
        else:
            tp = ParameterizedTaskpool(self.name, globals_=self.globals_)
        for aname, arena in self._arenas.items():
            tp.add_arena(aname, arena)
        for tb in self._tasks:
            tp.add_task_class(tb._build())
        return tp
