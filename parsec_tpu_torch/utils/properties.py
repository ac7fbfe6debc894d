"""Properties dictionary: a runtime-queryable hierarchical key space.

Rebuild of the reference's properties dictionary (reference:
parsec/dictionary.{c,h} — a 1.3k-LoC hierarchical namespace of
taskpool/task properties that live tooling like tools/aggregator_visu
walks at runtime).  Here a property is a '/'-separated path bound to a
VALUE or a zero-arg PROVIDER evaluated at lookup time, so consumers
always read live state:

    space.register("runtime/devices/cuda:0/executed_tasks",
                   lambda: dev.stats.executed_tasks)
    space.lookup("runtime/devices/cuda:0/executed_tasks")  -> live count
    space.tree("runtime/devices")  -> {path: value, ...}

The Context exposes one per-process space at ``ctx.properties`` with the
runtime/device/scheduler namespaces pre-registered; taskpools attach
their per-class properties (flops weights, task counters) under
``taskpool/<name>/...`` when enqueued.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class PropertySpace:
    def __init__(self):
        self._lock = threading.Lock()
        self._props: Dict[str, Any] = {}

    @staticmethod
    def _norm(path: str) -> str:
        return "/".join(p for p in path.split("/") if p)

    def register(self, path: str, value: Any) -> None:
        """Bind ``path`` to a value or a zero-arg provider; re-registering
        replaces (the reference rebinds on taskpool re-enqueue)."""
        with self._lock:
            self._props[self._norm(path)] = value

    def unregister(self, path: str) -> None:
        with self._lock:
            self._props.pop(self._norm(path), None)

    def unregister_tree(self, prefix: str) -> int:
        """Drop every property under ``prefix`` (taskpool teardown)."""
        prefix = self._norm(prefix)
        with self._lock:
            doomed = [p for p in self._props
                      if p == prefix or p.startswith(prefix + "/")]
            for p in doomed:
                del self._props[p]
        return len(doomed)

    def lookup(self, path: str, default: Any = None) -> Any:
        with self._lock:
            v = self._props.get(self._norm(path), _MISSING)
        if v is _MISSING:
            return default
        return v() if callable(v) else v

    def paths(self, prefix: str = "") -> List[str]:
        prefix = self._norm(prefix)
        with self._lock:
            return sorted(p for p in self._props
                          if not prefix or p == prefix
                          or p.startswith(prefix + "/"))

    def tree(self, prefix: str = "") -> Dict[str, Any]:
        """Evaluate every property under ``prefix`` (the aggregator-GUI
        read pattern: walk a namespace, sample all gauges at once)."""
        out = {}
        for p in self.paths(prefix):
            out[p] = self.lookup(p)
        return out


_MISSING = object()


def install_runtime_properties(ctx) -> PropertySpace:
    """Pre-register the runtime namespaces on a context's space
    (reference: the runtime-level entries of dictionary.c)."""
    ps = ctx.properties
    ps.register("runtime/nranks", lambda: ctx.nranks)
    ps.register("runtime/rank", lambda: ctx.rank)
    ps.register("runtime/nb_cores", lambda: len(ctx.streams))
    ps.register("runtime/scheduler",
                lambda: type(ctx.scheduler).__name__)
    for d in ctx.device_registry.devices:
        base = f"runtime/devices/{d.name}"
        ps.register(f"{base}/kind", d.kind)
        for field in ("executed_tasks", "bytes_in", "bytes_out",
                      "faults", "evictions", "fused_launches",
                      "fused_tasks"):
            ps.register(f"{base}/{field}",
                        (lambda d=d, f=field: getattr(d.stats, f)))
        ps.register(f"{base}/load", lambda d=d: d.load)
    return ps


def install_taskpool_properties(ctx, tp) -> None:
    """Attach a taskpool's class properties + live counters under
    ``taskpool/<name>`` (reference: taskpool registration in
    dictionary.c; JDF-declared property expressions land in
    TaskClass.properties)."""
    base = f"taskpool/{tp.name}"
    ps = ctx.properties
    ps.register(f"{base}/nb_tasks",
                lambda tp=tp: getattr(tp, "nb_tasks", None))
    import inspect
    classes = getattr(tp, "task_classes", None) or {}
    for cname, tc in classes.items():
        for pname, pval in getattr(tc, "properties", {}).items():
            if callable(pval):
                # zero-arg callables are live providers (the dictionary
                # contract); parameterized per-task expressions (flops /
                # coaffinity lambdas over task locals) cannot be sampled
                # without an instance — register their description
                try:
                    sig = inspect.signature(pval)
                    needs_args = any(
                        p.default is p.empty and p.kind in
                        (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                        for p in sig.parameters.values())
                except (TypeError, ValueError):
                    needs_args = False
                if needs_args:
                    ps.register(f"{base}/classes/{cname}/{pname}",
                                f"<per-task expression {pname}>")
                    continue
            ps.register(f"{base}/classes/{cname}/{pname}", pval)
