"""DOT grapher: emit the executed DAG.

Rebuild of the reference's profiling grapher (reference:
parsec/parsec_prof_grapher.{c,h} — one DOT file per rank recording every
executed task as a node and every resolved dependency as an edge, enabled
with ``--mca parsec_dot``).  Nodes record task class + parameters and the
stream that ran them; edges record the flow names they rode.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class DotGrapher:
    """Collects nodes/edges; installed on a context as ``ctx.grapher``
    (the dep engine notifies it during release_deps)."""

    def __init__(self, rank: int = 0):
        self.rank = rank
        self._lock = threading.Lock()
        self._nodes: Dict[Tuple, Dict] = {}
        self._edges: List[Tuple[Tuple, Tuple, str]] = []

    def install(self, context) -> None:
        context.grapher = self
        context.pins_register("complete_exec", self._complete)

    def _complete(self, es, event, task) -> None:
        with self._lock:
            self._nodes[task.key] = {
                "label": repr(task),
                "stream": es.th_id,
                "tc": task.task_class.name,
            }

    def edge(self, src_task, dst_key: Tuple, flow_name: str) -> None:
        """Called by the dep engine for every task->task dep resolved."""
        with self._lock:
            self._edges.append((src_task.key, dst_key, flow_name))

    def dump(self, path: str) -> str:
        def nid(key: Tuple) -> str:
            return "t_" + "_".join(str(k) for k in key)
        lines = [f'digraph rank{self.rank} {{']
        with self._lock:
            for key, attrs in self._nodes.items():
                lines.append(
                    f'  {nid(key)} [label="{attrs["label"]}",'
                    f'tooltip="stream {attrs["stream"]}"];')
            for src, dst, flow in self._edges:
                lines.append(f'  {nid(src)} -> {nid(dst)} '
                             f'[label="{flow}"];')
        lines.append("}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path
