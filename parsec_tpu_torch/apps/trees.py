"""Irregular tree applications: DTD merge sort and the adaptive Haar
projection.

Reference: tests/apps/merge_sort/ (DTD merge sort over tiles) and
tests/apps/haar_tree/ (adaptive wavelet tree walk; project_dyn.jdf runs
it under DYNAMIC termination detection because the tree's size is
data-dependent and unknowable up front).  Both are DTD applications:
merge sort inserts its reduction tree statically bottom-up; the Haar
projection discovers its tree AT RUNTIME — task bodies insert their own
children — and terminates through the user_trigger termdet when the
outstanding-node count drains to zero.

The port's copy of the JAX package's apps/trees.py: the sort and merge
bodies are torch ops on CPU tensors, and ``merge_sort_dtd`` takes numpy
or a tensor.  ``HaarProjection`` samples ``fn`` on numpy points, as
there.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from parsec_tpu_torch.dsl.dtd.insert import (DTDTaskpool, DTDTile, INOUT,
                                             INPUT, OUTPUT, VALUE)


# ---------------------------------------------------------------------------
# DTD merge sort (reference: tests/apps/merge_sort)
# ---------------------------------------------------------------------------

def merge_sort_dtd(tp: DTDTaskpool, data: Any, leaf: int = 64) -> DTDTile:
    """Sort ``data`` via leaf sorts + a pairwise merge tree of DTD tasks;
    returns the tile holding the fully sorted result (read it after
    ``tp.wait()``)."""
    data = data if isinstance(data, torch.Tensor) else torch.as_tensor(data)
    n = len(data)
    if n == 0:
        return tp.tile_new((0,), dtype=data.dtype)
    level: List = []
    # leaves: sort each chunk in place
    for lo in range(0, n, leaf):
        chunk = data[lo:lo + leaf]
        t = tp.tile_new((len(chunk),), dtype=data.dtype)
        t.data.copy_on(0).payload.copy_(chunk)
        tp.insert_task(lambda x: torch.sort(x).values, (t, INOUT))
        level.append(t)
    # merge tree, bottom-up
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            a, b = level[i], level[i + 1]
            la = a.data.copy_on(0).payload.shape[0]
            lb = b.data.copy_on(0).payload.shape[0]
            out = tp.tile_new((la + lb,), dtype=data.dtype)

            def merge(x, y, o):
                return torch.sort(torch.cat([x, y]), stable=True).values
            tp.insert_task(merge, (a, INPUT), (b, INPUT), (out, OUTPUT))
            nxt.append(out)
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


# ---------------------------------------------------------------------------
# Adaptive Haar projection (reference: tests/apps/haar_tree —
# project_dyn.jdf + dynamic termdet)
# ---------------------------------------------------------------------------

class HaarProjection:
    """Adaptive piecewise-constant projection of ``f`` on [0, 1): each
    node averages its interval and REFINES (spawning two child tasks
    from its own body) while the two halves differ by more than ``eps``
    and the interval is wider than ``min_width``.  The tree's shape —
    and therefore the task count — depends on the data, so the pool runs
    under the user_trigger termdet and fires it when the outstanding-
    node counter drains (reference: the dynamic-termdet contract of
    project_dyn.jdf)."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray],
                 eps: float = 1e-2, min_width: float = 1e-3,
                 samples: int = 16):
        self.fn = fn
        self.eps = eps
        self.min_width = min_width
        self.samples = samples
        self.leaves: Dict[Tuple[float, float], float] = {}
        self._lock = threading.Lock()
        self._outstanding = 0
        self.nodes = 0

    def _avg(self, lo: float, hi: float) -> float:
        xs = np.linspace(lo, hi, self.samples, endpoint=False)
        return float(np.mean(self.fn(xs)))

    def _spawn(self, tp: DTDTaskpool, lo: float, hi: float) -> None:
        with self._lock:
            self._outstanding += 1
            self.nodes += 1
        tp.insert_task(lambda lo, hi, tp=tp: self._node(tp, lo, hi),
                       (lo, VALUE), (hi, VALUE))

    def _node(self, tp: DTDTaskpool, lo: float, hi: float) -> None:
        mid = (lo + hi) / 2.0
        left, right = self._avg(lo, mid), self._avg(mid, hi)
        if abs(left - right) > self.eps and (hi - lo) > self.min_width:
            # refine: the task DISCOVERS its children at runtime
            self._spawn(tp, lo, mid)
            self._spawn(tp, mid, hi)
        else:
            with self._lock:
                self.leaves[(lo, hi)] = (left + right) / 2.0
        done = False
        with self._lock:
            self._outstanding -= 1
            done = self._outstanding == 0
        if done:
            # the algorithm, not a task count, declares completion
            tp.termdet.trigger(tp)

    def run(self, tp: DTDTaskpool) -> None:
        """Seed the root; callers create ``tp`` with
        ``termdet_name='user_trigger'`` and ``tp.wait()`` afterwards."""
        if tp.termdet_name != "user_trigger":
            raise ValueError("HaarProjection needs a user_trigger pool: "
                             "its task count is data-dependent")
        self._spawn(tp, 0.0, 1.0)

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        """Evaluate the projection (piecewise constant over the leaves)."""
        out = np.zeros_like(np.asarray(x, dtype=np.float64))
        for (lo, hi), v in self.leaves.items():
            mask = (x >= lo) & (x < hi)
            out[mask] = v
        return out
