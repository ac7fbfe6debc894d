"""SPMD schedules over a mesh of devices or device modules.

The port of the JAX package's parallel/spmd.py.  Each function is a
*dataflow schedule template*: the single-program form of a task-graph
pattern the runtime otherwise executes task by task (SURVEY.md §5.8):

- ``summa_gemm_fn``  — owner-computes 2D GEMM; the A-row / B-column panel
  broadcasts are the reference's dataflow *bcast trees*
  (remote_dep.c:334-357) realized as an all-gather over mesh axes.
- ``ring_reduce_gemm_fn`` — contraction-sharded GEMM whose partial-sum
  combine is a reduce-scatter: the reduction analog.
- ``halo_stencil_fn`` — neighbor exchange by a ring shift: the chain
  pipeline (stencil halos).

The JAX package runs each as one ``shard_map`` program over a jax Mesh.
Here one process drives every mesh position in turn (single controller,
as there): a position is a torch device or a device module of a Context
(``device="cuda*N"`` gives N modules over one card, each with its own
launch stream; "cpu:N" their CPU-backed stand-ins).  The collectives
become copies between positions: all-gather is each position's
concatenation of copied blocks, psum_scatter a fixed-order sum of copied
partials (position 0's first), ppermute the ring shift.  A copy runs on
the receiving position's stream after that stream waited on the
sender's, as the ICI engine's do (comm/ici.py).  ``torch.distributed``
is not used: the reference is one process, and NCCL refuses two ranks on
one GPU.  Each function takes whole tensors (numpy or torch) and returns
a whole tensor on the first position's device.

The local products are ``torch.matmul`` (the reference's are plain
``jnp.matmul`` outside any Pallas kernel), with TF32 off unless
``precision`` asks for less than full f32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: ``precision`` values that allow TF32 in the local products (jax's
#: names for the precisions below HIGHEST); anything else keeps it off
_LOW_PRECISION = ("default", "fastest", "high", "bfloat16",
                  "tensorfloat32", "bf16_3x")


class Mesh:
    """Named grid of mesh positions (the counterpart of
    ``jax.sharding.Mesh``): ``devices`` is an object array of torch
    devices or device modules, ``shape`` maps axis name to size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _positions(devices) -> list:
    """Torch devices or modules from ``devices``: a Context (its
    accelerator modules), a list, or None (every visible CUDA device)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible; pass devices= (a Context's "
                "modules, e.g. on device='cpu:8', or torch devices)")
        return [torch.device("cuda", i) for i in range(n)]
    if hasattr(devices, "device_registry"):
        return list(devices.device_registry.accelerators)
    return list(devices)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("p", "q"),
              devices=None) -> Mesh:
    """Build a Mesh over ``devices`` (see ``_positions``).

    ``shape=None`` picks the most square 2D factorization of the device
    count (the PxQ process grid of the reference's 2D block-cyclic
    distribution, two_dim_rectangle_cyclic.h).
    """
    devs = _positions(devices)
    n = len(devs)
    if shape is None:
        p = int(np.sqrt(n))
        while n % p:
            p -= 1
        shape = (p, n // p) if len(axis_names) == 2 else (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(arr.reshape(shape), tuple(axis_names[:len(shape)]))


class _Party:
    """One mesh position: where its tensors live and the stream its work
    runs on (a module's launch stream; the current stream of a torch
    CUDA device; None on the CPU)."""

    __slots__ = ("tdev", "stream")

    def __init__(self, entry):
        tdev = getattr(entry, "tdev", None)
        if tdev is not None:                     # a device module
            self.tdev = tdev
            self.stream = entry.stream
        else:
            self.tdev = torch.device(entry)
            self.stream = torch.cuda.current_stream(self.tdev) \
                if self.tdev.type == "cuda" else None

    def run(self):
        """Context making this position's stream current."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def take(self, t: torch.Tensor, src: Optional["_Party"] = None
             ) -> torch.Tensor:
        """A private copy of ``t`` (held by ``src``; None: made by the
        caller on its current stream) on this position, on its stream
        after ``src``'s."""
        if self.stream is None:
            return t.to(self.tdev, copy=True)
        before = None
        if t.is_cuda:
            before = src.stream if src is not None and \
                src.stream is not None \
                else torch.cuda.current_stream(t.device)
        with torch.cuda.stream(self.stream):
            if before is not None and before != self.stream:
                self.stream.wait_stream(before)
                t.record_stream(self.stream)
            out = torch.empty(tuple(t.shape), dtype=t.dtype,
                              device=self.tdev)
            out.copy_(t, non_blocking=t.is_cuda or t.is_pinned())
        return out


@contextlib.contextmanager
def _products(parties: List[_Party], precision: Optional[str]):
    """TF32 in the local products only when ``precision`` asks for less
    than full f32 and a position is on a card."""
    if not any(p.stream is not None for p in parties):
        yield
        return
    want = str(precision).lower() in _LOW_PRECISION \
        if precision is not None else False
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = want
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _whole(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x))


def _grid(mesh: Mesh) -> np.ndarray:
    """The mesh's positions as an object array of ``_Party``."""
    flat = [_Party(d) for d in mesh.devices.reshape(-1)]
    out = np.empty(len(flat), dtype=object)
    for i, p in enumerate(flat):
        out[i] = p
    return out.reshape(mesh.devices.shape)


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} does not split over {parts} "
                         f"positions")
    return n // parts


def summa_gemm_fn(mesh: Mesh, precision: Optional[str] = None) -> Callable:
    """C = A@B with A, B, C block-distributed over a (p, q) mesh.

    Panel broadcast form of SUMMA: each position gathers its A block row
    along ``q`` and its B block column along ``p``, then one local matmul
    produces its C block.  The gathers are the dataflow-broadcast edges
    of the tiled-GEMM PTG, batched per wavefront.
    """
    grid = _grid(mesh)
    p, q = grid.shape

    def sharded(a, b):
        A, B = _whole(a), _whole(b)
        bm, bka = _split(A.shape[0], p, "A rows"), _split(A.shape[1], q,
                                                          "A cols")
        bkb, bn = _split(B.shape[0], p, "B rows"), _split(B.shape[1], q,
                                                          "B cols")
        ab = [[grid[i, j].take(A[i * bm:(i + 1) * bm,
                                 j * bka:(j + 1) * bka])
               for j in range(q)] for i in range(p)]
        bb = [[grid[i, j].take(B[i * bkb:(i + 1) * bkb,
                                 j * bn:(j + 1) * bn])
               for j in range(q)] for i in range(p)]
        cb = [[None] * q for _ in range(p)]
        with _products(list(grid.reshape(-1)), precision):
            for i in range(p):
                for j in range(q):
                    me = grid[i, j]
                    row = [ab[i][jj] if jj == j
                           else me.take(ab[i][jj], grid[i, jj])
                           for jj in range(q)]
                    col = [bb[ii][j] if ii == i
                           else me.take(bb[ii][j], grid[ii, j])
                           for ii in range(p)]
                    with me.run():
                        cb[i][j] = torch.matmul(torch.cat(row, dim=1),
                                                torch.cat(col, dim=0))
        return _assemble(grid, [[(cb[i][j], grid[i, j]) for j in range(q)]
                                for i in range(p)])

    return sharded


def _axis_parties(grid: np.ndarray, mesh: Mesh, axis: str
                  ) -> List[_Party]:
    """The positions along ``axis`` with every other index at 0 (the
    reference replicates the computation over the other axes; its result
    is the same on each, so one slice computes it)."""
    ax = mesh.axis_names.index(axis)
    idx = [0] * grid.ndim
    out = []
    for i in range(grid.shape[ax]):
        idx[ax] = i
        out.append(grid[tuple(idx)])
    return out


def ring_reduce_gemm_fn(mesh: Mesh, axis: str = "p",
                        precision: Optional[str] = None) -> Callable:
    """C = A@B with the contraction (K) dimension sharded over ``axis``.

    Each position computes a full-size partial product from its K shard;
    the partials combine by a reduce-scatter (row block i of C is the sum
    of every position's row block i, copied to position i and added in
    position order), leaving C row-sharded.  This is the reduction-edge
    analog of the reference's dataflow collectives (BT_reduction.jdf
    pattern).
    """
    grid = _grid(mesh)
    parties = _axis_parties(grid, mesh, axis)
    n = len(parties)

    def sharded(a, b):
        A, B = _whole(a), _whole(b)
        bk = _split(A.shape[1], n, "K")
        bm = _split(A.shape[0], n, "C rows")
        if B.shape[0] != A.shape[1]:
            raise ValueError(f"A {tuple(A.shape)} @ B {tuple(B.shape)}")
        parts = []
        with _products(parties, precision):
            for i, me in enumerate(parties):
                a_blk = me.take(A[:, i * bk:(i + 1) * bk])
                b_blk = me.take(B[i * bk:(i + 1) * bk, :])
                with me.run():
                    parts.append(torch.matmul(a_blk, b_blk))
        rows = []
        for i, me in enumerate(parties):
            acc = None
            for s, src in enumerate(parties):
                blk = parts[s][i * bm:(i + 1) * bm]
                blk = blk if s == i else me.take(blk, src)
                with me.run():
                    if acc is None:
                        # position order: the first addend is the sum's
                        # start (private: a copy, or a clone of our own)
                        acc = blk.clone() if s == i else blk
                    else:
                        acc.add_(blk)
            rows.append([(acc, me)])
        return _assemble(grid, rows)

    return sharded


def halo_stencil_fn(mesh: Mesh, axis: str = "p", radius: int = 1,
                    steps: int = 1) -> Callable:
    """1D 3-point stencil with ring halo exchange over ``axis``
    (reference: tests/apps/stencil 1D halo pattern; the neighbor sends are
    ring shifts between positions)."""
    grid = _grid(mesh)
    parties = _axis_parties(grid, mesh, axis)
    n = len(parties)
    r = radius

    def sharded(x):
        X = _whole(x)
        bs = _split(X.shape[0], n, "x")
        u = [me.take(X[i * bs:(i + 1) * bs]) for i, me in enumerate(parties)]
        for _ in range(steps):
            # fwd shift i -> i+1 carries u[-r:] (the receiver's left
            # halo); bwd shift i -> i-1 carries u[:r] (its right halo)
            left = [me.take(u[(i - 1) % n][-r:], parties[(i - 1) % n])
                    for i, me in enumerate(parties)]
            right = [me.take(u[(i + 1) % n][:r], parties[(i + 1) % n])
                     for i, me in enumerate(parties)]
            new = []
            for i, me in enumerate(parties):
                with me.run():
                    ext = torch.cat([left[i], u[i], right[i]])
                    new.append((ext[:-2 * r] + ext[2 * r:] + u[i]) / 3.0)
            u = new
        return _assemble(grid, [[(blk, me)] for blk, me in zip(u, parties)])

    return sharded


def _assemble(grid: np.ndarray, blocks) -> torch.Tensor:
    """The whole tensor from a row-major list of lists of (block, owner),
    on the first position's device (the reference's global array read
    back whole)."""
    home = grid.reshape(-1)[0]
    rows = [[blk if owner is home else home.take(blk, owner)
             for blk, owner in row] for row in blocks]
    with home.run():
        out = torch.cat([torch.cat(r, dim=1) if len(r) > 1 else r[0]
                         for r in rows], dim=0)
    if home.stream is not None:
        # the caller reads the result on its own stream
        torch.cuda.current_stream(out.device).wait_stream(home.stream)
        out.record_stream(torch.cuda.current_stream(out.device))
    return out
