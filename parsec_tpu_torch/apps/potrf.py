"""Tiled Cholesky factorization (dpotrf, lower): the north-star app.

The port of ``parsec_tpu/apps/potrf.py``: the DPLASMA-style dpotrf_L
dataflow

    POTRF(k)    : L[k,k]  = chol(A[k,k]);  W[k] = L[k,k]^-1   (k < NT-1)
    POTRFL      : L[NT-1,NT-1] = chol(A[NT-1,NT-1])  (no panel below it)
    TRSM(m,k)   : A[m,k]  = A[m,k] @ W[k]^T                  (m > k)
    SYRK(m,k)   : A[m,m] -= A[m,k] @ A[m,k]^T                (k < m)
    GEMM(m,n,k) : A[m,n] -= A[m,k] @ A[n,k]^T                (m > n > k)

with the reference's five task classes, flows, priorities (POTRF > TRSM >
SYRK > GEMM at equal k), f32 ``"w"`` arena and executed-flop weights.
POTRF emits the tile inverse W (``tri_inv``: matrix products only, since a
triangular solve runs far below the matmul rate on an accelerator), so
each TRSM is one product against W.

Tiles are f32, or bf16 storage (the bench's mixed-precision mode): the
Cholesky runs on the f32 upcast, W always stays f32, products accumulate
in f32 and results round once to the tile's type.

Kernels and precision on the card:
  * SYRK and GEMM run the transposed-B variant of the hand-written GEMM
    tile kernel, ``gemm_tile(L, R, C, -1.0, trans_b=True)`` (K1; bf16
    tiles read and written in bf16 on its ``wgmma`` route, f32 tiles on
    its ``fma`` route);
  * TRSM runs the hand-written triangular tile kernel, ``trsm_tile(C,
    W)`` (``C @ tril(W)^T``: plain f32 FMA that skips W's zero upper
    half, C read and written in its own type, one rounding), where the
    reference leaves its mixed bf16 x f32 product to XLA outside any
    Pallas kernel;
  * ``potrf_taskpool`` refuses to build while TF32 is on, so every f32
    product in the library (``tri_inv``'s) is a full f32 product;
  * the Cholesky goes to the card's solver library through
    ``torch.linalg.cholesky_ex``.

Two differences from the reference's bodies are deliberate:
  * the device POTRF factors the symmetrized tile (T + T^T)/2, as
    ``jnp.linalg.cholesky`` does by default (``symmetrize_input=True``);
    the CPU bodies read the lower triangle only, as numpy's Cholesky
    does.  The two differ on a diagonal tile that is not symmetric;
  * where the reference's Cholesky returns NaNs for a tile that is not
    positive definite, ``cholesky_ex`` reports it in ``info`` without
    synchronising the host: each POTRF folds ``info != 0`` and a
    non-finite factor into the pool's device flag
    (``tp.cholesky_check``), which the caller reads once the pool has
    run.  The CPU bodies raise, as numpy does.

On the device module at its defaults, SYRK and GEMM write their tile in
place when it is donated, and a wave of them is one grouped K1 launch;
POTRF(k) is chain-held and runs in the step of its TRSM wave
(``fuse_chain``), and TRSM follows the diagonal tile's device
(``coaffinity``), as in the reference.  Across ranks nothing changes:
every task runs where the collection's ``rank_of`` places its tile, and
the remote-dep protocol carries the cross-rank edges; the chain fusion
of the device module is off there.

Recovery (core/recovery.py): the pool's ``recovery_collections`` is
``[A]``, as in the reference, so with ``recovery_enable`` a peer death
re-maps A's lost partition onto the survivors and re-enumerates the pool
from restored tiles.  Adopted tiles need a re-runnable source:
``A.set_init(bench_operand(...))`` remakes the bench operand's tiles on
the card, bit for bit the ones ``bench_operand`` made before the run.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import torch

from parsec_tpu_torch.apps.cuda_kernels import check_f32_matmul, \
    gemm_tile, gemm_tile_grouped, trsm_tile
from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.api import DATA, IN, NEW, OUT, PTG, Range, TASK

#: recursive-inversion leaf: below this order the Newton iteration runs
#: directly (log2(leaf) + 1 products of leaf x leaf)
_INV_LEAF = 512


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Lower-triangular inverse as pure matrix products.

    Recursive 2x2 block inversion
        [[L11, 0], [L21, L22]]^-1 =
        [[X11, 0], [-X22 @ L21 @ X11, X22]]
    with Newton--Schulz leaves: X <- X(2I - LX) starting from
    X0 = diag(L)^-1 converges EXACTLY in ceil(log2(n)) steps because the
    initial residual I - LX0 is strictly triangular (nilpotent) and each
    step squares it.
    """
    n = L.shape[0]
    if n <= _INV_LEAF:
        X = torch.diag(1.0 / torch.diagonal(L))
        two_i = 2.0 * torch.eye(n, dtype=L.dtype, device=L.device)
        for _ in range(int(math.ceil(math.log2(max(n, 2)))) + 1):
            X = X @ (two_i - L @ X)
        return X
    h = n // 2
    X11 = tri_inv(L[:h, :h])
    X22 = tri_inv(L[h:, h:])
    X21 = -(X22 @ (L[h:, :h] @ X11))
    top = torch.cat([X11, L.new_zeros((h, n - h))], dim=1)
    return torch.cat([top, torch.cat([X21, X22], dim=1)], dim=0)


class CholeskyCheck:
    """Failed Cholesky factors of one taskpool, recorded on the device.

    ``fold`` ORs a boolean scalar into this pool's flag on the scalar's
    device, on the current stream, so no task body waits for the host.
    ``failed`` reads every flag, a host synchronisation: call it after the
    pool has run, outside any timed window."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flags: Dict[torch.device, torch.Tensor] = {}

    def fold(self, bad: torch.Tensor) -> None:
        with self._lock:
            flag = self._flags.get(bad.device)
            if flag is None:
                self._flags[bad.device] = bad.clone()
            else:
                flag |= bad

    def failed(self) -> bool:
        with self._lock:
            flags = list(self._flags.values())
        return any(bool(f) for f in flags)


def _cholesky(T: torch.Tensor, check: CholeskyCheck) -> torch.Tensor:
    """The f32 Cholesky factor of the symmetrized tile, as
    ``jnp.linalg.cholesky`` computes it; a failure goes to ``check``."""
    Tf = T.float()
    L, info = torch.linalg.cholesky_ex((Tf + Tf.mT) / 2)
    check.fold((info != 0) | ~torch.isfinite(L).all())
    return L


def _mk_potrf(check: CholeskyCheck):
    def fn(T, W):
        # factor in f32 even under bf16 tile storage; the inverse W always
        # stays f32: it multiplies every panel tile
        L = _cholesky(T, check)
        return {"T": L.to(T.dtype), "W": tri_inv(L)}
    return fn


def _mk_potrf_last(check: CholeskyCheck):
    # the last diagonal tile has no TRSM consumers: no inverse
    def fn(T):
        return _cholesky(T, check).to(T.dtype)
    return fn


def _k_trsm(W, C):
    # C <- C @ L^-T == C @ W^T (W = L^-1 from POTRF, lower triangular): one
    # triangular f32 product
    return trsm_tile(C, W)


def _k_syrk(T, R, *, donate=False):
    return gemm_tile(R, R, T, -1.0, trans_b=True, out=T if donate else None)


def _k_gemm(C, L, R, *, donate=False):
    return gemm_tile(L, R, C, -1.0, trans_b=True, out=C if donate else None)


def _syrk_wave(calls, *, donate=False):
    # a wave of SYRK tasks: one grouped K1 launch
    Ts, Rs = zip(*calls)
    return gemm_tile_grouped(Rs, Rs, Ts, -1.0, trans_b=True,
                             out=Ts if donate else None)


def _gemm_wave(calls, *, donate=False):
    Cs, Ls, Rs = zip(*calls)
    return gemm_tile_grouped(Ls, Rs, Cs, -1.0, trans_b=True,
                             out=Cs if donate else None)


_k_syrk.grouped = _syrk_wave
_k_gemm.grouped = _gemm_wave


def _cpu_potrf(T, W):
    L = torch.linalg.cholesky(T.float())
    eye = torch.eye(L.shape[0], dtype=L.dtype)
    return {"T": L.to(T.dtype),
            "W": torch.linalg.solve_triangular(L, eye, upper=False)}


def _cpu_potrf_last(T):
    return torch.linalg.cholesky(T.float()).to(T.dtype)


def _cpu_trsm(W, C):
    return (C.float() @ W.float().T).to(C.dtype)


def _cpu_syrk(T, R):
    r = R.float()
    return (T.float() - r @ r.T).to(T.dtype)


def _cpu_gemm(C, L, R):
    return (C.float() - L.float() @ R.float().T).to(C.dtype)


def potrf_taskpool(A: TiledMatrix, device: str = "cuda",
                   precision: Optional[str] = None) -> ParameterizedTaskpool:
    """Factor the lower triangle of A in place: A = L @ L^T.  Requires a
    square tile grid evenly dividing A.

    ``device``: "cuda"/"gpu" gives every task class its device body ahead
    of the CPU body; anything else leaves the CPU bodies only.
    ``precision``: None or "highest" — with TF32 refused, every f32
    product is a full f32 product, which is what both of the reference's
    precisions give in its f32 run.  The pool's ``cholesky_check`` records
    failed device factors."""
    if A.mt != A.nt:
        raise ValueError("potrf needs a square tile grid")
    if A.lm % A.mb or A.ln % A.nb:
        raise ValueError("potrf tiles must divide the matrix evenly")
    if precision not in (None, "highest"):
        raise ValueError(f"potrf: precision {precision!r}: only full f32 "
                         "products (None or 'highest') are ported")
    check_f32_matmul("the tiled Cholesky")
    NT = A.mt
    mb = A.mb
    use_device = device in ("cuda", "gpu")
    check = CholeskyCheck()

    def bodies(tb, kernel, cpu_fn):
        if use_device:
            tb.body(kernel, device=device)
        tb.body(cpu_fn)
        return tb

    p = PTG("potrf", NT=NT)
    # the panel inverse is always f32, even when tiles store bf16
    p.arena("w", (mb, mb), dtype=torch.float32)

    tb = p.task("POTRF", k=Range(0, NT - 2)) \
        .affinity(lambda k, A=A: A(k, k)) \
        .priority(lambda k, NT=NT: 3 * NT - 3 * k + 3) \
        .flow("T", "RW",
              IN(DATA(lambda k, A=A: A(k, k)), when=lambda k: k == 0),
              IN(TASK("SYRK", "T", lambda k: dict(k=k - 1, m=k)),
                 when=lambda k: k > 0),
              OUT(DATA(lambda k, A=A: A(k, k)))) \
        .flow("W", "RW",
              IN(NEW("w")),
              OUT(TASK("TRSM", "W",
                       lambda k, NT=NT: [dict(m=m, k=k)
                                         for m in range(k + 1, NT)])))
    bodies(tb, _mk_potrf(check), _cpu_potrf)

    # the final diagonal tile: no panel below it, so no inverse is needed
    tb = p.task("POTRFL") \
        .affinity(lambda A=A, NT=NT: A(NT - 1, NT - 1)) \
        .priority(lambda NT=NT: 6) \
        .flow("T", "RW",
              IN(DATA(lambda A=A, NT=NT: A(NT - 1, NT - 1)),
                 when=lambda NT=NT: NT == 1),
              IN(TASK("SYRK", "T", lambda NT=NT: dict(k=NT - 2, m=NT - 1)),
                 when=lambda NT=NT: NT > 1),
              OUT(DATA(lambda A=A, NT=NT: A(NT - 1, NT - 1))))
    bodies(tb, _mk_potrf_last(check), _cpu_potrf_last)

    tb = p.task("TRSM", k=Range(0, NT - 2),
                m=Range(lambda k: k + 1, NT - 1)) \
        .affinity(lambda m, k, A=A: A(m, k)) \
        .priority(lambda k, NT=NT: 3 * NT - 3 * k + 2) \
        .flow("W", "READ", IN(TASK("POTRF", "W", lambda k: dict(k=k)))) \
        .flow("C", "RW",
              IN(DATA(lambda m, k, A=A: A(m, k)), when=lambda k: k == 0),
              IN(TASK("GEMM", "C", lambda m, k: dict(m=m, n=k, k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("SYRK", "R", lambda m, k: dict(k=k, m=m))),
              OUT(TASK("GEMM", "L",
                       lambda m, k: [dict(m=m, n=n, k=k)
                                     for n in range(k + 1, m)]),
                  when=lambda m, k: m > k + 1),
              OUT(TASK("GEMM", "R",
                       lambda m, k, NT=NT: [dict(m=m2, n=m, k=k)
                                            for m2 in range(m + 1, NT)]),
                  when=lambda m, NT=NT: m < NT - 1),
              OUT(DATA(lambda m, k, A=A: A(m, k))))
    bodies(tb, _k_trsm, _cpu_trsm)

    tb = p.task("SYRK", m=Range(1, NT - 1), k=Range(0, lambda m: m - 1)) \
        .affinity(lambda m, A=A: A(m, m)) \
        .priority(lambda k, NT=NT: 3 * NT - 3 * k + 1) \
        .flow("T", "RW",
              IN(DATA(lambda m, A=A: A(m, m)), when=lambda k: k == 0),
              IN(TASK("SYRK", "T", lambda m, k: dict(m=m, k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("POTRF", "T", lambda m: dict(k=m)),
                  when=lambda m, k, NT=NT: k == m - 1 and m < NT - 1),
              OUT(TASK("POTRFL", "T", lambda: dict()),
                  when=lambda m, k, NT=NT: k == m - 1 and m == NT - 1),
              OUT(TASK("SYRK", "T", lambda m, k: dict(m=m, k=k + 1)),
                  when=lambda m, k: k < m - 1)) \
        .flow("R", "READ", IN(TASK("TRSM", "C", lambda m, k: dict(m=m,
                                                                  k=k))))
    bodies(tb, _k_syrk, _cpu_syrk)

    tb = p.task("GEMM", n=Range(1, NT - 2),
                m=Range(lambda n: n + 1, NT - 1),
                k=Range(0, lambda n: n - 1)) \
        .affinity(lambda m, n, A=A: A(m, n)) \
        .priority(lambda k, NT=NT: 3 * NT - 3 * k) \
        .flow("C", "RW",
              IN(DATA(lambda m, n, A=A: A(m, n)), when=lambda k: k == 0),
              IN(TASK("GEMM", "C", lambda m, n, k: dict(m=m, n=n, k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("TRSM", "C", lambda m, n: dict(m=m, k=n)),
                  when=lambda n, k: k == n - 1),
              OUT(TASK("GEMM", "C", lambda m, n, k: dict(m=m, n=n, k=k + 1)),
                  when=lambda n, k: k < n - 1)) \
        .flow("L", "READ", IN(TASK("TRSM", "C", lambda m, k: dict(m=m,
                                                                  k=k)))) \
        .flow("R", "READ", IN(TASK("TRSM", "C", lambda n, k: dict(m=n,
                                                                  k=k))))
    bodies(tb, _k_gemm, _cpu_gemm)

    tp = p.build()
    for name, tc in tp.task_classes.items():
        # executed-flop weights for device load balancing (TRSM runs as a
        # full product against W, so it carries 2mb^3, not the mb^3 of a
        # true triangular solve)
        tc.properties["flops"] = {"POTRF": mb ** 3,
                                  "POTRFL": mb ** 3 / 3.0,
                                  "TRSM": 2.0 * mb ** 3,
                                  "SYRK": 2.0 * mb ** 3,
                                  "GEMM": 2.0 * mb ** 3}[name]
    # cross-panel chain fusion (devices/cuda.py): the POTRF(k) -> TRSM(*,k)
    # panel is the spine of the DAG (each TRSM's only missing input is W),
    # so the device module holds POTRF(k) and runs it in its TRSM wave's
    # launch step; TRSM co-locates on the diagonal tile's device so the
    # whole panel is one wave there.  A/B knob:
    # PARSEC_MCA_DEVICE_FUSE_PANEL=0 restores the per-kernel panel path.
    tp.task_classes["POTRF"].properties["fuse_chain"] = ("W", "TRSM")
    tp.task_classes["TRSM"].properties["coaffinity"] = \
        lambda loc, A=A: A(loc["k"], loc["k"])
    tp.cholesky_check = check
    # recovery spec (core/recovery.py): the whole dataflow reads and
    # writes A, so a peer death can re-map A's lost partition onto the
    # survivors and re-enumerate this pool from the restored tiles —
    # give A an init_fn (A.set_init) so ADOPTED tiles have a
    # re-runnable source, and the pool recovers instead of failing
    tp.recovery_collections = [A]
    return tp


def bench_operand(n: int, mb: int, dtype: torch.dtype,
                  device: torch.device):
    """The JAX package's potrf bench operand (``bench.py::_tile_generator``
    as ``run_potrf_bench`` stages it), as ``tile(m, k)`` on ``device``:
    column j of tile (m, k) holds (j * 1e-5 + s * 1e-3) mod 1, s the
    tile's index in a one-rank layout's ``local_tiles()`` order (m * nt +
    k, upper tiles counted), plus n on a diagonal tile's diagonal, all in
    f32, then rounded to ``dtype``.  Deterministic per tile, so it
    regenerates the operand without a second resident copy, and serves as
    the re-runnable source (``set_init``) that remakes a dead rank's
    tiles.  The diagonal tiles are not symmetric (every row is the
    same)."""
    nt = n // mb
    col = torch.arange(mb, dtype=torch.float32, device=device) * 1e-5

    def tile(m: int, k: int) -> torch.Tensor:
        s = float(torch.tensor(m * nt + k, dtype=torch.float32)
                  * torch.tensor(1e-3, dtype=torch.float32))
        t = ((col + s) % 1.0).repeat(mb, 1)
        if m == k:
            t.diagonal().add_(float(n))
        return t.to(dtype)
    return tile


def potrf_flops(n: int) -> float:
    """Useful FLOPs of an n x n Cholesky (n^3/3)."""
    return n ** 3 / 3.0
