"""Tiled QR factorization (dgeqrf): the irregular-DAG driver.

The port of ``parsec_tpu/apps/qr.py``: the DPLASMA-style flat-tree tile
algorithm

    GEQRT(k)    : QR of the diagonal tile; R stays in A[k,k], the
                  orthogonal factor Q1 (mb x mb) travels on a dataflow
                  edge.
    UNMQR(k,n)  : A[k,n] = Q1^T @ A[k,n]                     (n > k)
    TSQRT(m,k)  : QR of [R; A[m,k]] stacked — updates R in A[k,k] and
                  zeroes A[m,k]; the compact-WY pair (V, T^T)
                  travels on an edge.                         (m > k)
    TSMQR(m,n,k): applies the WY transform to [A(k,n); A(m,n)].
                  (m > k, n > k)

with the reference's matmul-class panel kernels.  TSQRT computes the
stacked QR by Cholesky-QR on the mb x mb Gram matrix and derives an
EXACT compact-WY representation in closed form:

    G  = R^T R + B^T B;   R' = +-chol(G)^T   (Householder sign choice:
                                sign(R'_jj) = -sign(R_jj), no
                                cancellation in S)
    S  = R - R';   V = B S^-1;   T^T = I - R'^-T R^T

and TSMQR is five mb^3-class products:

    Z = T^T (C1 + V^T C2);   C1 -= Z;   C2 -= V Z

INNER BLOCKING (``qr_ib``, the DPLASMA dgeqrf panel discipline): the
panel construction is cond^2-sensitive and runs in true f32; factoring
the panel in ib-wide column blocks confines that work to O(mb^2*ib) per
panel.  GEQRT is a blocked CholeskyQR2 (each block re-projected once
against the accumulated basis before its own two Cholesky-QR passes);
TSQRT builds a per-block compact-WY pair from the ib x ib Gram of
[R_jj; B_j], applies it to the trailing columns, and aggregates the
pairs into one panel-wide (V, T^T) with the standard T-accumulation

    T^T[J, :s] = -T_j^T (V_j^T V[:, :s]) T^T[:s, :s]

so TSMQR and the q2 edge layout are the same as unblocked.

Kernels and precision on the card:
  * both Gram products of every CholeskyQR2 pass (``_cholqr2``) launch
    the hand-written Gram kernel ``gram_tile`` (K2, plain f32 FMA);
  * the bf16-operand, f32-accumulating products of UNMQR and TSMQR
    launch the GEMM tile kernel ``gemm_tile`` (K1), whose (bf16, bf16,
    f32) and (f32, f32, f32) type sets are that contract on the CPU and
    on the card alike, with the reference's rounding points kept;
  * every other product is an f32 ``torch.matmul`` with TF32 off (the
    reference's HIGHEST) — ``qr_taskpool`` refuses to build while TF32 is
    on.  With TF32 off the reference's "default" and "highest" trailing
    update precisions are the same product, so ``qr_update_precision``
    has no counterpart; nor has ``qr_pallas_gram``: K2 always runs.
  * Cholesky and the Householder QR go to the card's solver library
    through torch, as the reference leaves them to XLA.

The guards.  Where the reference picks the Householder fallback on the
device (``lax.cond`` on a finiteness test), the port factors with
``torch.linalg.cholesky_ex`` (which neither raises nor synchronises, and
does not return NaN for a matrix that is not positive definite), folds
``info != 0`` and non-finite results into one device flag, and reads it on
the host once per GEQRT and TSQRT.  Each fallback taken adds one to
``qr_guard_fallbacks``; a fallback runs ``torch.linalg.qr`` on the same
device — it is the algorithm's own guard, not a device fallback.

On the device module at its defaults, UNMQR and TSMQR write their tiles
in place when they are donated, and a wave of either runs each of its K1
products as one grouped launch (the casts between them stay per task);
GEQRT(k) and the TSQRT(*,k) column are chain-held and run in the step of
the wave that consumes them (``fuse_chain``), with TSQRT on the diagonal
tile's device (``coaffinity``), as in the reference.

Across ranks (``A.nodes > 1``) the final R tiles are routed home
through the store classes ``RSTORE``/``CSTORE``, as in the reference
(``qr_taskpool``): two more task classes, NT - 1 and (NT - 1) NT / 2
tasks, each a copy of its tile.
"""

from __future__ import annotations

import torch

from parsec_tpu_torch.apps.cuda_kernels import Counter, \
    check_f32_matmul, gemm_tile_grouped, gram_tile
from parsec_tpu_torch.apps.potrf import tri_inv
from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.api import DATA, IN, NEW, OUT, PTG, Range, TASK
from parsec_tpu_torch.utils.mca import params

params.register("qr_ib", 512,
                "inner blocking of the QR panel construction: the true-f32 "
                "work per panel drops from O(mb^3) to O(mb^2*ib) (DPLASMA "
                "dgeqrf ib discipline); 0 disables — ignored unless "
                "0 < ib < mb and ib | mb")

#: guard fallbacks taken (a failed Cholesky or a non-finite panel result
#: replaced by the Householder construction), device and CPU bodies alike
qr_guard_fallbacks = Counter()


def effective_ib(mb: int) -> int:
    """The inner blocking actually used for an mb-wide panel: the
    ``qr_ib`` MCA param, clamped to 0 (unblocked) when it does not
    evenly block the panel."""
    try:
        ib = int(params.get("qr_ib", 512))
    except (TypeError, ValueError):
        return 0
    if ib <= 0 or ib >= mb or mb % ib:
        return 0
    return ib


def _flag(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=like.device)


def _guard_fails(bad: torch.Tensor, *results: torch.Tensor) -> bool:
    """The one host read of a panel task: True, and one more fallback
    counted, when a Cholesky failed or a result is not finite."""
    for x in results:
        bad = bad | ~torch.isfinite(x).all()
    if bool(bad):
        qr_guard_fallbacks.add()
        return True
    return False


def _chol_scaled(G: torch.Tensor):
    """Cholesky of the Jacobi-equilibrated Gram matrix (D G D with unit
    diagonal keeps a decaying R's range out of the factor); the exact
    factor is L = D^-1 chol(D G D).  Returns (L, failed flag)."""
    dg = torch.sqrt(torch.clamp(torch.diagonal(G), min=1e-30))
    Ls, info = torch.linalg.cholesky_ex(G / dg[:, None] / dg[None, :])
    return Ls * dg[:, None], info != 0


def _cholqr2(cols: torch.Tensor):
    """CholeskyQR2 of one mb x ib column block in true f32: returns (Q, R,
    failed flag) with Q orthonormal (two Gram+Cholesky passes — one pass
    loses orthogonality as cond^2*eps) and R = L2^T L^T upper
    triangular.  Both Gram products go through ``gram_tile``."""
    L, bad = _chol_scaled(gram_tile(cols))
    Q1 = cols @ tri_inv(L).T
    L2, info = torch.linalg.cholesky_ex(gram_tile(Q1))
    Q = Q1 @ tri_inv(L2).T
    R = L2.T @ L.T
    return Q, R, bad | (info != 0)


def _geqrt_blocked(Tf: torch.Tensor, ib: int):
    """Inner-blocked GEQRT construction: per-block CholeskyQR2 plus one
    re-projection against the accumulated basis (BCGS2-flavoured: rounding
    reintroduces ~eps*cond components that the trailing updates removed),
    trailing columns updated in place on a private copy.  Q comes out
    explicit — the blocks ARE its orthonormal columns.  Returns (R, Q,
    failed flag)."""
    mb = Tf.shape[0]
    A = Tf.clone()
    R = Tf.new_zeros((mb, mb))
    Qm = torch.empty_like(Tf)
    bad = _flag(Tf)
    for s in range(0, mb, ib):
        cols = A[:, s:s + ib]
        if s:
            Qacc = Qm[:, :s]
            prj = Qacc.T @ cols
            cols = cols - Qacc @ prj
            R[:s, s:s + ib] += prj    # the coefficients fold into R exactly
        else:
            cols = cols.contiguous()
        Qj, Rjj, bad_j = _cholqr2(cols)
        bad |= bad_j
        R[s:s + ib, s:s + ib] = Rjj
        if s + ib < mb:
            rest = A[:, s + ib:]
            Rjk = Qj.T @ rest
            rest -= Qj @ Rjk
            R[s:s + ib, s + ib:] = Rjk
        Qm[:, s:s + ib] = Qj
    return R, Qm, bad


def _mk_geqrt(ib: int = 0):
    def fn(T, Q):
        # factor in f32 even under bf16 tile storage; results land back
        # in the storage dtype
        Tf = T.float()
        mb = Tf.shape[0]
        if 0 < ib < mb and mb % ib == 0:
            R, Qm, bad = _geqrt_blocked(Tf, ib)
        else:
            Qm, R, bad = _cholqr2(Tf.contiguous())
        if _guard_fails(bad, R, Qm):
            Qm, R = torch.linalg.qr(Tf)      # Householder: unconditionally
        return {"T": R.to(T.dtype), "Q": Qm.to(T.dtype)}
    return fn


def _unmqr_wave(calls, *, donate=False):
    """UNMQR over a wave of (Q, C): bf16 operands, f32 accumulation (one
    K1 launch for the wave, accumulating into a zero C it owns), rounded
    once to storage — into C's own storage when donated."""
    zeros = [torch.zeros((Q.shape[1], C.shape[1]), dtype=torch.float32,
                         device=C.device) for Q, C in calls]
    prods = gemm_tile_grouped([Q.T.contiguous() for Q, _ in calls],
                              [C for _, C in calls], zeros, out=zeros)
    return [{"C": C.copy_(P) if donate else P.to(C.dtype)}
            for (_, C), P in zip(calls, prods)]


def _mk_unmqr():
    def fn(Q, C, *, donate=False):
        return _unmqr_wave([(Q, C)], donate=donate)[0]
    fn.grouped = _unmqr_wave
    return fn


def _wy_from_L(R, B, L, ti):
    """Closed-form compact-WY pair from ANY lower-triangular L with
    L L^T = R^T R + B^T B (Cholesky of the Gram matrix, however it was
    obtained): returns (R', V, T^T).  ``ti`` inverts a lower-triangular
    matrix."""
    mb = R.shape[0]
    # Householder sign choice: R'_jj = -sign(R_jj) * |R'_jj| makes
    # S = R - R' diagonally safe (|S_jj| >= |R'_jj|)
    d = torch.where(torch.diagonal(R) >= 0, -1.0, 1.0).to(R.dtype)
    Rp = d[:, None] * L.T
    S = R - Rp
    Sinv = ti(S.T).T                  # S upper-tri -> invert transpose
    V = B @ Sinv
    # R' = D L^T  =>  R'^-T = D L^-1
    Tt = torch.eye(mb, dtype=R.dtype, device=R.device) \
        - (d[:, None] * ti(L)) @ R.T
    return Rp, V, Tt


def _tsqrt_blocked(Rc, Bc, ib):
    """Inner-blocked TSQRT construction on private f32 copies ``Rc`` and
    ``Bc`` (updated in place): returns the panel-wide (R', V, T^T) with
    T^T block lower triangular, and the failed flag."""
    mb = Rc.shape[0]
    V = Rc.new_zeros((mb, mb))
    Tt = Rc.new_zeros((mb, mb))
    bad = _flag(Rc)
    for s in range(0, mb, ib):
        Rjj = Rc[s:s + ib, s:s + ib].clone()
        Bj = Bc[:, s:s + ib]
        L, bad_j = _chol_scaled(Rjj.T @ Rjj + Bj.T @ Bj)
        bad |= bad_j
        Rpjj, Vj, Tjt = _wy_from_L(Rjj, Bj, L, tri_inv)
        Rc[s:s + ib, s:s + ib] = Rpjj
        if s + ib < mb:
            # 5-product WY application to the trailing columns of the
            # stacked panel (same shape as TSMQR)
            C1 = Rc[s:s + ib, s + ib:]
            C2 = Bc[:, s + ib:]
            Z = Tjt @ (C1 + Vj.T @ C2)
            C1 -= Z
            C2 -= Vj @ Z
        if s:
            # T-accumulation: the unit tops of W are disjoint identity
            # columns, so W_j^T W_prev = V_j^T V[:, :s]
            cross = Vj.T @ V[:, :s]
            Tt[s:s + ib, :s] = -(Tjt @ (cross @ Tt[:s, :s]))
        V[:, s:s + ib] = Vj
        Tt[s:s + ib, s:s + ib] = Tjt
    return Rc, V, Tt, bad


def _tsqrt_unblocked(T, B):
    """Unblocked TSQRT construction with its own guard: a Householder QR
    of the stacked panel gives the same triangular factor when the Gram
    matrix's Cholesky fails."""
    L, bad = _chol_scaled(T.T @ T + B.T @ B)
    if _guard_fails(bad, L):
        Rh = torch.linalg.qr(torch.cat([T, B], dim=0), mode="r").R
        s = torch.where(torch.diagonal(Rh) >= 0, 1.0, -1.0).to(T.dtype)
        L = (s[:, None] * Rh).T          # positive-diagonal lower factor
    return _wy_from_L(T, B, L, tri_inv)


def _mk_tsqrt(ib: int = 0):
    def fn(T, B, Q):
        # the WY construction runs in f32 on private copies
        Tf = T.to(torch.float32, copy=True)
        Bf = B.to(torch.float32, copy=True)
        mb = Tf.shape[0]
        if 0 < ib < mb and mb % ib == 0:
            # an ill-conditioned BLOCK falls back to the unblocked
            # construction, which carries its own Householder guard
            Rp, V, Tt, bad = _tsqrt_blocked(Tf, Bf, ib)
            if _guard_fails(bad, Rp, V, Tt):
                Rp, V, Tt = _tsqrt_unblocked(T.float(), B.float())
        else:
            Rp, V, Tt = _tsqrt_unblocked(Tf, Bf)
        dt = Q.dtype                    # NEW-flow arena dtype = storage
        return {"T": Rp.to(dt), "B": torch.zeros_like(B, dtype=dt),
                "Q": torch.cat([V, Tt], dim=0).to(dt)}
    return fn


def _tsmqr_wave(calls, *, donate=False):
    """TSMQR over a wave of (Q, C1, C2): f32 accumulation through the
    5-product WY application, each of its three K1 products one grouped
    launch for the wave; intermediates round to the storage dtype where
    the reference rounds them (per task), outputs round back to it — into
    C1's and C2's own storage when donated.

    A grouped product needs every member's operands at once, so the wave
    holds n tasks' temporaries: each is dropped as soon as the next
    product has read it, and C1's update lands before the third product
    so that only the bf16 Z and C2's f32 seed live through it."""
    mb = calls[0][1].shape[0]
    Vs = [Q[:mb] for Q, _, _ in calls]
    Tts = [Q[mb:] for Q, _, _ in calls]
    # C1.float() seeds the product, and a bf16 tile's private f32 copy
    # takes its result; C1's update makes the copy again rather than hold
    # it across the other two products
    C1fs = [C1.float() for _, C1, _ in calls]
    inners = gemm_tile_grouped(
        [V.T.contiguous() for V in Vs], [C2 for _, _, C2 in calls], C1fs,
        1.0, out=[f if f is not C1 else None
                  for f, (_, C1, _) in zip(C1fs, calls)])
    del C1fs
    for i, Tt in enumerate(Tts):
        inners[i] = inners[i].to(Tt.dtype)
    Zs = [torch.zeros(x.shape, device=x.device) for x in inners]
    Zs = gemm_tile_grouped(Tts, inners, Zs, 1.0, out=Zs)
    del inners
    C1ns = []
    for i, ((_, C1, _), V) in enumerate(zip(calls, Vs)):
        if donate:
            C1.copy_(C1.float() - Zs[i])
            C1ns.append(C1)
        else:
            C1ns.append((C1.float() - Zs[i]).to(C1.dtype))
        Zs[i] = Zs[i].to(V.dtype)
    # C2.float() is C2 itself for f32 storage: accumulate in place only
    # when C2 is donated, always into a bf16 tile's private f32 copy
    C2fs = [C2.float() for _, _, C2 in calls]
    C2ns = gemm_tile_grouped(
        Vs, Zs, C2fs, -1.0,
        out=[f if donate or f is not C2 else None
             for f, (_, _, C2) in zip(C2fs, calls)])
    del C2fs, Zs
    outs = []
    for (_, C1, C2), C1n, C2n in zip(calls, C1ns, C2ns):
        if donate:
            if C2n is not C2:
                C2.copy_(C2n)
            outs.append({"C1": C1, "C2": C2})
        else:
            outs.append({"C1": C1n, "C2": C2n.to(C2.dtype)})
    return outs


def _mk_tsmqr():
    def fn(Q, C1, C2, *, donate=False):
        return _tsmqr_wave([(Q, C1, C2)], donate=donate)[0]
    fn.grouped = _tsmqr_wave
    return fn


def _cpu_tri_inv(L):
    eye = torch.eye(L.shape[0], dtype=L.dtype)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _cpu_geqrt(T, Q):
    q, r = torch.linalg.qr(T.double(), mode="complete")
    return {"T": r.to(T.dtype), "Q": q.to(Q.dtype)}


def _cpu_unmqr(Q, C):
    return {"C": (Q.double().T @ C.double()).to(C.dtype)}


def _cpu_tsqrt(T, B, Q):
    # the same compact-WY math as the device body, in float64 for
    # stability (Cholesky-QR squares the condition number)
    R64, B64 = T.double(), B.double()
    L, info = torch.linalg.cholesky_ex(R64.T @ R64 + B64.T @ B64)
    if int(info) != 0:
        # non-PD Gram matrix: Householder QR of the stacked panel gives
        # the same triangular factor, unconditionally stably
        qr_guard_fallbacks.add()
        Rh = torch.linalg.qr(torch.cat([R64, B64], dim=0), mode="r").R
        s = torch.where(torch.diagonal(Rh) >= 0, 1.0, -1.0).double()
        L = (s[:, None] * Rh).T
    Rp, V, Tt = _wy_from_L(R64, B64, L, _cpu_tri_inv)
    return {"T": Rp.to(T.dtype), "B": torch.zeros_like(B),
            "Q": torch.cat([V, Tt], dim=0).to(Q.dtype)}


def _cpu_tsmqr(Q, C1, C2):
    mb = C1.shape[0]
    Q64 = Q.double()
    V, Tt = Q64[:mb], Q64[mb:]
    C1n, C2n = C1.double(), C2.double()
    Z = Tt @ (C1n + V.T @ C2n)
    return {"C1": (C1n - Z).to(C1.dtype), "C2": (C2n - V @ Z).to(C2.dtype)}


def _store(X):
    """The routed stores' body (device and CPU alike): the tile passes
    through to its home ``-> DATA`` write-back, in storage of its own (as
    the reference's jitted identity returns a fresh buffer)."""
    return X.clone()


def qr_taskpool(A: TiledMatrix, device: str = "cuda") -> ParameterizedTaskpool:
    """Factor A in place: R in the upper triangle (Q is applied, not
    stored).  Requires a square tile grid evenly dividing A.

    ``device``: "cuda"/"gpu" gives every task class its device body ahead
    of the CPU body (float64 torch ops); anything else leaves the CPU
    bodies only."""
    if A.mt != A.nt:
        raise ValueError("qr driver needs a square tile grid")
    if A.lm % A.mb or A.ln % A.nb:
        raise ValueError("qr tiles must divide the matrix evenly")
    check_f32_matmul("the QR panel construction")
    NT = A.mt
    mb = A.mb
    use_device = device in ("cuda", "gpu")
    # inner blocking resolves ONCE per build
    ib = effective_ib(mb)
    # Owner-computes discipline for the final R tiles: the LAST TSQRT of
    # column k (and the last TSMQR of each row-k tile) runs where
    # A(NT-1, k) lives, but its R output belongs home at A(k, *).  On
    # one rank the write-back is local; across ranks it is routed
    # through a store task pinned to the home tile, so the payload rides
    # a normal dataflow edge (remote-dep protocol) instead of a
    # cross-rank direct write (reference counterpart: remote output
    # deps land via the ACTIVATE/GET protocol, remote_dep_mpi.c, never
    # by writing another rank's memory).
    routed = A.nodes > 1

    def bodies(tb, kernel, cpu_fn):
        if use_device:
            tb.body(kernel, device=device)
        tb.body(cpu_fn)
        return tb

    p = PTG("geqrf", NT=NT)
    p.arena("q1", (mb, mb), dtype=A.dtype)
    p.arena("q2", (2 * mb, mb), dtype=A.dtype)   # stacked [V; T^T]

    # GEQRT(k): diagonal QR
    tb = p.task("GEQRT", k=Range(0, NT - 1)) \
        .affinity(lambda k, A=A: A(k, k)) \
        .priority(lambda k, NT=NT: 4 * (NT - k) + 3) \
        .flow("T", "RW",
              IN(DATA(lambda k, A=A: A(k, k)), when=lambda k: k == 0),
              IN(TASK("TSMQR", "C2", lambda k: dict(m=k, n=k, k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("TSQRT", "T", lambda k, NT=NT: dict(m=k + 1, k=k)),
                  when=lambda k, NT=NT: k < NT - 1),
              OUT(DATA(lambda k, A=A: A(k, k)),
                  when=lambda k, NT=NT: k == NT - 1)) \
        .flow("Q", "RW",
              IN(NEW("q1")),
              OUT(TASK("UNMQR", "Q",
                       lambda k, NT=NT: [dict(k=k, n=n)
                                         for n in range(k + 1, NT)]),
                  when=lambda k, NT=NT: k < NT - 1))
    bodies(tb, _mk_geqrt(ib), _cpu_geqrt)

    # UNMQR(k, n): apply Q1^T across the k-th block row
    tb = p.task("UNMQR", k=Range(0, NT - 2), n=Range(lambda k: k + 1,
                                                     NT - 1)) \
        .affinity(lambda k, n, A=A: A(k, n)) \
        .priority(lambda k, NT=NT: 4 * (NT - k) + 2) \
        .flow("Q", "READ", IN(TASK("GEQRT", "Q", lambda k: dict(k=k)))) \
        .flow("C", "RW",
              IN(DATA(lambda k, n, A=A: A(k, n)), when=lambda k: k == 0),
              IN(TASK("TSMQR", "C2", lambda k, n: dict(m=k, n=n, k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("TSMQR", "C1", lambda k, n: dict(m=k + 1, n=n, k=k))))
    bodies(tb, _mk_unmqr(), _cpu_unmqr)

    # TSQRT(m, k): fold block-column tile m into R(k)
    tb = p.task("TSQRT", k=Range(0, NT - 2), m=Range(lambda k: k + 1,
                                                     NT - 1)) \
        .affinity(lambda m, k, A=A: A(m, k)) \
        .priority(lambda k, NT=NT: 4 * (NT - k) + 1) \
        .flow("T", "RW",
              IN(TASK("GEQRT", "T", lambda k: dict(k=k)),
                 when=lambda m, k: m == k + 1),
              IN(TASK("TSQRT", "T", lambda m, k: dict(m=m - 1, k=k)),
                 when=lambda m, k: m > k + 1),
              OUT(TASK("TSQRT", "T", lambda m, k: dict(m=m + 1, k=k)),
                  when=lambda m, NT=NT: m < NT - 1),
              (OUT(TASK("RSTORE", "X", lambda k: dict(k=k)),
                   when=lambda m, NT=NT: m == NT - 1) if routed else
               OUT(DATA(lambda k, A=A: A(k, k)),
                   when=lambda m, NT=NT: m == NT - 1))) \
        .flow("B", "RW",
              IN(DATA(lambda m, k, A=A: A(m, k)), when=lambda k: k == 0),
              IN(TASK("TSMQR", "C2", lambda m, k: dict(m=m, n=k, k=k - 1)),
                 when=lambda k: k > 0),
              OUT(DATA(lambda m, k, A=A: A(m, k)))) \
        .flow("Q", "RW",
              IN(NEW("q2")),
              OUT(TASK("TSMQR", "Q",
                       lambda m, k, NT=NT: [dict(m=m, n=n, k=k)
                                            for n in range(k + 1, NT)]),
                  when=lambda k, NT=NT: k < NT - 1))
    bodies(tb, _mk_tsqrt(ib), _cpu_tsqrt)

    # TSMQR(m, n, k): apply Q2^T to the [A(k,n); A(m,n)] pair
    tb = p.task("TSMQR", k=Range(0, NT - 2),
                m=Range(lambda k: k + 1, NT - 1),
                n=Range(lambda k: k + 1, NT - 1)) \
        .affinity(lambda m, n, A=A: A(m, n)) \
        .priority(lambda k, NT=NT: 4 * (NT - k)) \
        .flow("Q", "READ", IN(TASK("TSQRT", "Q", lambda m, k: dict(m=m,
                                                                   k=k)))) \
        .flow("C1", "RW",
              IN(TASK("UNMQR", "C", lambda n, k: dict(k=k, n=n)),
                 when=lambda m, k: m == k + 1),
              IN(TASK("TSMQR", "C1", lambda m, n, k: dict(m=m - 1, n=n,
                                                          k=k)),
                 when=lambda m, k: m > k + 1),
              OUT(TASK("TSMQR", "C1", lambda m, n, k: dict(m=m + 1, n=n,
                                                           k=k)),
                  when=lambda m, NT=NT: m < NT - 1),
              (OUT(TASK("CSTORE", "X", lambda k, n: dict(k=k, n=n)),
                   when=lambda m, NT=NT: m == NT - 1) if routed else
               OUT(DATA(lambda k, n, A=A: A(k, n)),
                   when=lambda m, NT=NT: m == NT - 1))) \
        .flow("C2", "RW",
              IN(DATA(lambda m, n, A=A: A(m, n)), when=lambda k: k == 0),
              IN(TASK("TSMQR", "C2", lambda m, n, k: dict(m=m, n=n,
                                                          k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("GEQRT", "T", lambda m: dict(k=m)),
                  when=lambda m, n, k: m == k + 1 and n == k + 1),
              OUT(TASK("TSQRT", "B", lambda m, n, k: dict(m=m, k=k + 1)),
                  when=lambda m, n, k: m > k + 1 and n == k + 1),
              OUT(TASK("UNMQR", "C", lambda m, n, k: dict(k=k + 1, n=n)),
                  when=lambda m, n, k: m == k + 1 and n > k + 1),
              OUT(TASK("TSMQR", "C2", lambda m, n, k: dict(m=m, n=n,
                                                           k=k + 1)),
                  when=lambda m, n, k: m > k + 1 and n > k + 1))
    bodies(tb, _mk_tsmqr(), _cpu_tsmqr)

    if routed:
        tb = p.task("RSTORE", k=Range(0, NT - 2)) \
            .affinity(lambda k, A=A: A(k, k)) \
            .flow("X", "RW",
                  IN(TASK("TSQRT", "T", lambda k, NT=NT: dict(m=NT - 1,
                                                              k=k))),
                  OUT(DATA(lambda k, A=A: A(k, k))))
        bodies(tb, _store, _store)
        tb = p.task("CSTORE", k=Range(0, NT - 2),
                    n=Range(lambda k: k + 1, NT - 1)) \
            .affinity(lambda k, n, A=A: A(k, n)) \
            .flow("X", "RW",
                  IN(TASK("TSMQR", "C1",
                          lambda k, n, NT=NT: dict(m=NT - 1, n=n, k=k))),
                  OUT(DATA(lambda k, n, A=A: A(k, n))))
        bodies(tb, _store, _store)

    tp = p.build()
    for name, tc in tp.task_classes.items():
        # executed-flop weights for device load balancing (stores move
        # a tile, no flops)
        tc.properties["flops"] = {"GEQRT": 2.0 * mb ** 3,
                                  "UNMQR": 2.0 * mb ** 3,
                                  "TSQRT": 6.0 * mb ** 3,
                                  "TSMQR": 10.0 * mb ** 3}.get(name, 1.0)
    # cross-panel chain fusion (devices/cuda.py): the GEQRT(k) ->
    # TSQRT(k+1,k) -> ... -> TSQRT(NT-1,k) column is the serial spine of the
    # DAG — each link's only missing input is its predecessor's T — so the
    # device module holds the links and runs the column in the launch step
    # of the wave consuming it.  TSQRT co-locates on the diagonal tile's
    # device so the column is a chain on ONE device.
    tp.task_classes["GEQRT"].properties["fuse_chain"] = ("T", "TSQRT")
    tp.task_classes["TSQRT"].properties["fuse_chain"] = ("T", "TSQRT")
    tp.task_classes["TSQRT"].properties["coaffinity"] = \
        lambda loc, A=A: A(loc["k"], loc["k"])
    return tp


def geqrf_flops(m: int, n: int) -> float:
    """Useful FLOPs of an m x n QR factorization (2mn^2 - 2n^3/3;
    = 4n^3/3 when square)."""
    return 2.0 * m * n * n - 2.0 * n ** 3 / 3.0
