"""The multichip dryrun's twin: the whole multi-device path over n device
modules of one process.

The JAX package's ``__graft_entry__.dryrun_multichip(n)`` validates its
multi-chip path on an n-device mesh: the SPMD schedules every multi-chip
PTG lowers to (SURVEY.md §5.8), then real runtime task graphs — a tiled
GEMM with panel broadcasts, a permute wave, potrf and geqrf — spread
over the n devices, with the ICI engine's counts printed per graph
(``MULTICHIP_r05.json`` is its record).  This module runs the same steps
with the same checks and prints over the port: ``device="cuda*n"`` (the
default: n modules over card 0, each its own launch stream and memory
budget) or ``"cpu:n"`` (CPU-backed modules, for tests).

    python -m parsec_tpu_torch.parallel.dryrun [n] [device]
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from parsec_tpu_torch.utils.mca import params


def dryrun_multichip(n_devices: int = 8, device: Optional[str] = None
                     ) -> dict:
    """Run every step; raise on a failed check.  Returns each runtime
    graph's relative error and ICI counts."""
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.parallel.spmd import (halo_stencil_fn, make_mesh,
                                                ring_reduce_gemm_fn,
                                                summa_gemm_fn)
    device = device or f"cuda*{n_devices}"
    out = {}
    with Context(nb_cores=4, device=device) as ctx:
        devs = list(ctx.device_registry.accelerators)
        if len(devs) < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have "
                               f"{len(devs)} on {device!r}")
        devs = devs[:n_devices]
        rng = np.random.default_rng(0)
        mesh2d = make_mesh(devices=devs)          # most-square (p, q) grid
        p, q = mesh2d.devices.shape
        m, k, n = 8 * p, 8 * p * q, 8 * q
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)

        # 1) owner-computes 2D GEMM; panel bcasts = all-gather on both axes
        c = _host(summa_gemm_fn(mesh2d)(a, b))
        np.testing.assert_allclose(c, a @ b, rtol=1e-3, atol=1e-3)

        # 2) contraction-sharded GEMM; combine = reduce-scatter ring
        mesh1d = make_mesh(shape=(n_devices,), axis_names=("p",),
                           devices=devs)
        c2 = _host(ring_reduce_gemm_fn(mesh1d)(a, b))
        np.testing.assert_allclose(c2, a @ b, rtol=1e-3, atol=1e-3)

        # 3) halo-exchange pipeline on the ring
        x = rng.standard_normal(16 * n_devices).astype(np.float32)
        y = _host(halo_stencil_fn(mesh1d, steps=2)(x))
        y_finite = bool(np.isfinite(y).all())
        assert y.shape == x.shape and y_finite

        print(f"dryrun_multichip({n_devices}): mesh {p}x{q} ok — "
              "summa all_gather, psum_scatter ring, ppermute halo")

        # 4) a REAL runtime task graph over every module: tiled GEMM
        # through Context -> PTG -> dep engine -> device modules with
        # panel fan-outs moved by the ICI engine, validated numerically
        out["gemm"] = _runtime_gemm(ctx)
    out.update(_dense_factorizations(device))
    return out


def _host(t) -> np.ndarray:
    from parsec_tpu_torch.data.data import to_host
    return to_host(t).numpy()


def _ndev(ctx) -> int:
    return len(ctx.device_registry.accelerators)


def _stats(ctx) -> dict:
    return ctx.ici.stats.as_dict() if ctx.ici is not None else {}


def _runtime_gemm(ctx) -> dict:
    from parsec_tpu_torch.apps.gemm import gemm_taskpool
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

    rng = np.random.default_rng(1)
    mb, nt = 32, 4
    n = mb * nt
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    c = np.zeros((n, n), np.float32)
    A = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, name="A").from_array(a)
    B = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, name="B").from_array(b)
    C = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, name="C").from_array(c)
    C.distribute_devices(ctx)   # owner-computes over the device mesh
    ctx.add_taskpool(gemm_taskpool(A, B, C, device="cuda",
                                   panel_bcast=True))
    ctx.wait(timeout=300)
    # the GEMM's counts BEFORE the wave step, so the printed per-phase
    # stats stay attributable
    ici = _stats(ctx)
    _permute_wave(ctx)
    after = _stats(ctx)
    ici_wave = {k: after[k] - ici[k] for k in after}
    err = float(np.abs(C.to_numpy() - a @ b).max()
                / max(1.0, np.abs(a @ b).max()))
    assert err < 1e-4, f"runtime GEMM error {err}"
    print(f"dryrun runtime graph: tiled GEMM over {_ndev(ctx)} devices ok "
          f"(rel err {err:.2e}); ici collectives: {ici}; "
          f"permute wave: {ici_wave}")
    return {"rel_err": err, "ici": ici, "wave": ici_wave}


def _permute_wave(ctx) -> None:
    """A wavefront of cross-module single-consumer edges THROUGH the
    runtime: P producers each feed the consumer on the next module, and
    the release path batches the full round into one permute (comm/ici.py
    defer_place)."""
    from parsec_tpu_torch.apps.wave import (expected_wave_result,
                                            fill_wave_inputs,
                                            permute_wave_taskpool)
    from parsec_tpu_torch.data.matrix import VectorTwoDimCyclic

    if ctx.ici is None or ctx.ici.ndev < 4:
        return
    ndev = ctx.ici.ndev
    before = ctx.ici.stats.as_dict()
    V = VectorTwoDimCyclic(mb=8, lm=8 * ndev)
    W = VectorTwoDimCyclic(mb=8, lm=8 * ndev)
    fill_wave_inputs(V, W)
    V.distribute_devices(ctx)
    W.distribute_devices(ctx)
    params.set("comm_ici_permute_window_ms", 1000.0)
    try:
        ctx.add_taskpool(permute_wave_taskpool(V, W))
        ctx.wait(timeout=300)
        ctx.flush_ici()
    finally:
        params.unset("comm_ici_permute_window_ms")
    for q in range(ndev):
        got = _host(W.data_of(q).pull_to_host().payload)
        np.testing.assert_allclose(got, expected_wave_result(ndev, q))
    # the values above are the correctness gate; this asserts only that
    # the ICI engine carried the wavefront (a put or a permute)
    d = {k: v - before[k] for k, v in ctx.ici.stats.as_dict().items()}
    assert d["permutes"] > 0 or d["puts"] > 0, \
        f"wavefront produced no ici movement: {d}"


def _dense_factorizations(device: str) -> dict:
    """The north-star apps over the full module mesh: tiled Cholesky and
    tiled QR through Context -> PTG -> dep engine -> one module per mesh
    position, numerically validated."""
    from parsec_tpu_torch.apps.potrf import potrf_taskpool
    from parsec_tpu_torch.apps.qr import qr_taskpool
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

    out = {}
    rng = np.random.default_rng(2)
    mb, nt = 32, 6
    n = mb * nt
    B = rng.standard_normal((n, n)).astype(np.float32)
    spd = (B @ B.T + n * np.eye(n)).astype(np.float32)
    A = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n,
                          name="Apo").from_array(spd.copy())
    with Context(nb_cores=4, device=device) as ctx:
        A.distribute_devices(ctx)
        ctx.add_taskpool(potrf_taskpool(A, device="cuda"))
        ctx.wait(timeout=300)
        ici = _stats(ctx)
        ndev = _ndev(ctx)
    L = np.tril(A.to_numpy())
    perr = float(np.abs(L @ L.T - spd).max() / np.abs(spd).max())
    assert perr < 1e-4, f"runtime potrf error {perr}"
    print(f"dryrun runtime graph: tiled potrf over {ndev} devices ok "
          f"(rel err {perr:.2e}); ici collectives: {ici}")
    out["potrf"] = {"rel_err": perr, "ici": ici}

    a = rng.standard_normal((n, n)).astype(np.float32)
    Q = TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n,
                          name="Aqr").from_array(a.copy())
    with Context(nb_cores=4, device=device) as ctx:
        Q.distribute_devices(ctx)
        ctx.add_taskpool(qr_taskpool(Q, device="cuda"))
        ctx.wait(timeout=300)
        ici = _stats(ctx)
        ndev = _ndev(ctx)
    res = Q.to_numpy()
    ata = a.T @ a
    R = np.triu(res)
    qerr = float(np.abs(R.T @ R - ata).max() / np.abs(ata).max())
    lower = float(np.abs(np.tril(res, -1)).max())
    assert lower < 1e-4, "R not triangular"
    assert qerr < 1e-4, f"runtime geqrf error {qerr}"
    print(f"dryrun runtime graph: tiled geqrf over {ndev} devices ok "
          f"(rel err {qerr:.2e}); ici collectives: {ici}")
    out["geqrf"] = {"rel_err": qerr, "ici": ici}
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else None)
