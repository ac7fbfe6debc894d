"""The port's ICI transport against the JAX package's.

Twins of tests/test_ici.py (the comm-engine module that moves payload
edges between the devices of one process: put, bcast, permute rounds,
and the runtime's prebroadcast / preplace / defer_place hooks).  Each
case runs on both packages with the same seeded numpy inputs: the JAX
package on the conftest's virtual 8-device CPU mesh, the port on
``device="cpu:8"`` (eight CPU-backed device modules), and compares what
both observe — the moved values, where they landed, the engine's
counts — at the reference's tolerances (GEMM 2e-3).  The engine's card
behaviour (each copy on the destination module's stream after the
source's) is covered by the ``cuda``-marked tests in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax

import parsec_tpu.apps.gemm as jax_gemm
import parsec_tpu.apps.wave as jax_wave
import parsec_tpu.core.context as jax_context
import parsec_tpu.data.data as jax_data
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg.api as jax_api
from parsec_tpu.utils.mca import params as jax_params
import parsec_tpu_torch.apps.gemm as port_gemm
import parsec_tpu_torch.apps.wave as port_wave
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.data as port_data
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg.api as port_api
from parsec_tpu_torch.utils.mca import params as port_params

PKGS = {
    "jax": dict(context=jax_context, data=jax_data, matrix=jax_matrix,
                api=jax_api, gemm=jax_gemm, wave=jax_wave,
                params=jax_params, kw={}, body="tpu"),
    "port": dict(context=port_context, data=port_data, matrix=port_matrix,
                 api=port_api, gemm=port_gemm, wave=port_wave,
                 params=port_params, kw={"device": "cpu:8"}, body="cuda"),
}
GEMM_TOL = 2e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _context(pkg):
    P = PKGS[pkg]
    return P["context"].Context(nb_cores=4, **P["kw"])


def _modules(ici):
    """The engine's devices in mesh order (the JAX package's XLA devices,
    the port's modules)."""
    return ici.xla_devices if hasattr(ici, "xla_devices") else ici.mesh()


def _place(pkg, ici, arr, pos):
    """``arr`` on the pos-th device of the mesh: a jax array there, or (the
    port) a private CPU tensor, which CPU-backed modules hold as is."""
    dev = _modules(ici)[pos]
    if pkg == "jax":
        return jax.device_put(arr, dev.jdev)
    return torch.tensor(arr)


def _put(pkg, ici, payload, src_pos, dst_pos):
    devs = _modules(ici)
    if pkg == "jax":
        return ici.put(payload, devs[dst_pos].space)
    return ici.put(payload, devs[dst_pos].space, devs[src_pos].space)


def _put_case(pkg):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    with _context(pkg) as ctx:
        ici = ctx.ici
        assert ici is not None and ici.ndev == 8
        src = _place(pkg, ici, a, 0)
        out = _put(pkg, ici, src, 0, 1)
        if pkg == "jax":
            assert list(out.devices())[0] == _modules(ici)[1].jdev
        else:
            # fresh storage, never an alias of the source (the CPU-backed
            # modules share the host, so where it landed is the copy's
            # space, checked by the preplace case)
            assert out.data_ptr() != src.data_ptr()
        return _np(out).copy(), ici.stats.as_dict()


def test_put_moves_tile_between_devices():
    got = {pkg: _put_case(pkg) for pkg in PKGS}
    a = np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32)
    for pkg, (out, stats) in got.items():
        np.testing.assert_array_equal(out, a)
        assert stats["puts"] == 1 and stats["put_bytes"] == a.nbytes
    assert got["jax"][1] == got["port"][1]


def _bcast_case(pkg):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 4)).astype(np.float32)
    with _context(pkg) as ctx:
        ici = ctx.ici
        targets = [d.space for d in _modules(ici)[1:4]]
        payload = a if pkg == "jax" else torch.tensor(a)
        out = ici.bcast(payload, targets)
        if pkg == "jax":
            for sp, arr in out.items():
                assert list(arr.devices())[0] == ici._jdev[sp]
        else:
            ptrs = {t.data_ptr() for t in out.values()}
            assert len(ptrs) == len(out) and payload.data_ptr() not in ptrs
        return (sorted(out) == sorted(targets),
                {sp: _np(arr).copy() for sp, arr in out.items()},
                ici.stats.as_dict())


def test_bcast_replicates_to_requested_devices():
    a = np.random.default_rng(1).standard_normal((4, 4)).astype(np.float32)
    got = {pkg: _bcast_case(pkg) for pkg in PKGS}
    for pkg, (same_targets, outs, stats) in got.items():
        assert same_targets, pkg
        for arr in outs.values():
            np.testing.assert_array_equal(arr, a)
        assert stats["bcasts"] == 1
    assert got["jax"][2] == got["port"][2]
    assert sorted(got["jax"][1]) == sorted(got["port"][1])


def _rotation_case(pkg):
    rng = np.random.default_rng(2)
    with _context(pkg) as ctx:
        ici = ctx.ici
        spaces = [d.space for d in _modules(ici)]
        n = len(spaces)
        tiles, edges = {}, []
        for i, sp in enumerate(spaces):
            t = rng.standard_normal((4, 4)).astype(np.float32)
            tiles[sp] = t
            edges.append((sp, spaces[(i + 1) % n],
                          _place(pkg, ici, t, i)))
        out = ici.permute(edges)
        res = {}
        for i, sp in enumerate(spaces):
            dst = spaces[(i + 1) % n]
            got = out[(sp, dst)]
            if pkg == "jax":
                assert list(got.devices())[0] == ici._jdev[dst]
            np.testing.assert_array_equal(_np(got), tiles[sp])
            res[(i, (i + 1) % n)] = _np(got).copy()
        return len(out), res, ici.stats.as_dict()


def test_permute_batches_edges_in_one_launch():
    """Full rotation: every device sends its tile to the next — a single
    permutation round, ONE permute."""
    got = {pkg: _rotation_case(pkg) for pkg in PKGS}
    for pkg, (n_out, _res, stats) in got.items():
        assert n_out == 8
        assert stats["permutes"] == 1 and stats["permute_edges"] == 8
    assert got["jax"][2] == got["port"][2]
    for k, v in got["jax"][1].items():
        np.testing.assert_array_equal(got["port"][1][k], v)


def _split_case(pkg):
    with _context(pkg) as ctx:
        ici = ctx.ici
        spaces = [d.space for d in _modules(ici)]
        a = np.ones((2, 2), np.float32)
        b = 2 * np.ones((2, 2), np.float32)
        pa, pb = (a, b) if pkg == "jax" else (torch.tensor(a),
                                              torch.tensor(b))
        # two edges from the SAME source: needs two rounds
        out = ici.permute([(spaces[0], spaces[1], pa),
                           (spaces[0], spaces[2], pb)])
        np.testing.assert_array_equal(_np(out[(spaces[0], spaces[1])]), a)
        np.testing.assert_array_equal(_np(out[(spaces[0], spaces[2])]), b)
        return ici.stats.as_dict()


def test_permute_splits_non_permutation_batches():
    got = {pkg: _split_case(pkg) for pkg in PKGS}
    assert got["jax"]["permutes"] == 2
    assert got["jax"] == got["port"]


def _gemm_case(pkg, a, b, mb, n):
    P = PKGS[pkg]
    mat = P["matrix"]
    A = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, name="A") \
        .from_array(a)
    B = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, name="B") \
        .from_array(b)
    C = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, name="C") \
        .from_array(np.zeros((n, n), np.float32))
    with _context(pkg) as ctx:
        assert ctx.ici is not None
        C.distribute_devices(ctx)
        ctx.add_taskpool(P["gemm"].gemm_taskpool(A, B, C, device=P["body"],
                                                 panel_bcast=True))
        ctx.wait(timeout=120)
        stats = ctx.ici.stats.as_dict()
    return _np(C.to_array()).astype(np.float32), stats


def test_multidevice_gemm_uses_collective_bcast():
    """Owner-computes GEMM over the device mesh: C tiles pinned
    block-cyclically across devices, A/B panels reaching >= 2 devices ride
    prebroadcast (one replication instead of N transfers).  Both packages
    fire the same broadcasts with the same bytes: the fan-outs are the
    DAG's (every A/B panel reader's consumers over the C tiles' devices),
    not a timing."""
    rng = np.random.default_rng(3)
    mb, nt = 16, 4
    n = mb * nt
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    got = {pkg: _gemm_case(pkg, a, b, mb, n) for pkg in PKGS}
    for pkg, (c, stats) in got.items():
        np.testing.assert_allclose(c, a @ b, rtol=GEMM_TOL, atol=GEMM_TOL)
        assert stats["bcasts"] > 0, f"{pkg}: no broadcasts fired: {stats}"
    np.testing.assert_allclose(got["port"][0], got["jax"][0],
                               rtol=GEMM_TOL, atol=GEMM_TOL)
    for k in ("bcasts", "bcast_bytes"):
        assert got["port"][1][k] == got["jax"][1][k], (k, got)


def _preplace_case(pkg):
    P = PKGS[pkg]
    Coherency = P["data"].Coherency
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    with _context(pkg) as ctx:
        ici = ctx.ici
        src, dst = _modules(ici)[0].space, _modules(ici)[1].space
        zeros = np.zeros((8, 8), np.float32) if pkg == "jax" \
            else torch.zeros((8, 8))
        datum = P["data"].new_data(zeros)
        dc = datum.overwrite_on(src, _place(pkg, ici, a, 0))
        first = ici.preplace(dc, dst)
        placed = datum.copy_on(dst)
        assert placed is not None and placed.coherency == Coherency.SHARED
        assert placed.version == dc.version
        value = _np(placed.payload).copy()
        # second call: already resident -> no-op
        again = ici.preplace(dc, dst)
        # host-resident copies are not preplaced
        host = P["data"].new_data(a.copy() if pkg == "jax"
                                  else torch.tensor(a))
        from_host = ici.preplace(host.copy_on(0), dst)
        return first, again, from_host, value, ici.stats.as_dict()


def test_preplace_single_consumer_edge():
    """A produced device-resident copy moves proactively onto the single
    consumer's device and attaches as a coherent SHARED copy (the CE-put
    analog of prebroadcast); host-resident or already-resident copies
    are left for the normal stage-in."""
    a = np.random.default_rng(3).standard_normal((8, 8)).astype(np.float32)
    got = {pkg: _preplace_case(pkg) for pkg in PKGS}
    for pkg, (first, again, from_host, value, _stats) in got.items():
        assert (first, again, from_host) == (True, False, False), pkg
        np.testing.assert_array_equal(value, a)
    assert got["jax"][4] == got["port"][4]


def _zig_case(pkg):
    P = PKGS[pkg]
    api = P["api"]
    with _context(pkg) as ctx:
        ndev = ctx.ici.ndev
        V = P["matrix"].VectorTwoDimCyclic(mb=8, lm=8 * ndev)
        for m, _ in V.local_tiles():
            V.data_of(m).copy_on(0).payload[:] = float(m)
        V.distribute_devices(ctx)   # tile k pinned to device k
        p = api.PTG("zig", NT=ndev)
        # S(k) runs on tile k's device and feeds S(k+1) on the NEXT
        # device: every edge crosses devices with exactly one consumer
        p.task("S", k=api.Range(0, ndev - 1)) \
            .affinity(lambda k, V=V: V(k)) \
            .flow("T", "RW",
                  api.IN(api.DATA(lambda k, V=V: V(k)),
                         when=lambda k: k == 0),
                  api.IN(api.TASK("S", "T", lambda k: dict(k=k - 1)),
                         when=lambda k: k > 0),
                  api.OUT(api.TASK("S", "T", lambda k: dict(k=k + 1)),
                          when=lambda k, ND=ndev: k < ND - 1),
                  api.OUT(api.DATA(lambda k, V=V: V(k)),
                          when=lambda k, ND=ndev: k == ND - 1)) \
            .body(lambda T: T + 1.0, device=P["body"]) \
            .body(lambda T: T + 1.0)
        before = ctx.ici.stats.puts + ctx.ici.stats.permute_edges
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=120)
        ctx.flush_ici()   # drain any edges still inside the window
        got = _np(V.data_of(ndev - 1).pull_to_host().payload).copy()
        after = ctx.ici.stats.puts + ctx.ici.stats.permute_edges
        return ndev, got, after - before


def test_runtime_stencil_uses_preplace():
    """A cross-device producer->consumer chain through the runtime fires
    the proactive put.  The count is timing-dependent on both packages
    (serialized chain edges flush singly or batched, depending on the
    window), so each must move something; the values must agree."""
    got = {pkg: _zig_case(pkg) for pkg in PKGS}
    for pkg, (ndev, val, moved) in got.items():
        np.testing.assert_allclose(val, float(ndev))
        assert moved > 0, f"{pkg}: no proactive d2d placement fired"
    np.testing.assert_array_equal(got["jax"][1], got["port"][1])


def _wave_case(pkg):
    P = PKGS[pkg]
    wave, prm = P["wave"], P["params"]
    with _context(pkg) as ctx:
        ndev = ctx.ici.ndev
        V = P["matrix"].VectorTwoDimCyclic(mb=8, lm=8 * ndev)
        W = P["matrix"].VectorTwoDimCyclic(mb=8, lm=8 * ndev)
        wave.fill_wave_inputs(V, W)
        V.distribute_devices(ctx)
        W.distribute_devices(ctx)
        # a huge batching window: only the full-round trigger may flush,
        # so the launch count is deterministic
        prm.set("comm_ici_permute_window_ms", 1000.0)
        try:
            s0 = ctx.ici.stats.as_dict()
            kw = {} if pkg == "jax" else {"device": "cuda"}
            ctx.add_taskpool(wave.permute_wave_taskpool(V, W, **kw))
            ctx.wait(timeout=120)
        finally:
            prm.unset("comm_ici_permute_window_ms")
        s1 = ctx.ici.stats.as_dict()
        vals = [_np(W.data_of(q).pull_to_host().payload).copy()
                for q in range(ndev)]
        return ndev, vals, {k: s1[k] - s0[k] for k in s1}


def test_wavefront_edges_ride_batched_permute():
    """k same-wavefront single-consumer cross-device edges ride <= 2
    launches: the wave's first edge opens the window with one immediate
    put, the remaining k-1 ride one permute round."""
    got = {pkg: _wave_case(pkg) for pkg in PKGS}
    for pkg, (ndev, vals, d) in got.items():
        assert d["permute_edges"] >= ndev - 2, (pkg, d)
        assert d["permutes"] + d["puts"] <= 2, (pkg, d)
        for q in range(ndev):
            np.testing.assert_allclose(
                vals[q], PKGS[pkg]["wave"].expected_wave_result(ndev, q))
    for a, b in zip(got["jax"][1], got["port"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "cpu:1"])
def test_one_module_has_no_engine(device):
    """One module: no engine, so a single-module path keeps its release
    path — the GEMM's tasks, their device incarnations and its result are
    those of the JAX package's one-device run, and no kernel launches on
    the CPU."""
    from parsec_tpu_torch.apps import cuda_kernels
    rng = np.random.default_rng(8)
    mb, nt = 8, 3
    n = mb * nt
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    mats = [port_matrix.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n,
                                          name=nm).from_array(x)
            for nm, x in (("A", a), ("B", b),
                          ("C", np.zeros((n, n), np.float32)))]
    launches0 = cuda_kernels.gemm_tile_launches.value
    with port_context.Context(nb_cores=2, device=device) as ctx:
        assert ctx.ici is None
        (dev,) = ctx.device_registry.accelerators
        ctx.add_taskpool(port_gemm.gemm_taskpool(*mats))
        ctx.wait(timeout=60)
        assert dev.stats.executed_tasks == nt ** 3
    assert cuda_kernels.gemm_tile_launches.value == launches0
    np.testing.assert_allclose(_np(mats[2].to_array()), a @ b,
                               rtol=GEMM_TOL, atol=GEMM_TOL)


@pytest.mark.parametrize("device,engine", [("cpu", False), ("cpu:2", True)])
def test_native_core_hands_engine_pools_to_python(device, engine):
    """With an engine attached, the native core hands a pool's data-flow
    completions back to Python (its "pool" bailout: the engine's hook
    rides release_deps there), as the JAX package's C chain does; on one
    module the extended chain keeps them."""
    from parsec_tpu_torch.native import load_schedext
    se = load_schedext()
    NB = 6
    A = port_matrix.TwoDimBlockCyclic(1, 1, 1, 1, name="A").from_array(
        torch.zeros(1, 1))
    g = port_api.PTG("chain", NB=NB)
    g.task("S", k=port_api.Range(0, NB - 1)) \
        .affinity(lambda k: A(0, 0)) \
        .flow("T", "RW",
              port_api.IN(port_api.DATA(lambda k: A(0, 0)),
                          when=lambda k: k == 0),
              port_api.IN(port_api.TASK("S", "T", lambda k: dict(k=k - 1)),
                          when=lambda k: k > 0),
              port_api.OUT(port_api.TASK("S", "T",
                                         lambda k: dict(k=k + 1)),
                           when=lambda k, NB=NB: k < NB - 1)) \
        .body(lambda T: T.add_(1.0))
    before = dict(se.bailout_stats())
    with port_context.Context(nb_cores=2, device=device) as ctx:
        assert ctx.scheduler.name == "native"
        assert (ctx.ici is not None) == engine
        ctx.add_taskpool(g.build())
        ctx.wait(timeout=60)
    pool = se.bailout_stats()["pool"] - before.get("pool", 0)
    assert float(A.to_array()[0, 0]) == NB
    assert (pool > 0) == engine, pool


def _gated_zig_pool(api, V, ndev, gate, name="A"):
    """The zig chain of ``_zig_case``, its last task also waiting on a
    host task G that runs ``gate`` first: the last edge's consumer cannot
    stage its tile in before ``gate`` returns."""
    last = ndev - 1
    p = api.PTG(name, NT=ndev)
    p.task("G") \
        .flow("x", "CTL",
              api.OUT(api.TASK("S", "g", lambda L=last: dict(k=L)))) \
        .body(lambda: gate())
    p.task("S", k=api.Range(0, last)) \
        .affinity(lambda k, V=V: V(k)) \
        .flow("T", "RW",
              api.IN(api.DATA(lambda k, V=V: V(k)),
                     when=lambda k: k == 0),
              api.IN(api.TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              api.OUT(api.TASK("S", "T", lambda k: dict(k=k + 1)),
                      when=lambda k, L=last: k < L),
              api.OUT(api.DATA(lambda k, V=V: V(k)),
                      when=lambda k, L=last: k == L)) \
        .flow("g", "CTL",
              api.IN(api.TASK("G", "x", lambda k: dict()),
                     when=lambda k, L=last: k == L)) \
        .body(lambda T: T + 1.0, device="cuda") \
        .body(lambda T: T + 1.0)
    return p.build()


@pytest.mark.parametrize("device", ["cpu:2", "cpu:3"])
def test_failed_placement_fails_only_its_own_pool(device, monkeypatch):
    """A placement that raises fails the pool whose tile it was moving,
    and no other.  Pool A's zig chain crosses every module; the copy of
    its last edge raises.  On two modules that edge is placed at once
    from its producer's release (a lone edge after a quiet spell); on
    three, with a long batching window, it waits in the window and an
    idle worker's flush (``Context.flush_ici``) raises it; its consumer is
    held until then, so it cannot stage the tile in first and void the
    edge.  Pool B — a host chain running at the same time, its first
    task held until A's failure has been routed — must finish with its
    values, and the context's wait must not raise.  Both pools carry an
    error sink, as every JobService job does."""
    import threading
    from parsec_tpu_torch.comm.ici import IciEngine
    ndev = int(device.split(":")[1])
    bad = 1000.0 + ndev - 1        # what S(ndev-2) hands its consumer
    orig = IciEngine._copy

    def failing_copy(self, payload, src_space, dst_space):
        if float(torch.as_tensor(payload).max()) == bad:
            raise RuntimeError("injected placement failure")
        return orig(self, payload, src_space, dst_space)

    monkeypatch.setattr(IciEngine, "_copy", failing_copy)
    routed = threading.Event()
    errors = {"A": [], "B": []}
    port_params.set("comm_ici_permute_window_ms", 1000.0)
    try:
        with port_context.Context(nb_cores=4, device=device) as ctx:
            assert ctx.ici.ndev == ndev
            VA = port_matrix.VectorTwoDimCyclic(mb=4, lm=4 * ndev)
            VB = port_matrix.VectorTwoDimCyclic(mb=4, lm=4 * 2)
            VA.data_of(0).copy_on(0).payload[:] = 1000.0
            VA.distribute_devices(ctx)
            a = _gated_zig_pool(port_api, VA, ndev,
                                lambda: routed.wait(30))
            g = port_api.PTG("B", NT=2)
            g.task("S", k=port_api.Range(0, 1)) \
                .affinity(lambda k: VB(k)) \
                .flow("T", "RW",
                      port_api.IN(port_api.DATA(lambda k: VB(k)),
                                  when=lambda k: k == 0),
                      port_api.IN(port_api.TASK("S", "T",
                                                lambda k: dict(k=k - 1)),
                                  when=lambda k: k > 0),
                      port_api.OUT(port_api.TASK("S", "T",
                                                 lambda k: dict(k=k + 1)),
                                   when=lambda k: k < 1),
                      port_api.OUT(port_api.DATA(lambda k: VB(k)),
                                   when=lambda k: k == 1)) \
                .body(lambda T, k: (routed.wait(30) if k == 0 else None,
                                    T + 1.0)[1])
            b = g.build()
            for name, tp in (("A", a), ("B", b)):
                tp.error_sink = lambda exc, task, name=name, tp=tp: (
                    errors[name].append(exc), routed.set(), tp.cancel())
            ctx.add_taskpool(a)
            ctx.add_taskpool(b)
            ctx.wait(timeout=60)
            got_b = _np(VB.data_of(1).pull_to_host().payload).copy()
    finally:
        port_params.unset("comm_ici_permute_window_ms")
    assert routed.is_set(), "the injected placement failure never fired"
    assert [str(e) for e in errors["A"]] == ["injected placement failure"]
    assert errors["B"] == []
    np.testing.assert_array_equal(got_b, np.full(4, 2.0, np.float32))


def test_failed_placement_in_a_shared_batch_fails_only_its_pool(monkeypatch):
    """The deferred window is one per engine, so a batch carries edges of
    several pools.  On three modules, pool A's edge (module 1 to 2, its
    copy raises) and pool B's (module 0 to 1) are both deferred — the
    window is held open from before either edge — and the second one
    flushes both as one batch; both consumers are held until A's failure
    has been routed, so neither edge is voided by a stage-in.  The batch
    is retried edge by edge: B's tile is placed and B finishes with its
    values, A alone fails, and the context's wait does not raise."""
    import threading
    import time
    from parsec_tpu_torch.comm.ici import IciEngine
    orig_copy, orig_flush = IciEngine._copy, IciEngine._flush_batch
    batches = []

    def failing_copy(self, payload, src_space, dst_space):
        if float(torch.as_tensor(payload).max()) == 1001.0:
            raise RuntimeError("injected placement failure")
        return orig_copy(self, payload, src_space, dst_space)

    def recording_flush(self, edges):
        batches.append({e[4].name for e in edges})
        return orig_flush(self, edges)

    monkeypatch.setattr(IciEngine, "_copy", failing_copy)
    monkeypatch.setattr(IciEngine, "_flush_batch", recording_flush)
    routed = threading.Event()
    errors = {"A": [], "B": []}
    port_params.set("comm_ici_permute_window_ms", 5000.0)
    try:
        with port_context.Context(nb_cores=4, device="cpu:3") as ctx:
            sp = ctx.accelerator_spaces()
            assert len(sp) == 3
            VA = port_matrix.VectorTwoDimCyclic(mb=4, lm=8)
            VB = port_matrix.VectorTwoDimCyclic(mb=4, lm=8)
            VA.data_of(0).copy_on(0).payload[:] = 1000.0
            VB.data_of(0).copy_on(0).payload[:] = 1.0
            for V, (s0, s1) in ((VA, (sp[1], sp[2])), (VB, (sp[0], sp[1]))):
                V.data_of(0).preferred_device = s0
                V.data_of(1).preferred_device = s1
            pools = {name: _gated_zig_pool(port_api, V, 2,
                                           lambda: routed.wait(30), name)
                     for name, V in (("A", VA), ("B", VB))}
            for name, tp in pools.items():
                tp.error_sink = lambda exc, task, name=name, tp=tp: (
                    errors[name].append(exc), routed.set(), tp.cancel())
            ctx.ici._last_edge = time.monotonic()   # the window is open
            for tp in pools.values():
                ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
            got_b = _np(VB.data_of(1).pull_to_host().payload).copy()
    finally:
        port_params.unset("comm_ici_permute_window_ms")
    assert {"A", "B"} in batches, batches
    assert [str(e) for e in errors["A"]] == ["injected placement failure"]
    assert errors["B"] == []
    np.testing.assert_array_equal(got_b, np.full(4, 3.0, np.float32))
