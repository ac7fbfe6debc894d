"""The port's ring pipeline and ring attention against the JAX package's.

Twins of tests/test_apps_ring.py (SURVEY §5.7 — ring schedules built from
dataflow edges; the data movement of ring attention / ring allreduce):
the same ring over the same seeded blocks on both packages, results and
executed tasks compared.  Ring attention is held against the JAX
package's ``device="cpu"`` (numpy bodies) and ``device="tpu"`` (XLA on
the CPU) runs and against the dense reference, at the JAX test's rtol
2e-4 and atol 2e-5, causal and not; the port runs its CPU bodies
(``device="cpu"``) and its device bodies on the CPU-backed device module
(``device="cuda"`` in a ``device="cpu"`` Context).  The 4-rank cases run
one ``run_distributed`` per package on the CPU (``ring_suite`` in
tests/torch_comm_workers.py).  ``test_ring_attention_multi_device_mesh``
runs the JAX package on its 8-device CPU mesh and the port on
``device="cpu:8"``, the blocks spread one per device and moved by the
ICI transport.
"""

import collections
import functools
import threading

import numpy as np
import pytest
import torch

import parsec_tpu.apps.ring as jax_ring
import parsec_tpu.apps.ring_attention as jax_attn
import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu_torch.apps.ring as port_ring
import parsec_tpu_torch.apps.ring_attention as port_attn
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix

import torch_comm_workers as W

PKGS = {"jax": (jax_context, jax_matrix, jax_ring, jax_attn, {}),
        "port": (port_context, port_matrix, port_ring, port_attn,
                 {"device": "cpu"})}

RTOL, ATOL = 2e-4, 2e-5
T_RUN = 240   # per distributed run, seconds


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(pkg, build, nb_cores=3):
    """Run ``build(matrix module)``'s pool; returns (the pool's
    collections' tiles, tasks done per class)."""
    ctx_mod, mat, ring, attn, kw = PKGS[pkg]
    tp, mats = build(mat, ring, attn)
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1

    with ctx_mod.Context(nb_cores=nb_cores, **kw) as ctx:
        ctx.pins_register("complete_exec", count)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
    tiles = {name: [_np(M.data_of(*mn).pull_to_host().payload).copy()
                    for mn in M.local_tiles()] for name, M in mats.items()}
    return tiles, dict(done)


def _vectors(mat, P, mb):
    V = mat.VectorTwoDimCyclic(mb=mb, lm=mb * P, name="V")
    A = mat.VectorTwoDimCyclic(mb=mb, lm=mb * P, name="A")
    for m, _ in V.local_tiles():
        V.data_of(m).copy_on(0).payload[:] = float(m + 1)
    for m, _ in A.local_tiles():
        A.data_of(m).copy_on(0).payload[:] = 0.0
    return V, A


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_ring_allreduce_single_rank(device):
    """Every party ends with the sum of every block (default combine)."""
    P, mb = 5, 4

    def build(mat, ring, _attn, dev):
        V, A = _vectors(mat, P, mb)
        kw = {} if dev is None else {"device": dev}
        return ring.ring_pipeline_taskpool(V, A, **kw), {"A": A}

    ref = _run("jax", functools.partial(build, dev=None))
    got = _run("port", functools.partial(build, dev=device))
    for r, g in zip(ref[0]["A"], got[0]["A"]):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(g, sum(range(1, P + 1)))
    assert got[1] == ref[1] == {"R": P * P}


def test_ring_custom_combine_order_invariant():
    """A max-combine ring (order-insensitive, like online softmax
    renormalization in ring attention)."""
    P, mb = 4, 2
    combines = {"jax": lambda acc, b: np.maximum(np.asarray(acc),
                                                 np.asarray(b)),
                "port": lambda acc, b: torch.maximum(acc, b)}
    got = {}
    for pkg in PKGS:
        def build(mat, ring, _attn, pkg=pkg):
            V, A = _vectors(mat, P, mb)
            return ring.ring_pipeline_taskpool(
                V, A, combine=combines[pkg],
                **({"device": "cpu"} if pkg == "port" else {})), {"A": A}
        got[pkg] = _run(pkg, build, nb_cores=2)
    assert got["port"][1] == got["jax"][1]
    for r, g in zip(got["jax"][0]["A"], got["port"][0]["A"]):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(g, float(P))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_ring_position_protocols(device):
    """A combine named ``(acc, blk, q, t)`` receives the party and round;
    one declaring ``vc`` gets the visit class, and needs
    ``visit_class=`` (both packages)."""
    P, mb = 4, 2
    seen = {}
    for pkg in PKGS:
        visits = []
        lock = threading.Lock()

        def combine(acc, blk, q, t, visits=visits, lock=lock):
            with lock:
                visits.append((q, t, float(blk[0])))
            return acc + blk

        def build(mat, ring, _attn, pkg=pkg, combine=combine):
            V, A = _vectors(mat, P, mb)
            kw = {"device": device} if pkg == "port" else {}
            return ring.ring_pipeline_taskpool(V, A, combine=combine,
                                               **kw), {"A": A}
        _run(pkg, build)
        seen[pkg] = sorted(visits)
        with pytest.raises(ValueError, match="visit_class"):
            V, A = _vectors(PKGS[pkg][1], P, mb)
            PKGS[pkg][2].ring_pipeline_taskpool(
                V, A, combine=lambda acc, blk, vc: acc)
    assert seen["port"] == seen["jax"]
    # round t at party q sees the block that started at (q - t) mod P
    assert seen["port"] == sorted((q, t, float((q - t) % P + 1))
                                  for q in range(P) for t in range(P))


def test_ring_refuses_the_jax_device_names():
    V, A = _vectors(port_matrix, 2, 2)
    for dev in ("tpu", "xla"):
        with pytest.raises(ValueError, match="XLA module"):
            port_ring.ring_pipeline_taskpool(V, A, device=dev)


def test_ring_across_4_ranks():
    """The ring's neighbor hops cross ranks: every edge is one
    interconnect message (the DCN case of the §5.7 story); the ring
    attention half is the causal case with one party per rank."""
    j, p = _suite()
    for rj, rp in zip(j, p):
        assert rp["ring"] == rj["ring"]
        assert rp["ring_done"] == rj["ring_done"]
        for vals in rp["ring"].values():
            np.testing.assert_allclose(vals, float(sum(range(1, 9))))
    assert sum(sum(r["ring_done"].values()) for r in p) == 8 * 8
    assert [r["termdet"] for r in p] == [r["termdet"] for r in j]


def test_ring_attention_across_4_ranks():
    j, p = _suite()
    Q, K, V = W.attn_operands(4, 4, 8, seed=13)
    want = _np(port_attn.dense_reference(Q, K, V, causal=True))
    for rj, rp in zip(j, p):
        assert rp["attn"].keys() == rj["attn"].keys()
        assert rp["attn_done"] == rj["attn_done"]
        for q, got in rp["attn"].items():
            np.testing.assert_allclose(got, rj["attn"][q], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(got, want[q * 4:(q + 1) * 4],
                                       rtol=RTOL, atol=ATOL)
    assert sum(sum(r["attn_done"].values()) for r in p) == 16


@functools.lru_cache(maxsize=None)
def _suite():
    return W.run_both(W.ring_suite, 4, timeout=T_RUN)


# -- ring attention (SURVEY §5.7 long-context flagship) ---------------------

def _attn_build(P, Tq, d, seed, device, causal):
    Q, K, V = W.attn_operands(P, Tq, d, seed)

    def build(mat, _ring, attn):
        KV = mat.TwoDimBlockCyclic(mb=2 * Tq, nb=d, lm=P * 2 * Tq, ln=d,
                                   name="KV")
        ACC = mat.TwoDimBlockCyclic(mb=Tq, nb=2 * d + 2, lm=P * Tq,
                                    ln=2 * d + 2, name="ACC")
        for q in range(P):
            rows = slice(q * Tq, (q + 1) * Tq)
            KV.data_of(q, 0).overwrite_host(attn.pack_kv(K[rows], V[rows]))
            ACC.data_of(q, 0).overwrite_host(attn.pack_query(Q[rows]))
        return (attn.ring_attention_taskpool(KV, ACC, device=device,
                                             causal=causal),
                {"ACC": ACC})
    return build, (Q, K, V)


def _outputs(tiles, d):
    return np.concatenate([_np(port_attn.unpack_output(a, d))
                           for a in tiles["ACC"]])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("jax_device", ["cpu", "tpu"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_ring_attention_matches_dense(device, jax_device, causal):
    """P-party ring attention over the runtime's neighbor-exchange
    schedule equals materialized-softmax attention over the full
    sequence — causal masking included — in both packages."""
    P, Tq, d = 4, 8, 16
    build_j, (Q, K, V) = _attn_build(P, Tq, d, 11, jax_device, causal)
    build_p, _ = _attn_build(P, Tq, d, 11, device, causal)
    ref_tiles, ref_done = _run("jax", build_j, nb_cores=4)
    got_tiles, got_done = _run("port", build_p, nb_cores=4)
    ref, got = _outputs(ref_tiles, d), _outputs(got_tiles, d)
    want = _np(jax_attn.dense_reference(Q, K, V, causal=causal))
    np.testing.assert_allclose(_np(port_attn.dense_reference(
        Q, K, V, causal=causal)), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert got_done == ref_done == {"R": P * P}


def _mesh_run(pkg, build):
    """``build``'s pool with KV and ACC spread one block per device over
    the package's 8-device mesh (the conftest's XLA devices; the port's
    cpu:8 modules); returns (tiles, tasks done per class, ICI counts)."""
    ctx_mod, _mat, ring, attn, _kw = PKGS[pkg]
    tp, mats = build(_mat, ring, attn)
    kw = {"device": "cpu:8"} if pkg == "port" else {}
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1

    with ctx_mod.Context(nb_cores=4, **kw) as ctx:
        assert ctx.ici is not None
        for M in mats.values():
            M.distribute_devices(ctx)
        ctx.pins_register("complete_exec", count)
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        stats = ctx.ici.stats.as_dict()
    tiles = {name: [_np(M.data_of(*mn).pull_to_host().payload).copy()
                    for mn in M.local_tiles()] for name, M in mats.items()}
    return tiles, dict(done), stats


def test_ring_attention_multi_device_mesh():
    """Ring attention over the device mesh: KV blocks hop the ICI preplace
    path between per-device resident accumulators (the JAX package's XLA
    devices; the port's cpu:8 modules), both against the dense reference
    and each other."""
    P, Tq, d = 4, 4, 8
    build_j, (Q, K, V) = _attn_build(P, Tq, d, 12, "tpu", False)
    build_p, _ = _attn_build(P, Tq, d, 12, "cuda", False)
    ref_tiles, ref_done, _ = _mesh_run("jax", build_j)
    got_tiles, got_done, stats = _mesh_run("port", build_p)
    ref, got = _outputs(ref_tiles, d), _outputs(got_tiles, d)
    want = _np(jax_attn.dense_reference(Q, K, V))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert got_done == ref_done == {"R": P * P}
    assert stats["puts"] + stats["permute_edges"] + stats["bcasts"] > 0


def test_causal_row_with_only_its_diagonal_block_unmasked():
    """Party 0's first query row attends to one key: every other visit
    is masked out (vc 0 skips, the diagonal mask zeroes the rest), and
    the -1e30 floor must leave no NaN — the output row is V's first
    row."""
    P, Tq, d = 4, 8, 16
    for device in ("cpu", "cuda"):
        build, (Q, K, V) = _attn_build(P, Tq, d, 5, device, True)
        tiles, _ = _run("port", build, nb_cores=4)
        out = _outputs(tiles, d)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out[0], V[0], rtol=RTOL, atol=ATOL)
        acc0 = _np(tiles["ACC"][0])
        assert acc0[0, 2 * d + 1] == pytest.approx(1.0)   # l = exp(0)


def test_causal_visit_classes():
    """The causal ring's visit classes at P = 8: 28 past, 8 diagonal, 28
    skipped — the same classes in both packages."""
    P = 8
    classes = {pkg: collections.Counter(
        mod._causal_visit_class(P)(q, t) for q in range(P)
        for t in range(P)) for pkg, mod in (("jax", jax_attn),
                                             ("port", port_attn))}
    assert classes["port"] == classes["jax"] == {2: 28, 1: 8, 0: 28}


def test_diagonal_mask_is_built_once_per_device():
    """A causal combine builds its diagonal mask on the first diagonal
    visit of a device and reuses it; past and skipped visits need
    none."""
    fn = port_attn._combine_torch_causal(8, 8)
    acc = port_attn.pack_query(torch.ones((8, 4)))
    blk = torch.ones((16, 4))
    fn(acc, blk, 0)
    fn(acc, blk, 2)
    assert fn.masks == {}
    fn(acc, blk, 1)
    (mask,) = fn.masks.values()
    fn(acc, blk, 1)
    assert len(fn.masks) == 1 and next(iter(fn.masks.values())) is mask
    np.testing.assert_array_equal(_np(mask), np.tril(np.ones((8, 8))))


@pytest.mark.parametrize("causal", [False, True])
def test_combine_matches_the_jax_package(causal):
    """One visit on the same packed operands: the port's torch combine
    against the JAX package's numpy one."""
    rng = np.random.default_rng(7)
    Tq, d = 8, 16
    acc = jax_attn.pack_query(rng.standard_normal((Tq, d)).astype(
        np.float32))
    acc[:, d:2 * d] = rng.standard_normal((Tq, d))
    acc[:, 2 * d] = rng.standard_normal(Tq)
    acc[:, 2 * d + 1] = rng.random(Tq) + 0.5
    blk = rng.standard_normal((2 * Tq, d)).astype(np.float32)
    if causal:
        ref = jax_attn._combine_np_causal(Tq, Tq)(acc, blk, 1)
        got = port_attn._combine_torch_causal(Tq, Tq)(
            torch.from_numpy(acc), torch.from_numpy(blk), 1)
    else:
        ref = jax_attn._combine_np(acc, blk)
        got = port_attn._combine_torch(torch.from_numpy(acc),
                                       torch.from_numpy(blk))
    np.testing.assert_allclose(_np(got), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(port_attn.pack_kv(blk[:Tq], blk[Tq:])),
                               jax_attn.pack_kv(blk[:Tq], blk[Tq:]))
