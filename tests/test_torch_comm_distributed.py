"""The port's distributed runtime against the JAX package's, on the CPU.

Twins of tests/test_comm_distributed.py: each case runs the same rank
function (tests/torch_comm_workers.py) on seeded inputs under both
packages' launchers — the port's children on ``device="cpu"`` — and
holds the port's results, task counts, protocol counters and Safra
balances against the JAX package's.  Past the twins: the 2-rank potrf,
GEMM and QR with the device module (bf16 tiles over the wire) against
the single-rank port, the send snapshot against an in-place successor,
and the launcher's device contract.  Every multi-process case bounds
itself with the launcher's ``timeout``.
"""

import multiprocessing as mp
import os
import pickle
import socket
import time

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import numpy as np
import pytest
import torch

import torch_comm_workers as W
from parsec_tpu_torch.comm.launch import (_card_of, _probe_port_base,
                                          run_distributed)

T_RUN = 180   # per distributed run, seconds


def _same_counts(j, p):
    """Per-rank task counts, protocol counters and Safra balances agree."""
    for rj, rp in zip(j, p):
        for key in ("done", "proto", "termdet"):
            if key in rj:
                assert rj[key] == rp[key], (key, rj[key], rp[key])


def _tiles(results):
    return W.merged(results, "tiles")


# -- comm engine direct -------------------------------------------------------

def test_ce_am_ring():
    j, p = W.run_both(W.ce_echo, 3, timeout=T_RUN)
    assert p == j
    assert all(r["transport"] == "evloop" for r in p)


def test_ce_onesided_put_get():
    j, p = W.run_both(W.ce_onesided, 3, timeout=T_RUN)
    for rank, (rj, rp) in enumerate(zip(j, p)):
        assert rp["after_put"] == [10.0 + (rank - 1) % 3] * 8
        assert rp["after_put"] == rj["after_put"]
        assert rp["got"] == rj["got"]
        assert rp["got_type"] == "torch" and rj["got_type"] == "numpy"


# -- PTG dataflow across ranks ------------------------------------------------

def test_ptg_chain_across_ranks():
    j, p = W.run_both(W.chain, 2, timeout=T_RUN)
    assert W.merged(p) == W.merged(j) == {k: float(k + 1) for k in range(8)}
    _same_counts(j, p)


@pytest.mark.parametrize("topo", ["star", "chain", "binomial"])
def test_broadcast_topologies(topo):
    j, p = W.run_both(W.bcast, 3, args=(topo,), timeout=T_RUN)
    assert W.merged(p) == W.merged(j) == {i: 42.0 for i in range(6)}
    _same_counts(j, p)


def test_rendezvous_get_path():
    """eager=16 bytes: every hop's 1 KiB tile rides the GET_REQ/GET_REP
    rendezvous."""
    j, p = W.run_both(W.chain, 2, args=(4, 256, 16), timeout=T_RUN)
    assert W.merged(p) == W.merged(j) == {k: float(k + 1) for k in range(4)}
    _same_counts(j, p)
    assert sum(r["proto"]["act_rdv"] for r in p) == 3
    assert sum(r["proto"]["act_eager"] for r in p) == 0


def test_distributed_gemm_4ranks():
    j, p = W.run_both(W.dist_gemm, 4, timeout=T_RUN)
    tj, tp = _tiles(j), _tiles(p)
    assert len(tp) == 16 and tp.keys() == tj.keys()
    mb = 8
    want = W.full_matrix("C", 4, 4, mb) + \
        W.full_matrix("A", 4, 4, mb) @ W.full_matrix("B", 4, 4, mb)
    for key, got in tp.items():
        m, n = map(int, key.split(","))
        np.testing.assert_allclose(
            got, want[m * mb:(m + 1) * mb, n * mb:(n + 1) * mb],
            rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got, tj[key], rtol=1e-5, atol=1e-5)
    _same_counts(j, p)


def test_funnelled_many_small_messages():
    """240 one-hop edges round-robin over 3 ranks (the JAX package's
    case drives it through DTD, which the port does not carry), then a
    memcpy_shift onto the comm loop."""
    j, p = W.run_both(W.small_msgs, 3, timeout=T_RUN)
    last = [r["last"] for r in p if r["last"] is not None]
    assert last == [240.0]
    assert [r["last"] for r in j] == [r["last"] for r in p]
    _same_counts(j, p)


def test_remote_presend_reshape():
    """A bf16 edge dtt on a remote edge: the converted payload travels
    (bf16 on the wire as raw 16-bit words in the port) and the consumer
    sees bf16."""
    j, p = W.run_both(W.remote_presend_reshape, 2, timeout=T_RUN)
    expect = {m: [2.0 * float(np.float32(
        torch.tensor(1.5 + (m - 1) % 4).bfloat16().float()))] * 8
        for m in range(4)}
    assert W.merged(p) == W.merged(j) == expect
    for r in p:
        assert set(r["seen"].values()) <= {"bfloat16"}
    assert W.merged(j, "seen") == W.merged(p, "seen")


def test_a_taken_rank_port_relaunches_the_gang(monkeypatch):
    """Rank 1's port is taken (a listener of another process) between the
    launcher's probe and the rank's bind: the rank reports EADDRINUSE
    before anything ran, and the gang is relaunched on a fresh base."""
    import parsec_tpu_torch.comm.launch as launch
    bases = []
    base = _probe_port_base(2)

    def probe(nranks):
        bases.append(base if not bases else _probe_port_base(nranks))
        return bases[-1]
    monkeypatch.setattr(launch, "_probe_port_base", probe)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as taken:
        taken.bind(("127.0.0.1", base + 1))
        taken.listen(1)
        res = W.run_port(W.ce_echo, 2, timeout=T_RUN)
    assert len(bases) == 2 and bases[0] == base
    assert [r["transport"] for r in res] == ["evloop"] * 2


def test_a_taken_port_of_a_pinned_base_fails_the_launch():
    base = _probe_port_base(2)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as taken:
        taken.bind(("127.0.0.1", base + 1))
        taken.listen(1)
        with pytest.raises(RuntimeError, match="EADDRINUSE"):
            W.run_port(W.ce_echo, 2, timeout=T_RUN, port_base=base)


def test_chain_8_ranks():
    j, p = W.run_both(W.chain, 8, args=(24,), timeout=300)
    assert W.merged(p) == W.merged(j) == \
        {k: float(k + 1) for k in range(24)}
    _same_counts(j, p)


@pytest.mark.slow
def test_chain_16_ranks():
    """16 ranks of one core each: the address book, handshakes and the
    chain at 2x the 8-rank scale (32 processes with both packages)."""
    j, p = W.run_both(W.chain, 16, args=(48,), timeout=420, nb_cores=1)
    assert W.merged(p) == W.merged(j) == \
        {k: float(k + 1) for k in range(48)}


def test_distributed_qr_4ranks():
    """The routed RSTORE/CSTORE classes carry R home; |R| matches the
    true QR's (signs are convention-dependent) and the JAX package's."""
    j, p = W.run_both(W.dist_qr, 4, timeout=T_RUN)
    tj, tp = _tiles(j), _tiles(p)
    nt, mb = 4, 8
    want = np.abs(np.linalg.qr(W.full_matrix("Q", nt, nt, mb), mode="r"))
    for key, got in tp.items():
        m, n = map(int, key.split(","))
        blk = np.s_[m * mb:(m + 1) * mb, n * mb:(n + 1) * mb]
        if m > n:
            np.testing.assert_allclose(got, 0.0, atol=1e-3)
        else:
            g = np.triu(got) if m == n else got
            np.testing.assert_allclose(np.abs(g), want[blk],
                                       rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got, tj[key], rtol=1e-4, atol=1e-4)
    assert len(tp) == 16
    _same_counts(j, p)
    done = {}
    for r in p:
        for c, v in r["done"].items():
            done[c] = done.get(c, 0) + v
    assert done["RSTORE"] == nt - 1
    assert done["CSTORE"] == (nt - 1) * nt // 2


def test_remote_consumer_side_reshape():
    j, p = W.run_both(W.remote_consumer_reshape, 2, timeout=T_RUN)
    assert p[1] == j[1] == {"dtype": "bfloat16", "val": 3.0}


def test_remote_no_re_reshape():
    j, p = W.run_both(W.remote_no_re_reshape, 2, timeout=T_RUN)
    assert p[1] == j[1]
    assert p[1]["seen"] == {"dtype": "bfloat16", "val": 5.0}
    assert p[1]["conv"] == 0


def test_remote_new_flow_reshape():
    j, p = W.run_both(W.remote_new_flow_reshape, 2, timeout=T_RUN)
    assert p[1] == j[1] == {"dtype": "bfloat16",
                            "vals": [1.0, 2.0, 3.0, 4.0]}


def test_remote_multiple_outs_same_pred_flow():
    j, p = W.run_both(W.remote_multi_outs, 2, timeout=T_RUN)
    assert p[1] == j[1] == {"b_dtype": "bfloat16", "b_val": 6.0,
                            "h_dtype": "float32", "h_val": 3.0}


def test_remote_multiple_outs_same_pred_flow_multiple_deps():
    j, p = W.run_both(W.remote_multi_outs, 2, args=(True,), timeout=T_RUN)
    assert p[1] == j[1] == {"b_dtype": "bfloat16", "b_val": 8.0,
                            "r0": 9.0, "r1": 9.0}


def test_dynamic_pool_across_ranks_drains_globally():
    """Tasks discovered at run time hop between ranks: each rank's
    dynamic pool holds its runtime action until the pool-scoped Safra
    round proves global drain (a rank that ran nothing yet must not
    terminate early)."""
    j, p = W.run_both(W.dynamic_chain, 2, timeout=T_RUN)
    assert W.merged(p) == W.merged(j) == {k: float(k + 1) for k in range(9)}
    _same_counts(j, p)


def test_user_trigger_propagates_across_ranks():
    """Zero counters fire nothing on the user-trigger termdet; rank 0's
    trigger completes the pool on every rank."""
    j, p = W.run_both(W.user_trigger, 3, timeout=T_RUN)
    for res in (j, p):
        assert all(r["alive_before_trigger"] and r["completed"]
                   for r in res), res
    assert W.merged(p) == W.merged(j) == {k: float(k + 1) for k in range(9)}


def test_multihost_address_book(monkeypatch):
    monkeypatch.setenv("PARSEC_COMM_HOSTS", "127.0.0.1,127.0.0.1,127.0.0.1")
    assert W.run_port(W.hosts_chain, 3, timeout=T_RUN) == ["ok"] * 3
    monkeypatch.setenv("PARSEC_COMM_HOSTS", "a,b")
    from parsec_tpu_torch.comm.engine import SocketCE
    with pytest.raises(ValueError, match="2 hosts for 3"):
        SocketCE(0, 3, port_base=_probe_port_base(1))


# -- failure detection ---------------------------------------------------------

def _survivor_proc(rank, nranks, port_base, outq):
    """Standalone 2-rank harness (run_distributed's epilogue barrier
    would entangle the failure being injected)."""
    from parsec_tpu_torch.comm.engine import SocketCE
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.core.context import Context
    ce = SocketCE(rank, nranks, port_base)
    ctx = Context(nb_cores=1, rank=rank, nranks=nranks, device="cpu")
    RemoteDepEngine(ce, ctx)
    ce.barrier()
    if rank == 1:
        os._exit(17)              # crash without goodbye
    t0 = time.monotonic()
    deadline = t0 + 60
    while not ctx._errors:
        if time.monotonic() > deadline:
            outq.put(("timeout", None, -1.0))
            return
        time.sleep(0.02)
    kind = type(ctx._errors[0][0]).__name__
    try:
        ce.barrier(timeout=60)
        bar = "no-error"
    except ConnectionError:
        bar = "connection-error"
    except TimeoutError:
        bar = "timeout"
    outq.put((kind, bar, time.monotonic() - t0))


def test_peer_death_detection():
    mpctx = mp.get_context("spawn")
    outq = mpctx.Queue()
    base = _probe_port_base(2)
    procs = [mpctx.Process(target=_survivor_proc, args=(r, 2, base, outq),
                           daemon=True) for r in range(2)]
    for pr in procs:
        pr.start()
    kind, bar, dt = outq.get(timeout=120)
    for pr in procs:
        pr.join(timeout=10)
        if pr.is_alive():
            pr.terminate()
    assert kind == "PeerFailedError", kind
    assert bar == "connection-error", bar
    assert dt < 45, f"loss surfaced too slowly ({dt:.1f}s)"


def _wire_guard_victim(outq, port_base):
    from parsec_tpu_torch.comm.engine import (SocketCE, TAG_USER,
                                              _HANDSHAKE, _LEN, _WIRE_MAGIC,
                                              _WIRE_VERSION)
    from parsec_tpu_torch.utils.mca import params
    params.set("comm_max_frame_mb", 1)
    errors, got = [], []
    ce = SocketCE(0, 4, port_base=port_base)
    ce.on_error = errors.append
    ce.tag_register(TAG_USER, lambda src, p: got.append((src, p)))

    def dial(rank, version=_WIRE_VERSION):
        s = socket.create_connection(("127.0.0.1", port_base), timeout=10)
        s.sendall(_HANDSHAKE.pack(_WIRE_MAGIC, version, rank))
        return s

    def frame(obj):
        body = pickle.dumps(obj)
        return _LEN.pack(TAG_USER, len(body), 0) + body

    def wait_for(pred):
        deadline = time.monotonic() + 10
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.05)

    bad = dial(1, version=99)
    time.sleep(0.3)
    rejected = 1 not in ce._peers
    good = dial(1)
    good.sendall(frame("hello"))
    evil = dial(2)
    evil.sendall(_LEN.pack(TAG_USER, 1 << 40, 0))
    time.sleep(0.5)
    good.sendall(frame("again"))
    wait_for(lambda: len(got) >= 2)
    first = {"rejected": rejected, "got": list(got),
             "dead": sorted(ce.dead_peers),
             "errors": [type(e).__name__ for e in errors]}
    evil2 = dial(3)
    garbage = b"\x00\xde\xad\xbe\xef not a pickle"
    evil2.sendall(_LEN.pack(TAG_USER, len(garbage), 0) + garbage)
    good.sendall(frame("still-here"))
    wait_for(lambda: len(got) >= 3 and 3 in ce.dead_peers)
    outq.put((first, {"got": list(got), "dead": sorted(ce.dead_peers)}))
    for s in (bad, good, evil, evil2):
        s.close()
    ce.fini()


def test_wire_format_guard():
    """A cross-version peer fails its handshake; an oversized length and
    an unpicklable frame each sever only their sender."""
    mpctx = mp.get_context("spawn")
    outq = mpctx.Queue()
    pr = mpctx.Process(target=_wire_guard_victim,
                       args=(outq, _probe_port_base(1)), daemon=True)
    pr.start()
    res, res2 = outq.get(timeout=120)
    pr.join(timeout=15)
    if pr.is_alive():
        pr.terminate()
    assert res["rejected"]
    assert 2 in res["dead"] and "PeerFailedError" in res["errors"], res
    assert [m for _s, m in res["got"]] == ["hello", "again"], res
    assert 3 in res2["dead"], res2
    assert [m for _s, m in res2["got"]][-1] == "still-here", res2


# -- the port's paths across ranks: device module, bf16 on the wire ----------

def _port_single(fn, **kw):
    """The same rank function on one rank, in this process (no comm
    engine: its counter readers are stubbed by the caller)."""
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=2, device="cpu") as ctx:
        return fn(ctx, 0, 1, "port", **kw)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_two_rank_potrf_matches_the_single_rank_port(kind, monkeypatch):
    """P=2 potrf on the device module (CPU-backed): every lower L tile
    matches the single-rank port's, the per-class task counts sum to the
    single-rank run's, the Cholesky flag is clear, and the received
    tiles were staged in by the device module."""
    nt, mb = 4, 16
    p = W.run_port(W.dist_potrf, 2, args=(nt, mb, 2, kind), timeout=T_RUN)
    j = W.run_jax(W.dist_potrf, 2, args=(nt, mb, 2, kind), timeout=T_RUN)
    monkeypatch.setattr(W, "proto", lambda ctx: {})
    monkeypatch.setattr(W, "termdet", lambda ctx: {})
    solo = _port_single(W.dist_potrf, nt=nt, mb=mb, P=1, kind=kind)
    tol = 1e-5 if kind == "f32" else 1e-2
    tp = _tiles(p)
    assert tp.keys() == solo["tiles"].keys()
    for key, ref in solo["tiles"].items():
        m, n = map(int, key.split(","))
        g, r = (np.tril(x) if m == n else x for x in (tp[key], ref))
        assert np.abs(g - r).max() <= tol * max(1.0, np.abs(r).max()), key
    done = {}
    for r in p:
        assert not r["failed"]
        assert r["staged_in"] > 0
        for c, v in r["done"].items():
            done[c] = done.get(c, 0) + v
    assert done == solo["done"]
    _same_counts(j, p)
    acts = sum(r["proto"]["act_eager"] + r["proto"]["act_rdv"] for r in p)
    assert acts > 0


def test_two_rank_gemm_bf16_tiles_over_the_wire():
    """bf16 A and B panels cross ranks (RA/RB broadcasts) into device
    GEMMs; C matches the single-rank port bit for bit and the JAX
    package's within f32 rounding."""
    args = (4, 16, 2, "bf16", "device")
    j, p = W.run_both(W.dist_gemm, 2, args=args, timeout=T_RUN)
    tp, tj = _tiles(p), _tiles(j)
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.apps.gemm import gemm_taskpool
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    mt, mb = 4, 16
    mats = {}
    for name, dt in (("A", torch.bfloat16), ("B", torch.bfloat16),
                     ("C", torch.float32)):
        mats[name] = TwoDimBlockCyclic(mb, mb, mt * mb, mt * mb, dtype=dt,
                                       name=name).from_array(
            W.full_matrix(name, mt, mt, mb))
    with Context(nb_cores=2, device="cpu") as ctx:
        ctx.add_taskpool(gemm_taskpool(mats["A"], mats["B"], mats["C"],
                                       device="cuda", panel_bcast=True))
        ctx.wait(timeout=120)
    solo = mats["C"].to_numpy()
    for key, got in tp.items():
        m, n = map(int, key.split(","))
        np.testing.assert_array_equal(
            got, solo[m * mb:(m + 1) * mb, n * mb:(n + 1) * mb])
        np.testing.assert_allclose(got, tj[key], rtol=1e-5, atol=1e-4)
    _same_counts(j, p)
    # each rank's RB panels crossed as bf16: 2 bytes an element
    rdv_eager = sum(r["proto"]["eager_bytes"] + r["proto"]["rdv_bytes"]
                    for r in p)
    assert rdv_eager == sum(r["proto"]["eager_bytes"] +
                            r["proto"]["rdv_bytes"] for r in j)


def _snapshot_worker(ctx, rank, nranks, pkg):
    """P (rank 0, device body) writes X = 1 and hands it to R (rank 1).
    The comm loop of rank 0 is held until P's release has returned, and
    right then P's output storage is written in place — what a donated
    successor's launch would do — so the activation frame is serialized
    only after that write.  R must see P's bytes: the payload was
    snapshotted inside release_deps."""
    import threading
    api = W._mod(pkg, "dsl.ptg.api")
    V = W._vec(pkg, nranks, rank, 64, 64 * nranks)
    if rank == 0:
        W.put(V.data_of(0).copy_on(0).payload, np.zeros(64, np.float32))
    seen, wrote = {}, {}
    if rank == 0:
        rde = ctx.comm
        gate = threading.Event()
        rde.ce.post(gate.wait, 30)       # frames wait behind this
        flush = rde.flush_activations

        def flush_then_write(es, task):
            flush(es, task)
            if task.task_class.name == "P":
                task.data["X"].payload.add_(1000.0)
                wrote["after_flush"] = True
                gate.set()
        rde.flush_activations = flush_then_write
    p = api.PTG("snap")
    p.task("P").affinity(lambda V=V: V(0)) \
        .flow("X", "RW", api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.TASK("R", "X", lambda: dict()))) \
        .body(lambda X: X + 1.0, device="cuda")
    p.task("R").affinity(lambda V=V: V(1)) \
        .flow("X", "READ", api.IN(api.TASK("P", "X", lambda: dict()))) \
        .body(lambda X: seen.update(val=float(W.get(X)[0])))
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=60)
    return {"seen": seen.get("val"), "wrote": wrote.get("after_flush")}


def test_send_snapshot_precedes_an_in_place_write():
    res = run_distributed(_snapshot_worker, 2, args=("port",),
                          device="cpu", timeout=T_RUN)
    assert res[0]["wrote"], res          # the in-place write happened
    assert res[1]["seen"] == 1.0, res    # the snapshot, not 1001


# -- the launcher's device contract ------------------------------------------

def _device_of(ctx, rank, nranks):
    return [str(d.tdev) for d in ctx.device_registry.accelerators]


def test_children_run_on_the_device_they_are_given():
    assert run_distributed(_device_of, 2, device="cpu",
                           timeout=T_RUN) == [["cpu"], ["cpu"]]


def test_a_child_asked_for_the_card_without_cuda_raises(monkeypatch):
    """No CUDA here: a child asked for the card fails, and the run with
    it (nothing carries on on the CPU)."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        run_distributed(_device_of, 2, device="cuda", timeout=T_RUN)


def test_ranks_map_onto_the_visible_cards():
    assert [_card_of(r, ["0"]) for r in range(3)] == [None] * 3
    assert [_card_of(r, ["2", "3"]) for r in range(4)] == \
        ["2", "3", "2", "3"]
    with pytest.raises(ValueError, match="device must be"):
        run_distributed(_device_of, 2, device="tpu")
