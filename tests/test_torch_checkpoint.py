"""The port's checkpoint/restore (utils/checkpoint.py) against the JAX
package's, on the CPU.

Twins of tests/test_checkpoint.py, each run once per package (``pkg``)
on the same seeds: a round trip in the middle of a computation, tiles
resident on the device module flushed home before the snapshot (the
port on ``device="cpu:1"``, the CPU-backed module that runs the card's
pipeline), a layout mismatch refused, and the collective checkpoint of a
3-rank run.  Past the twins: a bf16 collection round-trips bit for bit
(numpy has no bf16; the port's shard stores its raw words).
"""

import importlib

import numpy as np
import pytest
import torch

PKGS = ["jax", "port"]


def M(pkg, name):
    return importlib.import_module(
        ("parsec_tpu." if pkg == "jax" else "parsec_tpu_torch.") + name)


def _ctx(pkg, device="cpu", **kw):
    Context = M(pkg, "core.context").Context
    return Context(**kw) if pkg == "jax" else Context(device=device, **kw)


def _host(pkg, a):
    a = np.asarray(a, np.float32)
    return a if pkg == "jax" else torch.from_numpy(a.copy())


def _val(payload):
    if isinstance(payload, torch.Tensor):
        return payload.detach().to("cpu", torch.float32).numpy()
    return np.asarray(payload, np.float32)


def _fill(payload, value):
    if isinstance(payload, torch.Tensor):
        payload.fill_(value)
    else:
        np.asarray(payload)[...] = value


def _inc_pool(pkg, V, NT):
    api = M(pkg, "dsl.ptg.api")
    p = api.PTG("inc", NT=NT)
    p.task("T", k=api.Range(0, NT - 1)) \
        .affinity(lambda k, V=V: V(k)) \
        .flow("X", "RW",
              api.IN(api.DATA(lambda k, V=V: V(k))),
              api.OUT(api.DATA(lambda k, V=V: V(k)))) \
        .body(lambda X: X + 1.0)
    return p.build()


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_roundtrip_mid_computation(pkg, tmp_path):
    ck = M(pkg, "utils.checkpoint")
    NT = 4
    V = M(pkg, "data.matrix").VectorTwoDimCyclic(mb=8, lm=8 * NT)
    for m, _ in V.local_tiles():
        _fill(V.data_of(m).copy_on(0).payload, float(m))
    with _ctx(pkg, nb_cores=2) as ctx:
        ctx.add_taskpool(_inc_pool(pkg, V, NT))
        ctx.wait(timeout=60)
        path = ck.checkpoint(ctx, [V], str(tmp_path / "ck"))
        for _ in range(2):
            ctx.add_taskpool(_inc_pool(pkg, V, NT))
            ctx.wait(timeout=60)
        for m in range(NT):
            np.testing.assert_allclose(
                _val(V.data_of(m).pull_to_host().payload), m + 3.0)
        assert ck.restore(ctx, [V], str(tmp_path / "ck")) == NT
        for m in range(NT):
            np.testing.assert_allclose(
                _val(V.data_of(m).pull_to_host().payload), m + 1.0)
        ctx.add_taskpool(_inc_pool(pkg, V, NT))
        ctx.wait(timeout=60)
    for m in range(NT):
        np.testing.assert_allclose(
            _val(V.data_of(m).pull_to_host().payload), m + 2.0)
    assert path.endswith(".r0.npz")


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_device_state_flushes_home(pkg, tmp_path):
    """Tiles resident on the device module at checkpoint time land in the
    snapshot (the flush half of the quiesce contract)."""
    ck = M(pkg, "utils.checkpoint")
    TDBC = M(pkg, "data.matrix").TwoDimBlockCyclic
    rng = np.random.default_rng(4)
    n, mb = 64, 32
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    A = TDBC(mb=mb, nb=mb, lm=n, ln=n, name="A").from_array(_host(pkg, a))
    B = TDBC(mb=mb, nb=mb, lm=n, ln=n, name="B").from_array(_host(pkg, b))
    C = TDBC(mb=mb, nb=mb, lm=n, ln=n, name="C").from_array(
        _host(pkg, np.zeros((n, n))))
    with _ctx(pkg, device="cpu:1", nb_cores=2) as ctx:
        gemm = M(pkg, "apps.gemm").gemm_taskpool
        ctx.add_taskpool(gemm(A, B, C,
                              device="tpu" if pkg == "jax" else "cuda"))
        ctx.wait(timeout=120)
        if pkg == "port":
            # the product's tiles are the device module's (the host
            # copies are stale until a flush): the case the flush is for
            assert all(C.data_of(m, k).newest_copy().device != 0
                       for m, k in C.local_tiles())
        ck.checkpoint(ctx, [C], str(tmp_path / "gemm"))
        for m, nn in C.local_tiles():
            _fill(C.data_of(m, nn).pull_to_host().payload, -1.0)
        ck.restore(ctx, [C], str(tmp_path / "gemm"))
    got = C.to_array()
    np.testing.assert_allclose(_val(got), a @ b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("pkg", PKGS)
def test_restore_rejects_mismatched_layout(pkg, tmp_path):
    ck = M(pkg, "utils.checkpoint")
    V = M(pkg, "data.matrix").VectorTwoDimCyclic(mb=4, lm=8)
    with _ctx(pkg, nb_cores=1) as ctx:
        ck.checkpoint(ctx, [V], str(tmp_path / "x"))
        src = str(tmp_path / "x") + ".r0.npz"
        data = dict(np.load(src, allow_pickle=False))
        data["__meta__"] = np.array([1, 0, 4])
        np.savez(src.replace(".npz", ""), **data)
        with pytest.raises(ValueError, match="4 ranks"):
            ck.restore(ctx, [V], str(tmp_path / "x"))


def _dist_ckpt(ctx, rank, nranks, pkg, path):
    ck = M(pkg, "utils.checkpoint")
    V = M(pkg, "data.matrix").VectorTwoDimCyclic(
        mb=4, lm=4 * nranks * 2, nodes=nranks, myrank=rank)
    for m, _ in V.local_tiles():
        _fill(V.data_of(m).copy_on(0).payload, 10.0 * rank + m)
    ck.checkpoint(ctx, [V], path)
    for m, _ in V.local_tiles():
        _fill(V.data_of(m).pull_to_host().payload, -5.0)
    ck.restore(ctx, [V], path)
    for m, _ in V.local_tiles():
        np.testing.assert_allclose(
            _val(V.data_of(m).pull_to_host().payload), 10.0 * rank + m)
    return "ok"


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_distributed(pkg, tmp_path):
    path = str(tmp_path / f"dck-{pkg}")
    run = M(pkg, "comm.launch").run_distributed
    kw = {"device": "cpu"} if pkg == "port" else {}
    assert run(_dist_ckpt, 3, args=(pkg, path), timeout=120, **kw) \
        == ["ok"] * 3


def test_bf16_collection_round_trips_bit_for_bit(tmp_path):
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.utils.checkpoint import (checkpoint, restore,
                                                   shard_versions)
    g = torch.Generator().manual_seed(5)
    src = torch.randn(32, 32, generator=g).to(torch.bfloat16)
    A = TwoDimBlockCyclic(16, 16, 32, 32, dtype=torch.bfloat16,
                          name="Abf").from_array(src.clone())
    with Context(nb_cores=1, device="cpu") as ctx:
        path = str(tmp_path / "bf")
        checkpoint(ctx, [A], path)
        assert set(shard_versions(path, 0)) == {
            f"Abf:{m}:{n}" for m in range(2) for n in range(2)}
        B = TwoDimBlockCyclic(16, 16, 32, 32, dtype=torch.bfloat16,
                              name="Abf")
        assert restore(ctx, [B], path) == 4
    out = B.to_array()
    assert out.dtype == torch.bfloat16 and torch.equal(out, src)
