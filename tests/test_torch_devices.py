"""The port's device registry with several CPU-backed device modules
(``device="cpu:N"``, the counterpart of the JAX package's tests'
8-device CPU mesh): twins of tests/test_devices.py's registry and
load-balance cases, the serving fabric's ``device_spaces`` confinement,
and a stage-in between two modules that keeps the versions and moves
the owner — each held to the JAX package on the same script."""

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg.api as jax_ptg
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg.api as port_ptg
from parsec_tpu_torch.devices import init_devices
from parsec_tpu_torch.devices.cuda import CudaDevice
from parsec_tpu_torch.devices.device import DeviceRegistry

#: (context module, matrix module, PTG module, Context kwargs, device
#: incarnation) per package
SIDES = {"jax": (jax_context, jax_matrix, jax_ptg, {}, "tpu"),
         "port": (port_context, port_matrix, port_ptg,
                  {"device": "cpu:8"}, "cuda")}


def test_registry_attach_and_spaces():
    reg = DeviceRegistry()
    assert reg.host.space == 0
    d = reg.attach(CudaDevice(torch.device("cpu"), index=0))
    e = reg.attach(CudaDevice(torch.device("cpu"), index=1))
    try:
        assert (d.space, e.space) == (1, 2)
        assert reg.get(1) is d and reg.get(2) is e
        assert reg.accelerators == [d, e]
        assert (d.name, e.name) == ("cuda-on-cpu:0", "cuda-on-cpu:1")
    finally:
        d.fini()
        e.fini()


@pytest.mark.parametrize("kind,n", [("cpu", 1), ("cpu:1", 1), ("cpu:3", 3),
                                    ("CPU:8", 8)])
def test_cpu_n_attaches_n_modules(kind, n):
    reg = init_devices(None, kind)
    try:
        accs = reg.accelerators
        assert [d.space for d in accs] == list(range(1, n + 1))
        assert [d.name for d in accs] == [f"cuda-on-cpu:{i}"
                                          for i in range(n)]
        assert all(d.tdev.type == "cpu" for d in accs)
    finally:
        reg.fini()


@pytest.mark.parametrize("kind", ["cpu:0", "cpu:x", "cpu:", "tpu"])
def test_bad_device_value_raises(kind):
    with pytest.raises(ValueError):
        init_devices(None, kind)


def _spread(side, nt=24, spaces=None):
    """nt independent RW tasks on distinct tiles, device bodies; returns
    the per-space executed counts and the result.  ``spaces``: the
    pool's device_spaces stamp."""
    ctxmod, mat, P, kw, dev = SIDES[side]
    A = mat.TwoDimBlockCyclic(mb=8, nb=8, lm=nt * 8, ln=8)
    for m, n in A.local_tiles():
        A.data_of(m, n).copy_on(0).payload[:] = 1.0
    with ctxmod.Context(nb_cores=2, **kw) as ctx:
        accs = ctx.device_registry.accelerators
        p = P.PTG("spread", NT=nt)
        p.task("S", m=P.Range(0, nt - 1)) \
            .affinity(lambda m, A=A: A(m, 0)) \
            .flow("T", "RW", P.IN(P.DATA(lambda m, A=A: A(m, 0))),
                  P.OUT(P.DATA(lambda m, A=A: A(m, 0)))) \
            .body(lambda T: T * 2.0, device=dev)
        tp = p.build()
        tp.device_spaces = spaces
        ctx.add_taskpool(tp)
        ctx.wait()
        executed = {d.space: d.stats.executed_tasks for d in accs}
    out = A.to_array()
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return executed, out


def test_best_device_load_balance():
    """Without affinity hints, tasks spread across the modules by load
    (as on the JAX package's mesh), and the values agree exactly."""
    ref_exec, ref = _spread("jax")
    got_exec, got = _spread("port")
    assert len(got_exec) == len(ref_exec) == 8
    assert sum(1 for n in got_exec.values() if n) >= 2
    assert sum(1 for n in ref_exec.values() if n) >= 2
    assert sum(got_exec.values()) == sum(ref_exec.values()) == 24
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("spaces", [frozenset({3}), frozenset({2, 7})])
def test_device_spaces_confine_execution(spaces):
    """A pool stamped with ``device_spaces`` (the fabric's carve) runs
    every device task inside the stamp, on both packages."""
    for side in ("jax", "port"):
        executed, out = _spread(side, nt=12, spaces=spaces)
        used = {s for s, n in executed.items() if n}
        assert used and used <= spaces, (side, used)
        assert sum(executed.values()) == 12
        np.testing.assert_array_equal(out, np.full((96, 8), 2.0))


def _scale(mult):
    """A device body multiplying its tile by ``mult`` (a closure: a
    body's named arguments are bound from flows and task parameters)."""
    return lambda T: T * mult


def _two_hops(side):
    """One tile written by a pool confined to space 1, then by a pool
    confined to space 2: the second stage-in copies the tile from the
    first module.  Returns (newest version, home space, coherency by
    space) after each hop, and the final value."""
    ctxmod, mat, P, kw, dev = SIDES[side]
    A = mat.TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
    A.data_of(0, 0).copy_on(0).payload[:] = 1.0
    datum = A.data_of(0, 0)
    hops = []
    with ctxmod.Context(nb_cores=2, **kw) as ctx:
        for space, mult in ((1, 3.0), (2, 5.0)):
            p = P.PTG(f"hop{space}")
            p.task("W", i=P.Range(0, 0)) \
                .affinity(lambda i, A=A: A(0, 0)) \
                .flow("T", "RW", P.IN(P.DATA(lambda i, A=A: A(0, 0))),
                      P.OUT(P.DATA(lambda i, A=A: A(0, 0)))) \
                .body(_scale(mult), device=dev)
            tp = p.build()
            tp.device_spaces = frozenset({space})
            ctx.add_taskpool(tp)
            ctx.wait()
            hops.append((datum.newest_version(), datum.owner_device,
                         {s: c.coherency.name
                          for s, c in sorted(datum.copies().items())
                          if c.payload is not None}))
    value = float(np.asarray(datum.pull_to_host().payload)[0, 0])
    return hops, value


def test_stage_in_between_modules_keeps_versions():
    ref = _two_hops("jax")
    got = _two_hops("port")
    assert got == ref
    (v1, _h1, c1), (v2, _h2, c2) = got[0]
    # the second module staged the first's newest version and wrote the
    # next one; ownership moved with it
    assert v2 == v1 + 1
    assert c1[1] == "EXCLUSIVE" and c2[2] == "EXCLUSIVE"
    assert c2[1] == "INVALID" and c2[0] == "INVALID"
    assert got[1] == 15.0
