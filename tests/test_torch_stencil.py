"""The port's 1D periodic stencil (apps/stencil.py): twins of
tests/test_apps_drivers.py's stencil cases, held to the JAX package's
stencil on the same seeded vector.

Tolerances: both packages against the float64 serial reference at the
JAX package's own rtol 1e-4, atol 1e-5; the port against the JAX
package's result at atol 1e-6 (the same f32 arithmetic in another
order of rounding at most)."""

import numpy as np
import pytest
import torch

import parsec_tpu.apps.stencil as jax_stencil
import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu_torch.apps.stencil as port_stencil
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix


def _run(side, x, mb, steps, device, fuse=1, port_device="cpu"):
    """One stencil pool over ``x`` on a side; returns the final vector
    and the device module's executed-task counts."""
    jax = side == "jax"
    mat, ctxmod, app = (jax_matrix, jax_context, jax_stencil) if jax \
        else (port_matrix, port_context, port_stencil)
    V = mat.VectorTwoDimCyclic(mb=mb, lm=x.size).from_array(x.copy())
    kw = {} if jax else {"device": port_device}
    with ctxmod.Context(nb_cores=4, **kw) as ctx:
        ctx.add_taskpool(app.stencil_taskpool(V, steps, device=device,
                                              fuse=fuse))
        ctx.wait()
        executed = [d.stats.executed_tasks
                    for d in ctx.device_registry.accelerators]
    out = V.to_array()
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return out, executed


@pytest.mark.parametrize("device", ["device", "cpu"])
def test_stencil_matches_serial(device):
    NT, mb, steps = 4, 8, 5
    x = np.random.default_rng(2).standard_normal(NT * mb).astype(np.float32)
    ref, _ = _run("jax", x, mb, steps, "tpu" if device == "device" else "cpu")
    got, executed = _run("port", x, mb, steps,
                         "cuda" if device == "device" else "cpu")
    want = port_stencil.stencil_reference(x, steps)
    np.testing.assert_allclose(ref, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the device bodies ran on the CPU-backed module: NT x steps tasks
    assert sum(executed) == (NT * steps if device == "device" else 0)


@pytest.mark.parametrize("device", ["device", "cpu"])
def test_stencil_fused_sweeps_match_reference(device):
    """Fused blocks (with a ragged remainder: ceil(11/4) = 3 blocks)
    give the values of the serial reference and of the JAX package; a
    fuse deeper than the tile is rejected (the halo bound)."""
    NT, mb, steps, fuse = 4, 8, 11, 4
    x = np.random.default_rng(2).standard_normal(NT * mb).astype(np.float32)
    ref, _ = _run("jax", x, mb, steps,
                  "tpu" if device == "device" else "cpu", fuse)
    got, executed = _run("port", x, mb, steps,
                         "cuda" if device == "device" else "cpu", fuse)
    want = port_stencil.stencil_reference(x, steps)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert sum(executed) == (NT * 3 if device == "device" else 0)
    V = port_matrix.VectorTwoDimCyclic(mb=mb, lm=NT * mb)
    with pytest.raises(ValueError):
        port_stencil.stencil_taskpool(V, steps, fuse=mb + 1)


@pytest.mark.parametrize("fuse", [1, 3])
def test_stencil_across_several_cpu_backed_devices(fuse):
    """On four CPU-backed device modules the tiles move between modules
    every sweep (a neighbour's tile is staged from the module that wrote
    it): the result is still the JAX package's."""
    NT, mb, steps = 8, 16, 9
    x = np.random.default_rng(5).standard_normal(NT * mb).astype(np.float32)
    ref, _ = _run("jax", x, mb, steps, "tpu", fuse)
    got, executed = _run("port", x, mb, steps, "cuda", fuse,
                         port_device="cpu:4")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert sum(1 for n in executed if n > 0) >= 2


def test_stencil_refuses_the_jax_device_names():
    V = port_matrix.VectorTwoDimCyclic(mb=8, lm=32)
    for dev in ("tpu", "xla"):
        with pytest.raises(ValueError, match="'cuda'"):
            port_stencil.stencil_taskpool(V, 3, device=dev)
        with pytest.raises(ValueError, match="'cuda'"):
            port_stencil.stencil_taskpool(V, 3, device=dev, fuse=2)


def test_stencil_reference_takes_a_tensor():
    """The reference on a tensor (computed in float64 on its device)
    gives the numpy reference's values exactly."""
    x = np.random.default_rng(9).standard_normal(40).astype(np.float32)
    want = jax_stencil.stencil_reference(x, 13)
    got = port_stencil.stencil_reference(torch.from_numpy(x), 13)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_stencil.stencil_reference(x, 13),
                                  want)
