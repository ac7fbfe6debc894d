"""The port's SPMD schedules and multichip dryrun against the JAX
package's.

Twins of tests/test_parallel_spmd.py: the same seeded numpy inputs go
through the JAX package's shard_map programs on the conftest's virtual
8-device CPU mesh and through the port's single-controller schedules
(parallel/spmd.py) over eight mesh positions — the modules of a
``device="cpu:8"`` Context, or eight ``torch.device("cpu")`` entries —
and the results are held against numpy and against each other at the
reference tests' tolerances (1e-4 for the GEMMs, 1e-5 for the stencil).
The dryrun twin runs the port's ``parallel/dryrun.py`` on ``cpu:8`` and
holds it to the graft entry's checks and its printed ICI counts.
"""

import ast
import re

import numpy as np
import pytest
import torch

import parsec_tpu.parallel.spmd as jax_spmd
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.parallel.spmd as port_spmd
from parsec_tpu_torch.parallel.dryrun import dryrun_multichip


@pytest.fixture(params=["modules", "torch"])
def positions(request):
    """Eight mesh positions: a cpu:8 Context's device modules, or eight
    torch CPU devices."""
    if request.param == "torch":
        yield [torch.device("cpu")] * 8
        return
    with port_context.Context(nb_cores=1, device="cpu:8") as ctx:
        yield ctx.ici.mesh()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_make_mesh_square_factorization(positions):
    mesh = port_spmd.make_mesh(devices=positions)
    ref = jax_spmd.make_mesh()
    assert mesh.devices.size == ref.devices.size == 8
    assert mesh.devices.shape == ref.devices.shape == (2, 4)
    assert mesh.axis_names == ref.axis_names == ("p", "q")
    assert mesh.shape == dict(ref.shape)


def test_make_mesh_without_a_card_asks_for_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_spmd.make_mesh()


def test_summa_gemm_matches_numpy(positions):
    rng = np.random.default_rng(3)
    ref_mesh = jax_spmd.make_mesh()
    mesh = port_spmd.make_mesh(devices=positions)
    p, q = mesh.devices.shape
    a = rng.standard_normal((4 * p, 8 * p * q)).astype(np.float32)
    b = rng.standard_normal((8 * p * q, 4 * q)).astype(np.float32)
    want = np.asarray(jax_spmd.summa_gemm_fn(ref_mesh)(a, b))
    got = _np(port_spmd.summa_gemm_fn(mesh)(a, b))
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ring_reduce_gemm_matches_numpy(positions):
    rng = np.random.default_rng(4)
    ref_mesh = jax_spmd.make_mesh(shape=(8,), axis_names=("p",))
    mesh = port_spmd.make_mesh(shape=(8,), axis_names=("p",),
                               devices=positions)
    a = rng.standard_normal((16, 32)).astype(np.float32)
    b = rng.standard_normal((32, 24)).astype(np.float32)
    want = np.asarray(jax_spmd.ring_reduce_gemm_fn(ref_mesh)(a, b))
    got = _np(port_spmd.ring_reduce_gemm_fn(mesh)(a, b))
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_halo_stencil_matches_serial(positions):
    rng = np.random.default_rng(5)
    ref_mesh = jax_spmd.make_mesh(shape=(8,), axis_names=("p",))
    mesh = port_spmd.make_mesh(shape=(8,), axis_names=("p",),
                               devices=positions)
    x = rng.standard_normal(64).astype(np.float32)

    def serial_step(u):
        ext = np.concatenate([u[-1:], u, u[:1]])
        return (ext[:-2] + ext[2:] + u) / 3.0

    want = serial_step(serial_step(x))
    ref = np.asarray(jax_spmd.halo_stencil_fn(ref_mesh, steps=2)(x))
    got = _np(port_spmd.halo_stencil_fn(mesh, steps=2)(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _printed_stats(text: str) -> dict:
    """The graft entry's printed ICI counts, by graph."""
    out = {}
    for name in ("GEMM", "potrf", "geqrf"):
        m = re.search(r"tiled " + name + r" over \d+ devices ok \(rel err "
                      r"([0-9.e+-]+)\); ici collectives: (\{[^}]*\})", text)
        assert m, f"no {name} line in:\n{text}"
        out[name] = (float(m.group(1)), ast.literal_eval(m.group(2)))
    m = re.search(r"permute wave: (\{[^}]*\})", text)
    out["wave"] = ast.literal_eval(m.group(1))
    return out


def test_dryrun_multichip_twin(capsys):
    """The port's dryrun on cpu:8 passes the graft entry's checks (each
    step's own asserts: SPMD trio, GEMM rel err < 1e-4, the wave's values,
    potrf and geqrf < 1e-4) and prints the same lines.  The GEMM's
    broadcasts and bytes are the DAG's, so they equal the JAX package's;
    potrf's and geqrf's depend on which consumers
    stage in before a deferred edge flushes (and, in the port, on chain
    fusion holding panel outputs as placeholders the engine skips), so
    only their errors are compared."""
    import __graft_entry__ as g
    g.dryrun_multichip(8)
    ref = _printed_stats(capsys.readouterr().out)
    got = dryrun_multichip(8, device="cpu:8")
    text = capsys.readouterr().out
    assert "dryrun_multichip(8): mesh 2x4 ok" in text
    printed = _printed_stats(text)
    assert printed["GEMM"][1] == got["gemm"]["ici"]
    for name, key in (("GEMM", "gemm"), ("potrf", "potrf"),
                      ("geqrf", "geqrf")):
        assert got[key]["rel_err"] < 1e-4 and ref[name][0] < 1e-4
    assert got["gemm"]["ici"]["bcasts"] == ref["GEMM"][1]["bcasts"] > 0
    assert got["gemm"]["ici"]["bcast_bytes"] == \
        ref["GEMM"][1]["bcast_bytes"]
    # the wave's 8 edges ride one put and one 7-edge permute on both
    # (MULTICHIP_r05.json); the JAX package's dryrun asserts only that
    # something moved, so its side is held to that alone
    w, rw = got["gemm"]["wave"], ref["wave"]
    assert w["permutes"] + w["puts"] <= 2 and w["permute_edges"] >= 6
    assert rw["permutes"] > 0 or rw["puts"] > 0
