"""The port's pingpong, redistribute and permute-wave apps against the JAX
package's.

Twins of tests/test_apps_drivers.py's ``test_pingpong_single_process``
and ``test_redistribute_between_distributions`` (reference:
tests/apps/pingpong/rtt.jdf, bandwidth.jdf; redistribute_dtd.c), and of
the wave check of tests/test_ici.py against ``expected_wave_result``
(the JAX package's multichip dryrun's wave).  The same seeded tiles go
through both packages; values and tasks per class must agree.  The port
runs with ``device="cpu"``; its wave also runs its device bodies on the
CPU-backed device module.
"""

import collections
import threading

import numpy as np
import pytest
import torch

import parsec_tpu.apps.pingpong as jax_pingpong
import parsec_tpu.apps.redistribute as jax_redistribute
import parsec_tpu.apps.wave as jax_wave
import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu_torch.apps.pingpong as port_pingpong
import parsec_tpu_torch.apps.redistribute as port_redistribute
import parsec_tpu_torch.apps.wave as port_wave
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix

PKGS = {"jax": (jax_context, jax_matrix, {}),
        "port": (port_context, port_matrix, {"device": "cpu"})}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _counted(ctx):
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1
    ctx.pins_register("complete_exec", count)
    return done


def test_pingpong_single_process():
    got = {}
    for pkg, mod in (("jax", jax_pingpong), ("port", port_pingpong)):
        ctx_mod, _mat, kw = PKGS[pkg]
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            done = _counted(ctx)
            per_hop, mbps = mod.run_pingpong(ctx, nbytes=1024, hops=50)
        assert per_hop > 0 and mbps > 0
        got[pkg] = dict(done)
    assert got["port"] == got["jax"] == {"P": 50}


def test_pingpong_chain_adds_one_per_hop():
    """The chain's datum: 0 + one per hop, written back to the tile of
    the last hop (tile h % NT: hop 6 of 7 lands on tile 0)."""
    got = {}
    for pkg, mod in (("jax", jax_pingpong), ("port", port_pingpong)):
        ctx_mod, mat, kw = PKGS[pkg]
        V = mat.VectorTwoDimCyclic(mb=4, lm=8, name="PP")
        for m, _ in V.local_tiles():
            V.data_of(m).copy_on(0).payload[:] = 0.0
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            ctx.add_taskpool(mod.pingpong_taskpool(V, 7))
            ctx.wait(timeout=30)
        got[pkg] = [_np(V.data_of(m).pull_to_host().payload).tolist()
                    for m in range(2)]
    assert got["port"] == got["jax"] == [[7.0] * 4, [0.0] * 4]


def test_redistribute_between_distributions():
    mt = nt = 3
    mb = 8
    got = {}
    for pkg, mod in (("jax", jax_redistribute),
                     ("port", port_redistribute)):
        ctx_mod, mat, kw = PKGS[pkg]
        rng = np.random.default_rng(3)
        S = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=mt * mb, ln=nt * mb,
                                  name="S")
        # target: tabular distribution with a scrambled (single-rank) table
        T = mat.TwoDimTabular(mb=mb, nb=mb, lm=mt * mb, ln=nt * mb,
                              table=[0] * (mt * nt), name="T")
        for m, n in S.local_tiles():
            tile = rng.standard_normal((mb, mb)).astype(np.float32)
            S.data_of(m, n).copy_on(0).payload[:] = \
                tile if pkg == "jax" else torch.from_numpy(tile)
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            done = _counted(ctx)
            ctx.add_taskpool(mod.redistribute_taskpool(S, T))
            ctx.wait()
        np.testing.assert_array_equal(_np(T.to_array()), _np(S.to_array()))
        got[pkg] = (_np(T.to_array()).copy(), dict(done))
        with pytest.raises(ValueError, match="matching tile grids"):
            mod.redistribute_taskpool(S, mat.TwoDimBlockCyclic(
                mb=4, nb=4, lm=mt * mb, ln=nt * mb))
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1] == {"R": 9, "W": 9}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_permute_wave_matches_expected(device):
    """P producers double their block, a CTL gate holds the consumers,
    and C(q) adds P((q-1) mod P)'s result into W(q): the JAX package's
    ``expected_wave_result`` for every party, in both packages."""
    nd, mb = 8, 4
    got = {}
    for pkg, mod in (("jax", jax_wave), ("port", port_wave)):
        ctx_mod, mat, kw = PKGS[pkg]
        V = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=nd * mb, ln=mb,
                                  name="V")
        W = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=nd * mb, ln=mb,
                                  name="W")
        mod.fill_wave_inputs(V, W)
        with ctx_mod.Context(nb_cores=4, **kw) as ctx:
            done = _counted(ctx)
            ctx.add_taskpool(mod.permute_wave_taskpool(
                V, W, device="cpu" if pkg == "jax" else device))
            ctx.wait(timeout=60)
        got[pkg] = ([_np(W.data_of(q, 0).pull_to_host().payload).copy()
                     for q in range(nd)], dict(done))
    for q, (g, r) in enumerate(zip(got["port"][0], got["jax"][0])):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(
            g, port_wave.expected_wave_result(nd, q))
    assert got["port"][1] == got["jax"][1] == {"P": nd, "GATE": 1, "C": nd}
    assert [port_wave.expected_wave_result(nd, q) for q in range(nd)] == \
        [jax_wave.expected_wave_result(nd, q) for q in range(nd)]


def test_wave_refuses_the_jax_device_names():
    V = port_matrix.TwoDimBlockCyclic(mb=2, nb=2, lm=4, ln=2, name="V")
    W = port_matrix.TwoDimBlockCyclic(mb=2, nb=2, lm=4, ln=2, name="W")
    with pytest.raises(ValueError, match="XLA module"):
        port_wave.permute_wave_taskpool(V, W, device="tpu")
    with pytest.raises(ValueError, match="one W block per party"):
        port_wave.permute_wave_taskpool(
            V, port_matrix.TwoDimBlockCyclic(mb=2, nb=2, lm=6, ln=2), "cpu")
