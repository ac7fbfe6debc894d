"""The port's irregular apps against the JAX package's: DTD merge sort,
the adaptive Haar tree and all2all.

Twins of tests/test_apps_trees.py (reference: tests/apps/{merge_sort,
haar_tree,all2all}); its band-collection case is in
tests/test_torch_layouts.py.  The same seeded data goes through both
packages: the sorted result, the Haar tree's shape (nodes, leaves and
their values) and the all2all tiles, tasks per class and protocol
counters must agree.  The port runs with ``device="cpu"``; all2all runs
one ``run_distributed`` per package on four CPU ranks.
"""

import functools

import numpy as np
import pytest
import torch

import parsec_tpu.apps.trees as jax_trees
import parsec_tpu.core.context as jax_context
import parsec_tpu.dsl.dtd as jax_dtd
import parsec_tpu_torch.apps.trees as port_trees
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.dsl.dtd as port_dtd

import torch_comm_workers as W

PKGS = {"jax": (jax_context, jax_dtd, jax_trees, {}),
        "port": (port_context, port_dtd, port_trees, {"device": "cpu"})}
T_RUN = 240   # per distributed run, seconds


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("data_kind", ["numpy", "tensor"])
def test_merge_sort_dtd(data_kind):
    """reference: tests/apps/merge_sort — leaf sorts + merge tree."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal(1000).astype(np.float32)
    got = {}
    for pkg, (ctx_mod, dtd, trees, kw) in PKGS.items():
        arg = torch.from_numpy(data.copy()) \
            if pkg == "port" and data_kind == "tensor" else data.copy()
        with ctx_mod.Context(nb_cores=4, **kw) as ctx:
            tp = dtd.DTDTaskpool("msort")
            ctx.add_taskpool(tp)
            ctx.start()
            out = trees.merge_sort_dtd(tp, arg, leaf=37)
            tp.wait(timeout=60)
            got[pkg] = (_np(out.data.pull_to_host().payload).copy(),
                        tp.nb_tasks)
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_array_equal(got["port"][0], np.sort(data))
    assert got["port"][1] == got["jax"][1] == 0


def _f(x):
    return np.where(x < 0.3, 0.0, np.where(x < 0.7, 1.0, 0.25))


def test_haar_tree_dynamic_termination():
    """reference: tests/apps/haar_tree project_dyn — tasks spawn tasks
    at runtime; the user_trigger termdet ends the pool when the
    algorithm (not a task count) says so.  Both packages discover the
    same tree."""
    got = {}
    for pkg, (ctx_mod, dtd, trees, kw) in PKGS.items():
        proj = trees.HaarProjection(_f, eps=1e-3, min_width=1e-3)
        with ctx_mod.Context(nb_cores=4, **kw) as ctx:
            tp = dtd.DTDTaskpool("haar")
            tp.termdet_name = "user_trigger"
            ctx.add_taskpool(tp)
            ctx.start()
            proj.run(tp)
            tp.wait(timeout=60)
            ctx.wait(timeout=60)
        got[pkg] = proj
    port, ref = got["port"], got["jax"]
    assert port.nodes == ref.nodes and port.nodes > 16
    assert port.leaves == ref.leaves and len(port.leaves) >= 4
    xs = np.linspace(0.05, 0.95, 400)
    np.testing.assert_array_equal(port.evaluate(xs), ref.evaluate(xs))
    assert np.mean(np.abs(port.evaluate(xs) - _f(xs))) < 0.05


def test_haar_tree_requires_user_trigger():
    for ctx_mod, dtd, trees, kw in PKGS.values():
        proj = trees.HaarProjection(lambda x: x)
        with ctx_mod.Context(nb_cores=2, **kw) as ctx:
            tp = dtd.DTDTaskpool("haar2")
            ctx.add_taskpool(tp)
            ctx.start()
            with pytest.raises(ValueError, match="user_trigger"):
                proj.run(tp)
            tp.wait(timeout=30)


@functools.lru_cache(maxsize=None)
def _all2all():
    return W.run_both(W.all2all, 4, timeout=T_RUN)


def test_all2all_4ranks():
    """Every rank sends a distinct block to every other rank: R(i, j)
    on rank j ends holding S(i, j)'s 100 i + j."""
    j, p = _all2all()
    for rank, (rj, rp) in enumerate(zip(j, p)):
        assert rp["vals"].keys() == rj["vals"].keys()
        for key, tile in rp["vals"].items():
            np.testing.assert_array_equal(tile, rj["vals"][key])
            i, jj = map(int, key.split(","))
            assert jj == rank
            np.testing.assert_array_equal(tile, 100.0 * i + jj)
        assert rp["done"] == rj["done"] == {"SEND": 4, "RECV": 4}
        assert rp["proto"] == rj["proto"]
        assert rp["termdet"] == rj["termdet"]
