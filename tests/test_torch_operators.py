"""The port's map/apply/reduce operator pools against the JAX package's.

Twins of tests/test_operators.py (reference: tests/collections/reduce.c,
api/operator.c): the same operator over the same seeded collections on
both packages — numpy tiles there, CPU tensors here — with equal results
(the same f32/f64 operations in the same order), equal tiles touched and
the same refusals.  The port runs with ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.data.operators as jax_ops
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.data.operators as port_ops

PKGS = {"jax": (jax_context, jax_matrix, jax_ops, {}),
        "port": (port_context, port_matrix, port_ops, {"device": "cpu"})}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _arr(pkg, a):
    return a.copy() if pkg == "jax" else torch.from_numpy(a.copy())


def _run(pkg, tp):
    ctx_mod, _m, _o, kw = PKGS[pkg]
    with ctx_mod.Context(nb_cores=2, **kw) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=10)


def test_apply_scales_every_tile():
    a = np.arange(36, dtype=np.float32).reshape(6, 6)
    got = {}
    for pkg, (_c, mat, ops, _kw) in PKGS.items():
        A = mat.TwoDimBlockCyclic(2, 2, 6, 6).from_array(_arr(pkg, a))
        _run(pkg, ops.apply_op(A, lambda T, m, n: T.__imul__(2)))
        got[pkg] = _np(A.to_array())
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port"], a * 2)


def test_apply_sym_touches_stored_triangle_only():
    a = np.ones((4, 4), np.float32)
    got = {}
    for pkg, (_c, mat, ops, _kw) in PKGS.items():
        S = mat.SymTwoDimBlockCyclic(
            2, 2, 4, 4, uplo=mat.SymTwoDimBlockCyclic.LOWER) \
            .from_array(_arr(pkg, a))
        touched = []
        _run(pkg, ops.apply_op(S, lambda T, m, n: touched.append((m, n))))
        got[pkg] = sorted(touched)
    assert got["port"] == got["jax"] == [(0, 0), (1, 0), (1, 1)]


def test_map_reads_a_writes_b():
    a = np.arange(16, dtype=np.float32).reshape(4, 4)
    got = {}
    for pkg, (_c, mat, ops, _kw) in PKGS.items():
        b = _arr(pkg, np.zeros((4, 4), np.float32))
        A = mat.TwoDimBlockCyclic(2, 2, 4, 4).from_array(_arr(pkg, a))
        B = mat.TwoDimBlockCyclic(2, 2, 4, 4).from_array(b)
        if pkg == "jax":
            op = lambda X, Y, m, n: np.copyto(Y, X + 1)  # noqa: E731
        else:
            op = lambda X, Y, m, n: Y.copy_(X + 1)  # noqa: E731
        _run(pkg, ops.map_op(A, B, op))
        got[pkg] = _np(b).copy()     # written through the backing views
        with pytest.raises(ValueError):
            ops.map_op(A, mat.TwoDimBlockCyclic(4, 4, 4, 4),
                       lambda X, Y, m, n: None)
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port"], a + 1)


@pytest.mark.parametrize("mt,nt", [(1, 1), (2, 2), (3, 3), (4, 1)])
def test_reduce_tree_sums_all_tiles(mt, nt):
    lm, ln = 2 * mt, 2 * nt
    a = np.arange(lm * ln, dtype=np.float64).reshape(lm, ln)
    got = {}
    for pkg, (_c, mat, ops, _kw) in PKGS.items():
        A = mat.TwoDimBlockCyclic(2, 2, lm, ln, dtype=np.float64) \
            .from_array(_arr(pkg, a))
        tp, holder = ops.reduce_op(A, lambda x, y: x + y)
        _run(pkg, tp)
        got[pkg] = _np(holder["value"])
    want = sum(a[2 * m:2 * m + 2, 2 * n:2 * n + 2]
               for m in range(mt) for n in range(nt))
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_allclose(got["port"], want)


def test_reduce_rejects_ragged_tiles():
    for _c, mat, ops, _kw in PKGS.values():
        A = mat.TwoDimBlockCyclic(4, 4, 6, 6)
        with pytest.raises(ValueError):
            ops.reduce_op(A, lambda x, y: x + y)
