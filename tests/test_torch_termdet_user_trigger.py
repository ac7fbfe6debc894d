"""The port's user_trigger termination detector against the JAX
package's, on one rank.

Twin of tests/test_termdet_user_trigger.py::test_user_trigger_local
(reference: mca/termdet/termdet_user_trigger_module.c): a DTD pool whose
counters reach zero stays alive until ``trigger`` ends it, in both
packages alike (the port on ``device="cpu"``).  The distributed case's
twin is test_torch_comm_distributed.py's
``test_user_trigger_propagates_across_ranks``.
"""

import time

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.dtd as jax_dtd
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.dtd as port_dtd

PKGS = {"jax": (jax_context, jax_matrix, jax_dtd, {}),
        "port": (port_context, port_matrix, port_dtd, {"device": "cpu"})}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_user_trigger_local(pkg):
    """Zero counters never fire; trigger() does."""
    ctx_mod, matrix, dtd, kw = PKGS[pkg]
    V = matrix.VectorTwoDimCyclic(mb=2, lm=2)
    V.data_of(0).copy_on(0).payload[:] = 0.0
    with ctx_mod.Context(nb_cores=2, **kw) as ctx:
        tp = dtd.DTDTaskpool("dyn")
        tp.termdet_name = "user_trigger"
        ctx.add_taskpool(tp)
        ctx.start()
        t = tp.tile_of(V, 0)
        for _ in range(5):
            tp.insert_task(lambda T: T + 1.0, (t, dtd.INOUT))
        # drain the inserted work, then prove the pool is still alive
        deadline = time.monotonic() + 30
        while tp._inflight > 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert not tp.completed, \
            "user_trigger pool must not self-terminate on zero counters"
        tp.termdet.trigger(tp)
        assert tp.wait_local(10)
        ctx.wait(timeout=30)
    got = V.data_of(0).pull_to_host().payload
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(np.asarray(got), 5.0)
