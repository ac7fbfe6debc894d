"""The port's symmetric, band, tabular, hash and subtile layouts against
the JAX package's.

Twins of tests/test_data_substrate.py's ``test_sym_matrix_triangle_only``,
``test_tabular_distribution``, ``test_hash_datadist`` and
``test_subtile_views_parent``, and of tests/test_apps_trees.py's
``test_band_collection`` (reference: sym_two_dim_rectangle_cyclic.c,
two_dim_tabular.c, hash_datadist.c, subtile.c, the *_band.c variants):
each layout is built by both packages with the same arguments, and
ownership, stored tiles, refusals and tile values must agree.  Tiles
are numpy arrays in the JAX package and CPU tensors in the port.
"""

import numpy as np
import pytest
import torch

import parsec_tpu.data.hash_datadist as jax_hash
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.data.subtile as jax_subtile
import parsec_tpu_torch.data.hash_datadist as port_hash
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.data.subtile as port_subtile

MATS = {"jax": jax_matrix, "port": port_matrix}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ranks(M, mt, nt):
    """Each tile's rank, or "KeyError" where the layout refuses it."""
    out = {}
    for m in range(mt):
        for n in range(nt):
            try:
                out[(m, n)] = M.rank_of(m, n)
            except KeyError:
                out[(m, n)] = "KeyError"
    return out


def test_sym_matrix_triangle_only():
    got = {}
    for pkg, mod in MATS.items():
        S = mod.SymTwoDimBlockCyclic(2, 2, 8, 8,
                                     uplo=mod.SymTwoDimBlockCyclic.LOWER)
        assert S.rank_of(3, 1) == 0
        with pytest.raises(KeyError):
            S.rank_of(1, 3)
        with pytest.raises(KeyError):
            S.data_of(0, 2)
        U = mod.SymTwoDimBlockCyclic(2, 2, 8, 8, nodes=2, P=2,
                                     uplo=mod.SymTwoDimBlockCyclic.UPPER)
        got[pkg] = (_ranks(S, 4, 4), sorted(S.local_tiles()),
                    _ranks(U, 4, 4), sorted(U.local_tiles()))
    assert got["port"] == got["jax"]
    assert got["port"][1] == [(m, n) for m in range(4) for n in range(m + 1)]


def test_tabular_distribution():
    got = {}
    for pkg, mod in MATS.items():
        T = mod.TwoDimTabular(2, 2, 4, 4, [0, 1, 1, 0], nodes=2, myrank=0)
        got[pkg] = (_ranks(T, 2, 2), sorted(T.local_tiles()))
        with pytest.raises(ValueError):
            mod.TwoDimTabular(2, 2, 4, 4, [0], nodes=2)
        with pytest.raises(KeyError):
            T.data_of(0, 1)        # rank 1's tile
    assert got["port"] == got["jax"]
    assert got["port"][0] == {(0, 0): 0, (0, 1): 1, (1, 0): 1, (1, 1): 0}
    assert got["port"][1] == [(0, 0), (1, 1)]


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_hash_datadist(payload):
    got = {}
    for pkg, mod in (("jax", jax_hash), ("port", port_hash)):
        H = mod.HashDatadist(nodes=2, myrank=0)
        H.set_rank("root", 0)
        H.set_rank("leaf", 1, vpid=3)
        ones = np.ones(3)
        if pkg == "port" and payload == "tensor":
            ones = torch.ones(3, dtype=torch.float64)
        H.set_data("root", ones)
        with pytest.raises(KeyError):
            H.data_of("leaf")
        with pytest.raises(KeyError):
            H.rank_of("unknown")
        got[pkg] = (H.rank_of("root"), H.rank_of("leaf"),
                    H.vpid_of("leaf"), H.vpid_of("unknown"),
                    float(_np(H.data_of("root").copy_on(0).payload).sum()),
                    H.data_of("root").key)
    assert got["port"] == got["jax"] == (0, 1, 3, 0, 3.0, ("H", "root"))
    assert isinstance(port_hash.HashDatadist().set_data(
        "k", np.zeros(2)).copy_on(0).payload, torch.Tensor)


def test_subtile_views_parent():
    got = {}
    for pkg, mod, sub in (("jax", jax_matrix, jax_subtile),
                          ("port", port_matrix, port_subtile)):
        a = np.arange(16.0, dtype=np.float32).reshape(4, 4)
        arr = a if pkg == "jax" else torch.from_numpy(a)
        A = mod.TwoDimBlockCyclic(4, 4, 4, 4).from_array(arr)
        S = sub.SubtileMatrix(A.data_of(0, 0), 2, 2)
        s = S.data_of(1, 1).copy_on(0).payload
        # the inner tile is a view of the parent's storage
        s[0, 0] = -1.0
        got[pkg] = (S.mt, S.nt, _np(s).tolist(), float(a[2, 2]),
                    S.rank_of(1, 1))
    assert got["port"] == got["jax"]
    assert got["port"][3] == -1.0


def test_band_collection():
    """reference: *_band.c — only band tiles stored/addressable."""
    got = {}
    for pkg, mod in MATS.items():
        B = mod.BandTwoDimBlockCyclic(mb=4, nb=4, lm=24, ln=24, band_km=1,
                                      name="B")
        assert B.tile_exists(2, 2) and B.tile_exists(2, 1) \
            and B.tile_exists(2, 3)
        assert not B.tile_exists(0, 5) and not B.tile_exists(5, 0)
        with pytest.raises(KeyError):
            B.data_of(0, 4)
        L = mod.BandTwoDimBlockCyclic(mb=4, nb=4, lm=24, ln=24, band_km=2,
                                      uplo=0, name="L")
        assert L.tile_exists(3, 1) and not L.tile_exists(1, 3)
        B.data_of(1, 2).copy_on(0).payload[:] = 7.0
        got[pkg] = (sorted(B.local_tiles()), sorted(L.local_tiles()),
                    _ranks(L, 6, 6),
                    _np(B.data_of(1, 2).pull_to_host().payload).tolist())
    assert got["port"] == got["jax"]
    assert got["port"][0] == [(m, n) for m in range(6) for n in range(6)
                              if abs(m - n) <= 1]
