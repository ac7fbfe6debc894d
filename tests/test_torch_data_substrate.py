"""The port's data substrate — coherency protocol, arenas, repos and the
tiled-matrix collections — against the JAX package's.

Twins of the cases of tests/test_data_substrate.py that
tests/test_torch_layouts.py does not already twin (reference:
parsec/data.c semantics, data_dist/matrix layouts): each case runs the
reference test's steps on both packages and compares what both
observe — coherency states, versions, which copy a transfer pulls
from, ranks, shapes, retirements — besides holding each to the
reference test's asserts.  Payloads are numpy arrays in the JAX package
and CPU tensors in the port; where the reference checks that two arrays
share memory (``np.shares_memory``) the port's check reads the tensors
through ``.numpy()``, which is a view of the same storage.
"""

import numpy as np
import pytest
import torch

import parsec_tpu.data.arena as jax_arena
import parsec_tpu.data.collection as jax_collection
import parsec_tpu.data.data as jax_data
import parsec_tpu.data.datarepo as jax_datarepo
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu_torch.data.arena as port_arena
import parsec_tpu_torch.data.collection as port_collection
import parsec_tpu_torch.data.data as port_data
import parsec_tpu_torch.data.datarepo as port_datarepo
import parsec_tpu_torch.data.matrix as port_matrix


class _P:
    def __init__(self, pkg, arena, collection, data, datarepo, matrix):
        self.pkg = pkg
        self.arena, self.collection = arena, collection
        self.data, self.datarepo, self.matrix = data, datarepo, matrix
        self.Coherency = data.Coherency

    def arr(self, a):
        """``a`` (numpy) in the package's own array type, sharing it."""
        return a if self.pkg == "jax" else torch.from_numpy(a)

    def np(self, x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


PKGS = {
    "jax": _P("jax", jax_arena, jax_collection, jax_data, jax_datarepo,
              jax_matrix),
    "port": _P("port", port_arena, port_collection, port_data,
               port_datarepo, port_matrix),
}


def _both(case):
    """``case(P)`` on both packages; their observations must agree.
    Returns the port's."""
    got = {pkg: case(P) for pkg, P in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _states(P, d, spaces=(0, 1)):
    """(coherency name, version) of each listed copy of ``d``."""
    out = []
    for sp in spaces:
        c = d.copy_on(sp)
        out.append(None if c is None else (c.coherency.name, c.version))
    return out


# ---------------------------------------------------------------- coherency

def test_new_data_owned_on_host():
    def case(P):
        d = P.data.new_data(P.arr(np.zeros(4)))
        c = d.copy_on(0)
        return c.coherency == P.Coherency.OWNED, c.version, \
            d.newest_copy() is c
    assert _both(case) == (True, 1, True)


def test_read_transfer_shares():
    def case(P):
        d = P.data.new_data(P.arr(np.arange(4.0)))
        d.create_copy(1)  # INVALID device copy
        src = d.transfer_ownership(1, P.data.ACCESS_READ)
        return src is d.copy_on(0), _states(P, d)   # pulls from the host
    src_is_host, states = _both(case)
    assert src_is_host
    assert [s[0] for s in states] == ["OWNED", "SHARED"]


def test_write_transfer_invalidates_others():
    def case(P):
        d = P.data.new_data(P.arr(np.arange(4.0)))
        d.create_copy(1)
        d.transfer_ownership(1, P.data.ACCESS_READ)
        d.copy_on(1).version = 1
        src = d.transfer_ownership(1, P.data.ACCESS_WRITE)
        mid = _states(P, d)
        d.complete_write(1)
        return src, mid, _states(P, d), d.newest_copy() is d.copy_on(1)
    src, mid, end, newest = _both(case)
    assert src is None                  # already valid locally
    assert [s[0] for s in mid] == ["INVALID", "EXCLUSIVE"]
    assert end[1][1] == 2 and newest


def test_stale_copy_needs_transfer():
    def case(P):
        d = P.data.new_data(P.arr(np.arange(4.0)))
        d.create_copy(1)
        d.transfer_ownership(1, P.data.ACCESS_RW)
        d.complete_write(1)
        # host copy now stale; reading on host requires a pull from 1
        src = d.transfer_ownership(0, P.data.ACCESS_READ)
        return src is d.copy_on(1), _states(P, d)
    assert _both(case)[0]


def test_exclusive_demoted_to_owned_on_remote_read():
    def case(P):
        d = P.data.new_data(P.arr(np.arange(4.0)))
        d.create_copy(1)
        d.transfer_ownership(1, P.data.ACCESS_WRITE)
        d.complete_write(1)
        d.transfer_ownership(0, P.data.ACCESS_READ)
        return [s[0] for s in _states(P, d)]
    assert _both(case) == ["SHARED", "OWNED"]


def test_reader_counts():
    def case(P):
        d = P.data.new_data(P.arr(np.zeros(2)))
        d.start_read(0)
        d.start_read(0)
        seen = [d.copy_on(0).readers]
        d.end_read(0)
        d.end_read(0)
        return seen + [d.copy_on(0).readers]
    assert _both(case) == [2, 0]


# ------------------------------------------------------------------- arena

def test_arena_freelist_reuse():
    """The element type is given in each package's own dtype (numpy's
    float32, torch's float32); the datatype key names it the package's
    way ('<f4', 'torch.float32')."""
    dtypes = {"jax": np.float32, "port": torch.float32}

    def case(P):
        a = P.arena.Arena((8, 8), dtypes[P.pkg])
        c1 = a.get_copy()
        buf1 = c1.payload
        shape = tuple(buf1.shape)
        a.release_copy(c1)
        c2 = a.get_copy()
        dtt = P.arena.ArenaDatatype(a).dtt
        return shape, c2.payload is buf1, a.allocated, dtt[0], \
            str(buf1.dtype)
    got = {pkg: case(P) for pkg, P in PKGS.items()}
    assert got["jax"][:4] == got["port"][:4] == ((8, 8), True, 1, (8, 8))
    # the element type, each package's way: numpy's '<f4' string and
    # dtype name, torch's dtype
    assert got["jax"][3:] == ((8, 8), "float32") and \
        jax_arena.ArenaDatatype(jax_arena.Arena(
            (8, 8), np.float32)).dtt[1] == np.dtype(np.float32).str
    assert got["port"][4] == str(torch.float32) and \
        port_arena.ArenaDatatype(port_arena.Arena(
            (8, 8), torch.float32)).dtt[1] == str(torch.float32)


def test_arena_release_foreign_copy_rejected():
    for pkg, P in PKGS.items():
        a1, a2 = P.arena.Arena((2,)), P.arena.Arena((2,))
        c = a1.get_copy()
        with pytest.raises(ValueError):
            a2.release_copy(c)


# -------------------------------------------------------------------- repo

def test_repo_usage_and_retirement():
    def case(P):
        repo = P.datarepo.DataRepo(nb_flows=2, name="POTRF")
        retired = []
        e = repo.lookup_entry_and_create(("k", 0))
        e.on_retire = lambda entry: retired.append(entry.key)
        e.copies[0] = "copyA"
        repo.entry_addto_usage_limit(("k", 0), 3)   # 3 consumers declared
        seen = [repo.lookup_entry(("k", 0)) is e]
        repo.entry_used_once(("k", 0))
        repo.entry_used_once(("k", 0))
        seen.append(list(retired))
        repo.entry_used_once(("k", 0))
        return seen + [retired, repo.lookup_entry(("k", 0))]
    assert _both(case) == [True, [], [("k", 0)], None]


def test_repo_consumers_racing_ahead_of_declaration():
    """The two-counter protocol (usagelmt/usagecnt, reference datarepo.h):
    consumers finishing before the producer declares the limit must NOT
    retire the entry — retirement requires the declaration."""
    def case(P):
        repo = P.datarepo.DataRepo(nb_flows=1)
        e = repo.lookup_entry_and_create("x")
        e.copies[0] = "out"
        repo.entry_used_once("x")                  # consumer done FIRST
        repo.entry_used_once("x")                  # second consumer too
        alive = repo.lookup_entry("x") is e        # limit unknown
        repo.entry_addto_usage_limit("x", 2)       # producer declares
        return alive, repo.lookup_entry("x")       # retires exactly now
    assert _both(case) == (True, None)


def test_repo_zero_consumers_retires_immediately():
    def case(P):
        repo = P.datarepo.DataRepo(nb_flows=1)
        repo.lookup_entry_and_create("y")
        repo.entry_addto_usage_limit("y", 0)
        return repo.lookup_entry("y")
    assert _both(case) is None


# ------------------------------------------------------------- collections

def test_two_dim_block_cyclic_ranks():
    def case(P):
        # 4 ranks in a 2x2 grid, 4x4 tiles
        dcs = [P.matrix.TwoDimBlockCyclic(2, 2, 8, 8, nodes=4, myrank=r,
                                          P=2)
               for r in range(4)]
        A = dcs[0]
        ranks = {(m, n): A.rank_of(m, n) for m in range(4)
                 for n in range(4)}
        owners = {(m, n): [r for r, dc in enumerate(dcs)
                           if dc.is_local(m, n)]
                  for m in range(4) for n in range(4)}
        return (A.mt, A.nt), ranks, owners, \
            sorted(len(dc.local_tiles()) for dc in dcs)
    (mt_nt, ranks, owners, counts) = _both(case)
    assert mt_nt == (4, 4)
    # block-cyclic: rank(m,n) = (m%2)*2 + n%2; each tile local to one rank
    assert ranks == {(m, n): (m % 2) * 2 + (n % 2) for m in range(4)
                     for n in range(4)}
    assert owners == {k: [v] for k, v in ranks.items()}
    assert counts == [4, 4, 4, 4]


def test_block_cyclic_kp_kq_repetition():
    def case(P):
        A = P.matrix.TwoDimBlockCyclic(1, 1, 8, 8, nodes=4, myrank=0, P=2,
                                       kp=2, kq=2)
        return [A.rank_of(m, n) for m in range(8) for n in range(8)]
    ranks = _both(case)
    # with kp=kq=2, 2x2 super-blocks land on the same rank
    assert ranks[0 * 8 + 0] == ranks[1 * 8 + 1] == 0
    assert ranks[2 * 8 + 0] == ranks[3 * 8 + 1] == 2


def test_from_array_roundtrip_and_edge_tiles():
    def case(P):
        a = np.arange(30, dtype=np.float32).reshape(5, 6)
        A = P.matrix.TwoDimBlockCyclic(2, 4, 5, 6).from_array(P.arr(a))
        t = A.data_of(2, 1)                 # edge tile: 1x2
        payload = t.copy_on(0).payload
        seen = [(A.mt, A.nt), tuple(payload.shape),
                float(payload[0, 0]) == float(a[4, 4])]
        payload[0, 0] = -1                  # view writes through
        seen += [float(a[4, 4]), np.shares_memory(P.np(A.to_array()), a)]
        return seen
    assert _both(case) == [(3, 2), (1, 2), True, -1.0, True]


def test_data_key_roundtrip():
    def case(P):
        A = P.matrix.TwoDimBlockCyclic(2, 2, 8, 6)
        return [(A.data_key(m, n), A.key_to_indices(A.data_key(m, n)))
                for m in range(A.mt) for n in range(A.nt)]
    got = _both(case)
    assert [ix for _k, ix in got] == [(m, n) for m in range(4)
                                      for n in range(3)]


def test_remote_tile_access_rejected():
    for pkg, P in PKGS.items():
        A = P.matrix.TwoDimBlockCyclic(2, 2, 8, 8, nodes=2, myrank=0, P=2,
                                       Q=1)
        with pytest.raises(KeyError):
            A.data_of(1, 0)  # owned by rank 1


def test_vector_cyclic():
    def case(P):
        V = P.matrix.VectorTwoDimCyclic(4, 10, nodes=3, myrank=1)
        ranks = [V.rank_of(m) for m in range(3)]
        return ranks, tuple(V.data_of(1).copy_on(0).payload.shape)
    assert _both(case) == ([0, 1, 2], (4,))


def test_dataref_syntax():
    def case(P):
        A = P.matrix.TwoDimBlockCyclic(2, 2, 4, 4)
        ref = A(1, 1)
        return ref.rank, ref.resolve() is A.data_of(1, 1)
    assert _both(case) == (0, True)


def test_dc_registry():
    def case(P):
        A = P.matrix.TwoDimBlockCyclic(2, 2, 4, 4)
        dc_id = P.collection.dc_register(A)
        found = P.collection.dc_lookup(dc_id) is A
        P.collection.dc_unregister(dc_id)
        return found, P.collection.dc_lookup(dc_id)
    assert _both(case) == (True, None)


def test_write_only_access_needs_no_pull():
    def case(P):
        d = P.data.new_data(P.arr(np.arange(4.0)))
        d.create_copy(1)
        w = d.transfer_ownership(1, P.data.ACCESS_WRITE)
        rw = d.transfer_ownership(1, P.data.ACCESS_RW)   # EXCLUSIVE here
        return w, rw, _states(P, d)
    w, rw, _states_ = _both(case)
    assert w is None and rw is None


def test_rw_access_on_stale_copy_pulls():
    def case(P):
        d = P.data.new_data(P.arr(np.arange(4.0)))
        d.create_copy(1)
        src = d.transfer_ownership(1, P.data.ACCESS_RW)
        return src is d.copy_on(0), _states(P, d)
    assert _both(case)[0]


def test_version_clock_never_regresses():
    def case(P):
        d = P.data.new_data(P.arr(np.arange(4.0)))
        d.transfer_ownership(0, P.data.ACCESS_WRITE)
        d.complete_write(0)                      # host v2
        d.create_copy(1)
        d.transfer_ownership(1, P.data.ACCESS_WRITE)   # invalidates host
        d.complete_write(1)
        return _states(P, d), d.newest_copy() is d.copy_on(1)
    states, newest = _both(case)
    assert states[1][1] == 3 and newest    # monotonic, above stale host


def test_sym_local_tiles_and_is_local():
    def case(P):
        Sym = P.matrix.SymTwoDimBlockCyclic
        S = Sym(2, 2, 8, 8, uplo=Sym.LOWER)
        tiles = sorted(S.local_tiles())
        return tiles, S.is_local(0, 1), S.is_local(1, 0)
    tiles, up, low = _both(case)
    assert (0, 1) not in tiles and (1, 0) in tiles
    assert len(tiles) == 10                  # lower triangle of 4x4 tiles
    assert not up and low


def test_vector_array_roundtrip():
    def case(P):
        v = np.arange(10.0, dtype=np.float32)
        V = P.matrix.VectorTwoDimCyclic(4, 10).from_array(P.arr(v))
        edge = tuple(V.data_of(2).copy_on(0).payload.shape)  # len 2
        shares = np.shares_memory(P.np(V.to_array()), v)
        V2 = P.matrix.VectorTwoDimCyclic(4, 10)
        V2.data_of(0)
        out = P.np(V2.to_array())
        return edge, shares, out.shape, out.tolist()
    assert _both(case) == ((2,), True, (10,), [0.0] * 10)


def test_from_array_after_materialization_rejected():
    for pkg, P in PKGS.items():
        A = P.matrix.TwoDimBlockCyclic(2, 2, 4, 4)
        A.data_of(0, 0)
        with pytest.raises(ValueError):
            A.from_array(P.arr(np.zeros((4, 4), np.float32)))
