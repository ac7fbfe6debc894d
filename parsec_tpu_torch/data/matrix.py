"""Tiled-matrix collections.

Rebuild of the reference's matrix data distributions
(reference: parsec/data_dist/matrix/matrix.{c,h},
two_dim_rectangle_cyclic.{c,h}, grid_2Dcyclic.c): a logical LM x LN
matrix cut into MB x NB tiles, distributed over a process grid.
``TwoDimBlockCyclic`` is the ScaLAPACK PxQ block-cyclic layout (with kp/kq
repetition factors), ``KCyclicView`` its k-cyclic reordered view (the
textual JDF front-end's kcyclic corpus reads it), ``SymTwoDimBlockCyclic``
and ``BandTwoDimBlockCyclic`` store one triangle or a band of it,
``TwoDimTabular`` maps tiles to ranks by a table, and
``VectorTwoDimCyclic`` is the 1D cyclic vector of tiles.

Tiles are CPU tensors of the collection's torch dtype (``torch.bfloat16``
or ``torch.float32``), materialized lazily on first access.  numpy has no
bf16, so ``from_array`` takes numpy or a tensor and converts to the
collection dtype, and ``to_array`` gives a tensor.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parsec_tpu_torch.data.collection import DataCollection
from parsec_tpu_torch.data.data import (Coherency, Data, new_data, to_host,
                                        torch_dtype)


class TiledMatrix(DataCollection):
    """Base tiled matrix (reference: parsec_tiled_matrix_t)."""

    def __init__(self, mb: int, nb: int, lm: int, ln: int,
                 dtype: Any = torch.float32, nodes: int = 1,
                 myrank: int = 0, name: str = "A"):
        super().__init__(nodes=nodes, myrank=myrank, name=name)
        self.mb, self.nb = mb, nb           # tile rows/cols
        self.lm, self.ln = lm, ln           # full matrix rows/cols
        self.mt = -(-lm // mb)              # tiles in row dimension
        self.nt = -(-ln // nb)
        self.dtype = torch_dtype(dtype)
        self._lock = threading.Lock()
        self._tiles: Dict[Tuple[int, int], Data] = {}
        self._backing: Optional[torch.Tensor] = None

    # -- keys -------------------------------------------------------------
    def data_key(self, m: int, n: int = 0) -> int:
        return m * self.nt + n

    def key_to_indices(self, key: int) -> Tuple[int, int]:
        return divmod(key, self.nt)

    # -- local storage ----------------------------------------------------
    def tile_shape(self, m: int, n: int) -> Tuple[int, int]:
        """Edge tiles may be partial."""
        return (min(self.mb, self.lm - m * self.mb),
                min(self.nb, self.ln - n * self.nb))

    def tile_exists(self, m: int, n: int = 0) -> bool:
        """Whether (m, n) is a stored tile (symmetric layouts store one
        triangle only)."""
        return 0 <= m < self.mt and 0 <= n < self.nt

    def is_local(self, *indices) -> bool:
        return self.tile_exists(*indices) and \
            self.owner_of(*indices) == self.myrank

    def from_array(self, a: Any) -> "TiledMatrix":
        """Back local tiles with views into an LM x LN array (single-rank
        convenience).  ``a`` is a numpy array or a CPU tensor; it is
        aliased when it already has the collection dtype, else converted
        into a tensor of that dtype.  Must be called before any tile is
        materialized."""
        a = to_host(a)
        if tuple(a.shape) != (self.lm, self.ln):
            raise ValueError(
                f"expected {(self.lm, self.ln)}, got {tuple(a.shape)}")
        if a.dtype != self.dtype:
            a = a.to(self.dtype)
        with self._lock:
            if self._tiles:
                raise ValueError(
                    "from_array after tiles were materialized would detach "
                    "them from the backing array; call it first")
            self._backing = a
        return self

    def to_array(self) -> torch.Tensor:
        """Gather local tiles into a full CPU tensor of the collection
        dtype (single-rank only)."""
        if self.nodes != 1:
            raise ValueError("to_array is single-rank only")
        if self._backing is not None:
            self._sync_backing()
            return self._backing
        out = torch.zeros((self.lm, self.ln), dtype=self.dtype)
        for (m, n), d in list(self._tiles.items()):
            c = d.pull_to_host()
            tm, tn = self.tile_shape(m, n)
            out[m * self.mb:m * self.mb + tm,
                n * self.nb:n * self.nb + tn] = to_host(c.payload)[:tm, :tn]
        return out

    def to_numpy(self) -> np.ndarray:
        """:meth:`to_array` as a numpy float32 array (exact for bf16)."""
        return self.to_array().to(torch.float32).numpy()

    def _tile_view(self, m: int, n: int) -> torch.Tensor:
        tm, tn = self.tile_shape(m, n)
        return self._backing[m * self.mb:m * self.mb + tm,
                             n * self.nb:n * self.nb + tn]

    def _sync_backing(self) -> None:
        """Pull tiles whose newest copy lives off-host, then re-link
        replaced host payloads into the backing array (to_array is a
        quiescent point by contract)."""
        for (m, n), d in list(self._tiles.items()):
            d.pull_to_host()
            self.refresh_backing(d)

    def refresh_backing(self, datum: Data) -> None:
        """Copy a replaced host payload back into its backing slice and
        re-link the view (a ``-> DATA`` writeback replaces host copies
        with private payloads — see engine._writeback — so same-wavefront
        readers keep a pinned snapshot; once the pool quiesces the
        backing array must reflect the final value again)."""
        if self._backing is None:
            return
        _name, m, n = datum.key
        with datum._lock:
            host = datum.copy_on(0)
            if host is None or host.payload is None or \
                    host.coherency == Coherency.INVALID or \
                    host.version < datum.newest_version():
                return   # stale host: a later D2H pull refreshes instead
            view = self._tile_view(m, n)
            pay = to_host(host.payload)
            if pay.data_ptr() != view.data_ptr():
                view.copy_(pay.reshape(view.shape))
                host.payload = view

    def _make_tile(self, m: int, n: int) -> Data:
        if self._backing is not None:
            payload = self._tile_view(m, n)
        else:
            payload = torch.zeros(self.tile_shape(m, n), dtype=self.dtype)
        return new_data(payload, key=self.tile_key(m, n),
                        collection=self)

    def data_of(self, m: int, n: int = 0) -> Data:
        with self._lock:
            t = self._tiles.get((m, n))
            if t is None:
                # owner_of, not rank_of: after a recovery re-mapping
                # this rank legitimately serves adopted tiles of a dead
                # rank's partition (their payloads are restored by the
                # RecoveryCoordinator before any task reads them)
                if self.owner_of(m, n) != self.myrank:
                    raise KeyError(
                        f"{self.name}({m},{n}) lives on rank "
                        f"{self.owner_of(m, n)}, not {self.myrank}")
                t = self._make_tile(m, n)
                self._tiles[(m, n)] = t
            return t

    def place_on_device(self, m: int, n: int, device,
                        payload: torch.Tensor) -> Data:
        """Make ``payload`` — a tensor already on ``device``'s memory
        (a device module) — the authoritative copy of tile (m, n): tiles
        born on the device.  A tile not materialized yet gets no host
        storage; its empty host copy fills when a read pulls it home."""
        if tuple(payload.shape) != self.tile_shape(m, n) or \
                payload.dtype != self.dtype:
            raise ValueError(
                f"{self.name}({m},{n}): expected {self.tile_shape(m, n)} "
                f"{self.dtype}, got {tuple(payload.shape)} {payload.dtype}")
        with self._lock:
            d = self._tiles.get((m, n))
            if d is None:
                d = Data(key=self.tile_key(m, n), collection=self,
                         nb_elts=payload.numel() * payload.element_size())
                d.create_copy(0)          # INVALID, no payload
                self._tiles[(m, n)] = d
        dc = d.overwrite_on(device.space, payload)
        device.adopt(d, dc)
        return d

    def local_tiles(self) -> List[Tuple[int, int]]:
        return [(m, n) for m in range(self.mt) for n in range(self.nt)
                if self.tile_exists(m, n)
                and self.owner_of(m, n) == self.myrank]

    def distribute_devices(self, context_or_spaces) -> "TiledMatrix":
        """Pin local tiles block-cyclically over the process's accelerator
        memory spaces (the intra-rank analog of rank_of: owner-computes
        over the device mesh; reference: data-affinity device selection,
        device.c:79-140).  Accepts a Context or an explicit list of
        memory-space indices."""
        spaces = context_or_spaces
        if hasattr(spaces, "device_registry"):
            spaces = [d.space
                      for d in spaces.device_registry.accelerators]
        spaces = list(spaces)
        if not spaces:
            return self
        for (m, n) in [(m, n) for m in range(self.mt)
                       for n in range(self.nt) if self.tile_exists(m, n)
                       and self.rank_of(m, n) == self.myrank]:
            self.data_of(m, n).preferred_device = \
                spaces[(m * self.nt + n) % len(spaces)]
        return self


class Grid2DCyclic:
    """PxQ process grid with kp/kq repetition (reference: grid_2Dcyclic.c)."""

    def __init__(self, rank: int, P: int, Q: int, kp: int = 1, kq: int = 1,
                 ip: int = 0, jq: int = 0):
        self.rank, self.P, self.Q = rank, P, Q
        self.kp, self.kq = kp, kq
        self.ip, self.jq = ip, jq      # origin offsets
        self.rrank = rank // Q
        self.crank = rank % Q

    def rank_of(self, m: int, n: int) -> int:
        p = ((m // self.kp) + self.ip) % self.P
        q = ((n // self.kq) + self.jq) % self.Q
        return p * self.Q + q


class TwoDimBlockCyclic(TiledMatrix):
    """ScaLAPACK 2D block-cyclic distribution
    (reference: two_dim_rectangle_cyclic.{c,h})."""

    def __init__(self, mb: int, nb: int, lm: int, ln: int,
                 nodes: int = 1, myrank: int = 0, P: int = 1, Q: int = -1,
                 kp: int = 1, kq: int = 1, dtype: Any = torch.float32,
                 name: str = "A"):
        super().__init__(mb, nb, lm, ln, dtype=dtype, nodes=nodes,
                         myrank=myrank, name=name)
        if Q == -1:
            Q = nodes // P
        if P * Q != nodes:
            raise ValueError(f"grid {P}x{Q} != {nodes} nodes")
        self.grid = Grid2DCyclic(myrank, P, Q, kp, kq)

    def rank_of(self, m: int, n: int = 0) -> int:
        return self.grid.rank_of(m, n)

    def vpid_of(self, m: int, n: int = 0) -> int:
        return 0


class KCyclicView(DataCollection):
    """Pseudo k-cyclic reordered VIEW of a plain block-cyclic matrix:
    shares the origin's storage, permutes the ACCESS ORDER (reference:
    parsec_matrix_block_cyclic_kview + kview_compute_m/n,
    two_dim_rectangle_cyclic.c:425-463).  This is not a copy and not the
    same order as a physically k-cyclic distribution — tile (m, n) of the
    view resolves to tile (pm(m), pn(n)) of the origin."""

    def __init__(self, origin: TwoDimBlockCyclic, kp: int, kq: int,
                 name: Optional[str] = None):
        if origin.grid.kp != 1 or origin.grid.kq != 1:
            # reference asserts krows == kcols == 1 on the origin
            raise ValueError("kview origin must be plain cyclic (kp=kq=1)")
        super().__init__(nodes=origin.nodes, myrank=origin.myrank,
                         name=name or (origin.name + "_kview"))
        self.origin = origin
        self.kp, self.kq = kp, kq
        # mirror the geometry so JDF globals (dA->super.mt) read through
        self.mb, self.nb = origin.mb, origin.nb
        self.lm, self.ln = origin.lm, origin.ln
        self.mt, self.nt = origin.mt, origin.nt
        self.dtype = origin.dtype

    def _pm(self, m: int) -> int:
        """kview_compute_m (two_dim_rectangle_cyclic.c:441-451)."""
        p, ps, mt = self.origin.grid.P, self.kp, self.mt
        while True:
            m = m - m % (p * ps) + (m % ps) * p + (m // ps) % p
            if m < mt:
                return m

    def _pn(self, n: int) -> int:
        """kview_compute_n (two_dim_rectangle_cyclic.c:453-463)."""
        q, qs, nt = self.origin.grid.Q, self.kq, self.nt
        while True:
            n = n - n % (q * qs) + (n % qs) * q + (n // qs) % q
            if n < nt:
                return n

    def data_key(self, m: int, n: int = 0):
        return self.origin.data_key(self._pm(m), self._pn(n))

    def rank_of(self, m: int, n: int = 0) -> int:
        return self.origin.rank_of(self._pm(m), self._pn(n))

    def vpid_of(self, m: int, n: int = 0) -> int:
        return self.origin.vpid_of(self._pm(m), self._pn(n))

    def data_of(self, m: int, n: int = 0) -> Data:
        return self.origin.data_of(self._pm(m), self._pn(n))

    def tile_exists(self, m: int, n: int = 0) -> bool:
        return self.origin.tile_exists(self._pm(m), self._pn(n))

    def key_to_indices(self, key):
        # keys are origin keys (shared storage); the inverse permutation
        # is not needed to address them
        return self.origin.key_to_indices(key)


def block_cyclic_kview(origin: TwoDimBlockCyclic, kp: int, kq: int,
                       name: Optional[str] = None) -> KCyclicView:
    """parsec_matrix_block_cyclic_kview equivalent."""
    return KCyclicView(origin, kp, kq, name=name)


class SymTwoDimBlockCyclic(TwoDimBlockCyclic):
    """Symmetric matrix storing one triangle only
    (reference: sym_two_dim_rectangle_cyclic.c)."""

    LOWER, UPPER = 0, 1

    def __init__(self, *args, uplo: int = LOWER, **kw):
        super().__init__(*args, **kw)
        self.uplo = uplo

    def tile_exists(self, m: int, n: int = 0) -> bool:
        if not super().tile_exists(m, n):
            return False
        return n <= m if self.uplo == self.LOWER else m <= n

    def _check(self, m: int, n: int) -> None:
        if self.uplo == self.LOWER and n > m:
            raise KeyError(f"{self.name}({m},{n}) not stored (lower)")
        if self.uplo == self.UPPER and m > n:
            raise KeyError(f"{self.name}({m},{n}) not stored (upper)")

    def rank_of(self, m: int, n: int = 0) -> int:
        self._check(m, n)
        return super().rank_of(m, n)

    def data_of(self, m: int, n: int = 0) -> Data:
        self._check(m, n)
        return super().data_of(m, n)


class BandTwoDimBlockCyclic(TwoDimBlockCyclic):
    """Band storage: only tiles within ``band_km`` of the diagonal exist
    (reference: two_dim_rectangle_cyclic_band.c /
    sym_two_dim_rectangle_cyclic_band.c — the *_band variants store the
    band of a (symmetric) matrix; out-of-band tiles are not stored and
    must not be addressed)."""

    LOWER = SymTwoDimBlockCyclic.LOWER
    UPPER = SymTwoDimBlockCyclic.UPPER

    def __init__(self, *args, band_km: int = 1, uplo: Optional[int] = None,
                 **kw):
        super().__init__(*args, **kw)
        self.band_km = band_km          # tiles kept each side of diagonal
        self.uplo = uplo                # None=full band, LOWER, or UPPER

    def tile_exists(self, m: int, n: int = 0) -> bool:
        if not super().tile_exists(m, n):
            return False
        d = m - n
        if self.uplo == self.LOWER and d < 0:   # below-diagonal only
            return False
        if self.uplo == self.UPPER and d > 0:
            return False
        return abs(d) <= self.band_km

    def _check_band(self, m: int, n: int) -> None:
        if not self.tile_exists(m, n):
            raise KeyError(f"{self.name}({m},{n}) outside the stored band")

    def rank_of(self, m: int, n: int = 0) -> int:
        self._check_band(m, n)
        return super().rank_of(m, n)

    def data_of(self, m: int, n: int = 0) -> Data:
        self._check_band(m, n)
        return super().data_of(m, n)


class TwoDimTabular(TiledMatrix):
    """Arbitrary tile->rank table (reference: two_dim_tabular.c)."""

    def __init__(self, mb: int, nb: int, lm: int, ln: int,
                 table: Sequence[int], nodes: int = 1, myrank: int = 0,
                 dtype: Any = torch.float32, name: str = "T"):
        super().__init__(mb, nb, lm, ln, dtype=dtype, nodes=nodes,
                         myrank=myrank, name=name)
        if len(table) != self.mt * self.nt:
            raise ValueError("table must have one rank per tile")
        self.table = list(table)

    def rank_of(self, m: int, n: int = 0) -> int:
        return self.table[self.data_key(m, n)]


class VectorTwoDimCyclic(TiledMatrix):
    """1D cyclic vector of tiles (reference: vector_two_dim_cyclic.c).

    Payloads are 1D; from_array/to_array work on 1D arrays of length lm.
    """

    def __init__(self, mb: int, lm: int, nodes: int = 1, myrank: int = 0,
                 dtype: Any = torch.float32, name: str = "V"):
        super().__init__(mb, 1, lm, 1, dtype=dtype, nodes=nodes,
                         myrank=myrank, name=name)

    def rank_of(self, m: int, n: int = 0) -> int:
        return m % self.nodes

    def tile_shape(self, m: int, n: int = 0) -> Tuple[int, ...]:
        """Vector payloads are 1D."""
        return (min(self.mb, self.lm - m * self.mb),)

    def from_array(self, a: Any) -> "VectorTwoDimCyclic":
        a = to_host(a)
        if tuple(a.shape) != (self.lm,):
            raise ValueError(f"expected ({self.lm},), got {tuple(a.shape)}")
        if a.dtype != self.dtype:
            a = a.to(self.dtype)
        with self._lock:
            if self._tiles:
                raise ValueError("from_array must precede tile access")
            self._backing = a
        return self

    def to_array(self) -> torch.Tensor:
        if self.nodes != 1:
            raise ValueError("to_array is single-rank only")
        if self._backing is not None:
            self._sync_backing()
            return self._backing
        out = torch.zeros(self.lm, dtype=self.dtype)
        for (m, _n), d in list(self._tiles.items()):
            c = d.pull_to_host()
            tm = min(self.mb, self.lm - m * self.mb)
            out[m * self.mb:m * self.mb + tm] = to_host(c.payload)[:tm]
        return out

    def _tile_view(self, m: int, n: int = 0) -> torch.Tensor:
        tm = min(self.mb, self.lm - m * self.mb)
        return self._backing[m * self.mb:m * self.mb + tm]
