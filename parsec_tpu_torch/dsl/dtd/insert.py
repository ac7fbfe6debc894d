"""Dynamic task discovery: the insert_task programming model.

Rebuild of the reference's DTD interface (reference:
parsec/interfaces/dtd/insert_function.{c,h} — ``parsec_dtd_insert_task``
varargs API :3488, task creation :3220, last-writer dependency inference
``set_dependencies_for_function`` :2128, tile wrappers ``parsec_dtd_tile_of``
:1285, window throttling :131-141/:604, and the RAW/WAR/WAW successor
ordering of overlap_strategies.c:138): the application inserts tasks one by
one; the runtime discovers the DAG from how tasks touch *tiles* — for each
tile it tracks the last writer and the readers since, so

    RAW  — a reader depends on the last writer,
    WAR  — a writer depends on every reader since the last writer,
    WAW  — a writer depends on the previous writer (transitively via
           its readers when there are any).

Tasks whose dependencies are already satisfied schedule immediately; the
rest wake through the dynamic-release hook as predecessors complete.
Insertion throttles on a sliding window (reference: dtd_window_size) so a
fast producer cannot flood memory with pending tasks.

Device notes: ``device="cuda"`` (or ``"gpu"``) insertions run through
the CUDA device module exactly like PTG device bodies (reference:
parsec_dtd_gpu_task_submit -> parsec_cuda_kernel_scheduler,
insert_function.c:2359-2399): a body function's ``.grouped`` form fuses a
wave into one launch and its keyword-only ``donate`` lets the module write
the tile in place; tiles stay device-resident between tasks and flush home
on ``data_flush_all``.

The port's copy of the JAX package's dsl/dtd/insert.py.  Its deliberate
differences:

* payloads are torch tensors: shadow and ``tile_new`` buffers, SCRATCH
  temporaries and the CPU hook's write-back are tensors, and the wire
  carries them through ``CommEngine.pack`` (bf16 as raw 16-bit words);
* ``device="cuda"``/``"gpu"`` builds a ``CudaKernel``; the JAX package's
  ``"tpu"``/``"xla"`` raise ``ValueError`` instead of being remapped;
* the send snapshot: ``_wire_msg`` copies a tile home and freezes it (a
  packed copy, or the clone a rendezvous region serves) at encode time.
  It runs inside the producer's ``dynamic_release`` before its successors
  are released, or on the inserting thread for a producer that is already
  done, and the copy-down is synchronous on the launch stream
  (devices/cuda.py, "Ordering"), so no in-place successor can have
  written the tile yet;
* a region lane's writer writes back only its own extent (the JAX
  package writes the whole tile back).  The insert-stream skip agreement
  of the recovery plane (``_note_insert``, ``_ghost_insert``,
  ``dtd_arm_skip``, ``dtd_skip_report``, ``dtd_capture_seeds``,
  ``dtd_taint_stale``) is the JAX package's, and a pool with region
  lanes still latches unskippable (``_skip_note``) as there; a skip
  holder's seed is a host tensor that lands as the tile's host copy.
  The lane events reach the causal tracer and the flight recorder's
  ``dtd`` class alike.
"""

from __future__ import annotations

import inspect
import itertools
import numbers
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from parsec_tpu_torch.core import scheduling
from parsec_tpu_torch.core.errors import PeerFailedError
from parsec_tpu_torch.core.task import (Flow, HookReturn, Task,
                                        TaskClass, normalize_body_outputs)
from parsec_tpu_torch.core.taskpool import Taskpool
from parsec_tpu_torch.data.collection import DataCollection, DataRef
from parsec_tpu_torch.data.data import (ACCESS_READ, ACCESS_RW,
                                        ACCESS_WRITE, Data, materialize,
                                        new_data, to_host, torch_dtype)
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import warning


def _chain_val(arr) -> Optional[float]:
    """First element of a payload as a plain float — the 'chain value'
    the dtd_lane trace events carry so an ordering race's stale read is
    visible in the merged timeline.  On a card tensor this is a
    device-to-host synchronisation: only a traced run pays it
    (``_trace_lane`` calls it past the tracer gate)."""
    try:
        t = materialize(arr)
        if not isinstance(t, torch.Tensor):
            t = to_host(t)
        flat = t.reshape(-1)
        return float(flat[0]) if flat.numel() else None
    except (TypeError, ValueError, RuntimeError):
        return None


def _apply_payload(datum: Data, arr: torch.Tensor,
                   slices: Optional[tuple] = None) -> None:
    """Land a network payload as the datum's new authoritative host
    value (the coherency transition lives in Data.overwrite_host).
    ``slices`` applies a region-lane payload into its sub-tile extent
    only (reference: per-region datatypes on the wire,
    insert_function.h:60-78), in place, so concurrent disjoint-lane
    values survive.  (The JAX package writes the whole tile back from a
    copy taken before: a local writer of another lane that writes its
    extent in between loses its update.)"""
    if slices is None:
        datum.overwrite_host(arr)
        return
    host = to_host(datum.pull_to_host().payload)
    host[tuple(slices)] = to_host(arr)
    datum.overwrite_host(host)     # the coherency transition

params.register("dtd_window_size", 2048,
                "max in-flight DTD tasks before insert_task throttles")
params.register("dtd_threshold_size", 1024,
                "resume insertion below this many in-flight tasks")


# -- argument modes (reference: insert_function.h:60-78 flags) --------------

class _Mode:
    def __init__(self, name: str, access: int, base: "_Mode" = None,
                 flags: frozenset = frozenset(), region: Any = None):
        self.name = name
        self.access = access
        self.base = base or self
        self.flags = flags
        self.region = region

    def __or__(self, other):
        """Compose with a modifier, mirroring the reference's OR'd flag
        words: ``INOUT | PUSHOUT``, ``INPUT | REGION_L``
        (reference: insert_function.h:60-78 PUSHOUT/PULLIN + region
        masks)."""
        if isinstance(other, _Flag):
            return _Mode(f"{self.name}|{other.name}", self.access,
                         base=self.base, flags=self.flags | {other.name},
                         region=self.region)
        if isinstance(other, Region):
            return _Mode(f"{self.name}|R({other.rid})", self.access,
                         base=self.base, flags=self.flags,
                         region=other)
        return NotImplemented

    def __repr__(self):
        return self.name


class _Flag:
    """Data-movement modifier OR'd onto an access mode."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name


class Region:
    """Partial-tile dependency lane (reference: the region masks of
    insert_function.h — e.g. upper/lower/diagonal sub-tile regions).
    Accesses to DISTINCT regions of one tile do not conflict; a
    region-free access conflicts with every lane.

    ``slices`` (a tuple of python slices, e.g. ``(slice(0, 8),)`` for
    the tile's top half) declares the lane's byte extent.  With an
    extent, a remote lane write ships only the lane's sub-array and the
    receiver applies it read-modify-write, so concurrent writers of
    disjoint lanes on different ranks cannot
    clobber each other (the reference's per-region MPI datatypes).
    Ordering-only regions (no slices) also work across ranks: the lane
    id + version keep per-lane ORDERING on the wire, but each payload
    ships whole-tile (there is no extent to cut), so lanes of one tile
    written concurrently on DIFFERENT ranks merge at tile granularity —
    declare ``slices`` when byte-exact disjoint-lane merging matters
    (the reference's region masks always carry an MPI datatype,
    insert_function.h:60-78, which is exactly this extent)."""

    def __init__(self, rid: Any, slices: Optional[tuple] = None):
        self.rid = rid
        self.slices = tuple(slices) if slices is not None else None


INPUT = _Mode("INPUT", ACCESS_READ)
OUTPUT = _Mode("OUTPUT", ACCESS_WRITE)
INOUT = _Mode("INOUT", ACCESS_RW)
VALUE = _Mode("VALUE", 0)        # pass-by-value scalar
SCRATCH = _Mode("SCRATCH", 0)    # per-task temporary buffer
AFFINITY = _Mode("AFFINITY", 0)  # placement hint marker (modifier)
DONT_TRACK = _Mode("DONT_TRACK", 0)  # access data without dep tracking

#: force the produced tile home (host-authoritative) at task completion
#: instead of staying device/producer-resident until a flush
PUSHOUT = _Flag("PUSHOUT")
#: eager-fetch hint: the executing site pulls inputs at stage-in anyway
#: (always-correct on-demand movement), so PULLIN is accepted for API
#: parity and is satisfied by construction
PULLIN = _Flag("PULLIN")


def _is_device(device: str) -> bool:
    """True for a device incarnation of the CUDA module (``"cuda"`` or
    ``"gpu"``), False for a CPU one.  The JAX package's ``"tpu"`` and
    ``"xla"`` name devices this port has not: they raise rather than
    being remapped in silence."""
    if device in ("cuda", "gpu"):
        return True
    if device in ("tpu", "xla"):
        raise ValueError(
            f"device={device!r} names the JAX package's XLA module; the "
            "port's device incarnations are 'cuda' (or 'gpu')")
    return False


def _norm(args):
    """Normalize each (value, mode) arg to (value, base_mode, flags,
    region): composed modes (``INOUT | PUSHOUT | Region(...)``) reduce to
    their base identity for the mode checks below."""
    out = []
    for value, mode in args:
        if not isinstance(mode, _Mode):
            raise TypeError(f"unsupported arg mode {mode!r}")
        out.append((value, mode.base, mode.flags, mode.region))
    return out


class DTDTile:
    """Dep-tracking state of one datum (reference: parsec_dtd_tile_t —
    last_user / last_writer tracking; ``version`` counts writers in the
    insertion stream, identically on every rank; ``wire_key`` names the
    tile on the wire)."""

    __slots__ = ("data", "last_writer", "readers", "home_rank", "version",
                 "wire_key", "v0_sent", "lanes", "applied_ver")

    def __init__(self, data: Data, home_rank: int = 0, wire_key: Any = None):
        self.data = data
        self.last_writer: Optional["_DTDState"] = None
        self.readers: List["_DTDState"] = []
        self.home_rank = home_rank
        self.version = 0
        self.wire_key = wire_key
        #: ranks already sent the pristine (version-0) home payload
        self.v0_sent: set = set()
        #: region dependency lanes (reference: region masks) — created
        #: lazily on the first region-flagged access; None = the tile is
        #: tracked whole (the fast default path)
        self.lanes: Optional[Dict[Any, "_Lane"]] = None
        #: highest WHOLE-COVERING version that actually LANDED on the
        #: datum — whole-tile or extent-less-lane payload applies, and
        #: completed local writes.  Distinct from ``version`` (bumped at
        #: INSERT time): whole-covering applies on disjoint lanes take
        #: no mutual dep edges, so an older payload (the v0 pristine
        #: pull, a delayed extent-less lane frame) can physically arrive
        #: after a newer value landed — and must not clobber it (the r6
        #: region-lane stale-read race, reproduced with
        #: ``delay_frame=tag:DTD,pm='ver': 0``)
        self.applied_ver = 0


class _Lane:
    """Per-region dependency history of one tile.  ``version`` is the
    tile-version of the lane's last write — what names that write's
    payload on the wire (distributed lanes)."""

    __slots__ = ("last_writer", "readers", "version")

    def __init__(self, last_writer=None, readers=None, version: int = 0):
        self.last_writer = last_writer
        self.readers: List["_DTDState"] = readers if readers is not None \
            else []
        self.version = version


class _DTDState:
    """Runtime dep bookkeeping of one inserted task.

    ``is_recv`` marks a *delivery surrogate*: the local stand-in for one
    (tile, version) produced by a task on another rank (reference: remote
    writers tracked as fake tasks, insert_function.c:3014-3163).  A
    surrogate joins the dep graph like a writer, but is only counted and
    scheduled once a local consumer *needs* that version; its body applies
    the network payload to the tile datum."""

    __slots__ = ("task", "remaining", "successors", "done", "affinity",
                 "rank", "is_recv", "needed", "tile", "version", "payload",
                 "remote_sends", "pushout", "region", "local_writes",
                 "insert_pos", "extents")

    def __init__(self, task: Optional[Task], rank: int = 0):
        self.task = task
        self.remaining = 0
        self.successors: List["_DTDState"] = []
        self.done = False
        self.affinity = None
        self.rank = rank
        self.is_recv = False
        self.needed = False
        self.pushout: List["DTDTile"] = []
        self.tile: Optional[DTDTile] = None
        self.version = 0
        self.payload: Optional[torch.Tensor] = None
        #: region-lane id of a surrogate's write (None = whole tile):
        #: selects the slice extent its payload applies into
        self.region: Any = None
        #: (dst_rank, tile, version, lane) payloads to ship at completion
        self.remote_sends: set = set()
        #: (tile, version, lane) writes this task performs locally —
        #: dynamic_release advances each tile's applied_ver from them
        #: once the body has actually run
        self.local_writes: List[Tuple["DTDTile", int, Any]] = []
        #: SPMD insert-stream position (only stamped with the recovery
        #: lineage plane armed) — the unit of the cross-rank skip
        #: agreement: dynamic_release records it completed, and a
        #: restart's tid-gated replay filter skips agreed positions
        self.insert_pos: Optional[int] = None
        #: written flow name -> the byte extent of its region lane, for
        #: lane writes with one: the CPU hook writes back only that
        #: extent (None: whole tiles)
        self.extents: Optional[Dict[str, tuple]] = None


_seq = itertools.count()


class DTDTaskpool(Taskpool):
    """Taskpool populated by ``insert_task`` calls
    (reference: parsec_dtd_taskpool_new, insert_function.c:1412)."""

    def __init__(self, name: str = "dtd"):
        super().__init__(name=name)
        self._dep_lock = threading.Lock()
        self._tiles: Dict[Any, DTDTile] = {}   # guarded-by: _dep_lock, _window
        #: guarded-by: _dep_lock, _window
        self._tiles_by_wire: Dict[Any, DTDTile] = {}
        #: region-lane byte extents, rid -> tuple of slices (populated
        #: identically on every rank by the SPMD insert stream — the
        #: wire carries only the rid)
        self._region_slices: Dict[Any, tuple] = {}
        #: tiles already warned about concurrent extent-less lane
        #: writers on different ranks (one warning per tile)
        self._extless_warned: set = set()
        #: serializes payload read-modify-write spans: two unordered
        #: disjoint-lane appliers interleaving pull/overwrite would lose
        #: one lane's bytes (whole-tile overwrite restores stale data)
        self._apply_lock = threading.Lock()
        self._dc_ids: Dict[int, int] = {}
        self._classes: Dict[Any, TaskClass] = {}
        self._inflight = 0                  # guarded-by: _dep_lock, _window
        self._window = threading.Condition(self._dep_lock)
        self._finished = False
        self.window_size = params.get("dtd_window_size", 2048)
        self.threshold = params.get("dtd_threshold_size", 1024)
        #: inserts that found the window full and blocked (the port's
        #: counter: the JAX package keeps none)
        self.window_stalls = 0
        # distributed state (single-rank pools never touch it)
        self.myrank = 0
        self.nranks = 1
        self._new_seq = itertools.count()
        #: (wire_key, version) -> surrogate awaiting that payload
        #: (guarded-by: _dep_lock, _window)
        self._expected: Dict[Any, _DTDState] = {}
        #: early-arrived payloads nobody expects yet
        #: (guarded-by: _dep_lock, _window)
        self._received: Dict[Any, torch.Tensor] = {}
        #: inbound tile-flush payloads queued until the local pool drains
        #: (guarded-by: _dep_lock, _window)
        self._flush_queue: List[Tuple[Any, torch.Tensor]] = []
        self._drained = False
        self._recv_tc: Optional[TaskClass] = None
        # -- insert-stream lineage (core/recovery.py DTD skip agreement)
        # All of it gates on the shared lineage plane: with
        # PARSEC_MCA_RECOVERY_ENABLE=0 the pool's ``_lineage`` stays
        # None and every hook below is one attribute check.
        #: SPMD insert-stream position counter — bumped on EVERY
        #: insert_task call (local and remote placements alike), so it
        #: is identical on every rank by construction
        #: (guarded-by: _dep_lock, _window)
        self._insert_pos = 0
        #: stream positions placed on THIS rank / completed here
        #: (dynamic_release records completion post-body)
        #: (guarded-by: _dep_lock, _window)
        self._pos_local: set = set()
        self._pos_done: set = set()     # guarded-by: _dep_lock, _window
        #: (pos, wire_key) per tracked write, in stream order — the
        #: per-tile write ladder the skip-agreement coordinator cuts
        #: (guarded-by: _dep_lock, _window)
        self._wlog: List[Tuple[int, Any]] = []
        #: latched reason this pool can never skip (region lanes,
        #: tile_new wire keys, insert-log overflow) — the skip report
        #: then votes full instead of planning from partial evidence
        self._skip_note: Optional[str] = None
        #: a skip replay already ran this generation: a second death
        #: takes the full replay (the replayed wlog's placement went
        #: through the translation and is not holder-designation safe)
        self._skip_done = False
        #: armed by the RecoveryCoordinator between recovery_reset and
        #: the replay: {"prefix", "holders", "seeds", "vcut", "done"} —
        #: insert_task ghost-tracks positions below the agreed prefix
        #: and the finalize installs the holder writers/seeds
        self._dtd_skip: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------
    def attach(self, context, termdet) -> None:
        super().attach(context, termdet)
        # hold the pool open until wait(): counters transiting 0 between
        # insertions must not terminate it (reference: DTD pools keep a
        # runtime action until parsec_dtd_taskpool_wait)
        termdet.taskpool_addto_runtime_actions(self, 1)
        self.myrank = context.rank
        self.nranks = context.nranks
        if self.nranks > 1 and context.comm is not None:
            context.comm.dtd_drain_backlog(self)
            # flush home AT TERMINATION (before _taskpool_terminated
            # lets the quiescence ring see this rank idle): a flush
            # sent from wait() after local termination races global
            # quiescence — the home rank's ring could converge in the
            # completion→flush window and hand the application
            # pre-flush bytes (deterministically reproduced by the
            # kill-dtd-minimal chain's 100 ms keyed bodies)
            self.on_complete(self._flush_on_complete)

    def _flush_on_complete(self, tp) -> None:
        if not self.cancelled and self._finished:
            self._flush_home()

    def recovery_reset(self) -> None:
        """Recovery restart (core/recovery.py): drop every lane/window/
        surrogate structure of the torn generation on top of the base
        dep/repo reset.  The pool's ``recovery_replay`` then re-inserts
        the lost task stream against restored tiles — re-created
        ``tile_of`` wrappers resolve their home through the translated
        owner, so a single survivor replays the whole chain locally.

        Insert-stream lineage: with the recovery lineage plane armed,
        every insert stamps its SPMD stream position
        (``_DTDState.insert_pos``), ``dynamic_release`` records the
        completed positions, and ``_wlog`` keeps the per-tile write
        ladder — the evidence of the cross-rank SKIP AGREEMENT
        (core/recovery.py ``_plan_dtd_skip``): survivors agree on the
        largest common skippable prefix consistent with every rank's
        materializable ``(tile, version)`` cut, and the replay's
        tid-gated filter ghost-tracks the skipped prefix (versions and
        ordering advance, bodies do not run) while designated HOLDER
        ranks serve the cut values in place of the skipped producers'
        deliveries.  Any rank that cannot honor the prefix votes full
        and the mode-agreement round falls the whole gang back
        symmetrically — SPMD insert streams provably never diverge."""
        super().recovery_reset()
        if not self._finished:
            # the attach-time wait() hold was zeroed with the counters;
            # re-take it so a wait() that has not happened yet finds
            # its decrement balanced
            self.termdet.taskpool_addto_runtime_actions(self, 1)
        with self._dep_lock:
            self._tiles.clear()
            self._tiles_by_wire.clear()
            self._expected.clear()
            self._received.clear()
            self._flush_queue.clear()
            self._inflight = 0
            self._drained = False
            # insert-stream lineage restarts with the new generation
            # (the pre-kill evidence was consumed by the skip plan);
            # _skip_note/_skip_done latches survive — a structurally
            # unskippable pool stays unskippable across restarts
            self._insert_pos = 0
            self._pos_local.clear()
            self._pos_done.clear()
            self._wlog = []
            self._dtd_skip = None
            self._window.notify_all()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Drain: all inserted tasks complete
        (reference: parsec_dtd_taskpool_wait, insert_function.c:691).
        Raises the first task error instead of hanging on a failed DAG."""
        if self.context is None:
            raise RuntimeError("taskpool not attached to a context")
        self.context.start()
        if not self._finished:
            self._finished = True
            self.termdet.taskpool_addto_runtime_actions(self, -1)
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.wait_local(0.1):
            self._raise_context_error()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{self} wait timed out")
        # a failed task also DRAINS the pool (complete_execution runs on
        # the failure path), so the loop above can exit without ever
        # polling: surface the error instead of reporting success
        self._raise_context_error()
        if self.nranks > 1 and self.context.comm is not None:
            self._flush_home()

    def _flush_home(self) -> None:
        """Send each tile whose final writer ran here back to its owner
        rank, and apply queued inbound flushes (the distributed epilogue
        of parsec_dtd_data_flush_all: every tile's home datum holds the
        final value once all ranks pass Context.wait quiescence).
        Idempotent per generation: fired from the termination callback
        (so the outgoing sends are Safra-counted BEFORE the quiescence
        ring can see this rank idle) and again from ``wait()`` as a
        safety net; the second call is a no-op."""
        outgoing: List[Tuple[DTDTile, Any, int]] = []
        with self._dep_lock:
            if self._drained:
                return
            self._drained = True
            queued, self._flush_queue = self._flush_queue, []
            for tile in self._tiles.values():
                if tile.home_rank == self.myrank:
                    continue
                if tile.lanes is None:
                    lw = tile.last_writer
                    if lw is not None and not lw.is_recv:
                        outgoing.append((tile, None, tile.version))
                else:
                    # per-lane final writers may live on DIFFERENT
                    # ranks: each rank flushes home only the lanes it
                    # wrote last, as slice payloads
                    for lrid, lane in tile.lanes.items():
                        lw = lane.last_writer
                        if lw is not None and not lw.is_recv:
                            outgoing.append((tile, lrid, lane.version))
        for wire, arr, lane, ver in queued:
            tile = self._tiles_by_wire.get(wire)
            if tile is not None:
                self._apply_flush(tile, arr, lane, ver)
        for tile, lane, ver in outgoing:
            self._dtd_send_contained(
                tile.home_rank, self._wire_msg("flush", tile, ver, lane))

    def _dtd_send_contained(self, dst: int, msg: dict) -> None:
        """DTD send with recovery-aware containment: a task body that
        spans the instant a peer is DECLARED dead completes into a
        send the dead-peer guard rejects — that failure belongs to the
        pool (and is swallowed outright when a recovery restart
        already owns this pool's fate), never to the calling worker
        thread."""
        comm = self.context.comm
        try:
            comm.dtd_send(dst, msg)
        except PeerFailedError as exc:
            comm._contain_pool(self, exc)

    def _merge_payload(self, tile: DTDTile, arr: torch.Tensor,
                       slices: Optional[tuple],
                       preserve: List[tuple]) -> None:
        """The one payload-landing primitive: write ``arr`` (into
        ``slices`` if given, else whole-tile) while restoring
        ``preserve`` extents from the current value.  The whole
        read-modify-write span holds _apply_lock — two unordered
        disjoint-lane appliers interleaving pull/overwrite would
        otherwise lose one lane's bytes."""
        with self._apply_lock:
            self._merge_payload_locked(tile, arr, slices, preserve)

    def _merge_payload_locked(self, tile: DTDTile, arr: torch.Tensor,
                              slices: Optional[tuple],
                              preserve: List[tuple]) -> None:
        if slices is not None:
            _apply_payload(tile.data, arr, slices)
            return
        if not preserve:
            _apply_payload(tile.data, arr)
            return
        copy = tile.data.pull_to_host()
        cur = to_host(copy.payload)
        new = to_host(arr).reshape(cur.shape).clone()
        for sl in preserve:
            new[tuple(sl)] = cur[tuple(sl)]
        tile.data.overwrite_host(new)

    def _apply_flush(self, tile: DTDTile, arr: torch.Tensor, lane: Any,
                     ver: int) -> None:
        """Version-aware flush application: a flush carries the sender's
        final write version for its (lane) extent, and must not clobber
        extents this rank knows to be NEWER — e.g. a whole-tile write on
        rank A flushed home after rank B's later lane write (the lane's
        own flush, or the home rank's local value, carries the newer
        bytes)."""
        self._trace_lane("flush_apply", tile.wire_key, lane, ver,
                         arr=arr)
        if lane is not None:
            l = tile.lanes.get(lane) if tile.lanes else None
            if l is not None and l.version > ver:
                return          # a newer write to this lane supersedes
            sl = self._region_slices.get(lane)
            if sl is not None:
                self._merge_payload(tile, arr, sl, [])
                return
            # extent-less lane: the payload is whole-tile — fall through
            # to the whole-tile preserve logic so a NEWER sliced lane's
            # bytes survive this older snapshot of their extent
        preserve = []
        if tile.lanes:
            for lrid, l in tile.lanes.items():
                if lrid is not None and lrid != lane and l.version > ver:
                    sl = self._region_slices.get(lrid)
                    if sl is not None:
                        preserve.append(sl)
        with self._apply_lock:
            # same WHOLE-COVERING landing-order guard as _apply_data: a
            # flush-home payload delayed past a newer landing (an
            # extent-less lane whose tile.lanes entry a later whole-tile
            # write wiped slips the supersede check above, and the
            # preserve list only protects SLICED lanes) must be dropped
            # wholesale, not merged
            if ver < tile.applied_ver:
                self._trace_lane("flush_stale", tile.wire_key, lane, ver)
                return
            tile.applied_ver = ver
            self._merge_payload_locked(tile, arr, None, preserve)

    def _raise_context_error(self) -> None:
        errs = getattr(self.context, "_errors", None)
        if errs:
            exc, task = errs[0]
            raise RuntimeError(f"task {task} failed") from exc

    def _trace_lane(self, op: str, wire, lane, ver: int,
                    arr=None) -> None:
        """Lane/surrogate observability (the causal tracer's dtd_lane
        events): every dep-tracking transition and payload application
        lands in the trace with its lane id and chain value (the
        payload's first element, extracted from ``arr`` only once the
        tracer gate passed — untraced runs pay a single None check), so
        a region-ordering race shows up as an out-of-order apply in ONE
        merged timeline instead of needing rerun roulette."""
        ctx = self.context
        if ctx is None:
            return
        tr = ctx._causal_tracer
        if tr is not None and "dtd" not in tr.classes:
            tr = None   # class-gated out, as the recorder below
        fr = ctx._flightrec
        if fr is not None and "dtd" not in fr.classes:
            fr = None   # class-gated out: no tensor read on its account
        if tr is None and fr is None:
            return
        val = _chain_val(arr) if arr is not None else None
        for sink in (tr, fr):
            if sink is not None:
                sink.dtd_event(op, wire, lane, ver, val)

    # -- tiles -------------------------------------------------------------
    def tile_of(self, dc: DataCollection, *indices) -> DTDTile:
        """Wrap a collection datum for dep tracking
        (reference: parsec_dtd_tile_of).  Non-local tiles (owned by
        another rank) get a *shadow* datum: a local buffer of the tile's
        shape that receives forwarded versions and hosts locally-placed
        writes until the flush home."""
        if self.context is None:
            # home/shadow resolution needs the pool's rank: before attach
            # it would silently classify every tile as local (myrank=0 /
            # nranks=1) and skip the surrogate protocol (ADVICE r2 low)
            raise RuntimeError(
                "attach the DTD pool to a context before tile_of")
        key = (id(dc), dc.data_key(*indices))
        # owner_of, not rank_of: after a recovery re-mapping the dead
        # rank's tiles are home on their adopting survivor
        home = dc.owner_of(*indices)
        with self._dep_lock:
            t = self._tiles.get(key)
            if t is None:
                # wire-stable collection id: first-use order is identical
                # on every rank (SPMD insertion), and distinct collections
                # sharing a name= must not collide on the wire
                dcid = self._dc_ids.get(id(dc))
                if dcid is None:
                    dcid = self._dc_ids[id(dc)] = len(self._dc_ids)
                wire = ("c", dcid, dc.data_key(*indices))
                if home == self.myrank:
                    datum = dc.data_of(*indices)
                else:
                    if not hasattr(dc, "tile_shape"):
                        raise TypeError(
                            f"{type(dc).__name__} lacks tile_shape(): "
                            "distributed DTD needs it to shape the "
                            "shadow buffer of a remote-owned tile")
                    shape = dc.tile_shape(*indices)
                    dtype = torch_dtype(getattr(dc, "dtype",
                                                torch.float32))
                    datum = new_data(torch.zeros(shape, dtype=dtype),
                                     key=("shadow",) + wire)
                t = DTDTile(datum, home_rank=home, wire_key=wire)
                self._tiles[key] = t
                self._tiles_by_wire[wire] = t
            return t

    def tile_new(self, shape: Tuple[int, ...], dtype: Any = torch.float32,
                 key: Any = None, home_rank: int = 0) -> DTDTile:
        """A fresh unowned tile (reference: parsec_dtd_tile_new).
        Distributed pools must call this identically on every rank (SPMD
        insertion); ``home_rank`` owns the final flushed value."""
        datum = new_data(torch.zeros(shape, dtype=torch_dtype(dtype)),
                         key=key)
        wire = ("n", next(self._new_seq))
        t = DTDTile(datum, home_rank=home_rank, wire_key=wire)
        with self._dep_lock:
            self._tiles[("new", id(datum))] = t
            self._tiles_by_wire[wire] = t
            if self._lineage is not None and self._skip_note is None:
                # _new_seq is not reset across a restart, so replayed
                # tile_new wires would not match the recorded ladder —
                # this pool's skip report votes full
                self._skip_note = "tile_new wire keys are not " \
                                  "replay-stable"
        return t

    def data_flush_all(self) -> None:
        """Push every tracked tile home to its host copy
        (reference: parsec_dtd_data_flush_all).  Pulls device copies to
        the LOCAL host; the cross-rank flush home to each tile's owner
        happens at ``wait()`` (_flush_home), once no writer can still be
        in flight — flushing a tile another rank is mid-writing would be
        a torn flush."""
        with self._dep_lock:
            tiles = list(self._tiles.values())
        for t in tiles:
            t.data.pull_to_host()

    # -- insert-stream skip agreement (core/recovery.py DTD minimal
    # replay).  Everything below gates on the recovery lineage plane
    # (``self._lineage``); disabled, none of it runs.
    def _note_insert(self, pos: int, nargs, rank: int) -> None:
        """Record one insert's write ladder + placement (lineage armed
        only): the skip-agreement coordinator cuts the per-tile write
        positions, and the frontier is the contiguous completed prefix
        of the LOCAL positions."""
        cap = self._lineage.cap
        with self._window:
            if len(self._wlog) >= cap:
                if self._skip_note is None:
                    # a truncated ladder cannot prove a cut sound
                    self._skip_note = "insert log overflow"
                return
            for value, mode, _f, _r in nargs:
                if mode in (OUTPUT, INOUT):
                    self._wlog.append((pos, self._as_tile_locked(value)))
            if rank == self.myrank:
                self._pos_local.add(pos)

    def _as_tile_locked(self, value) -> Any:
        """wire_key of a tile value with _dep_lock already held (the
        _window condition shares the lock, so _as_tile/tile_of would
        self-deadlock)."""
        if isinstance(value, DTDTile):
            return value.wire_key
        if isinstance(value, DataRef):
            key = (id(value.dc), value.dc.data_key(*value.indices))
            t = self._tiles.get(key)
            if t is not None:
                return t.wire_key
            dcid = self._dc_ids.get(id(value.dc))
            if dcid is None:
                dcid = self._dc_ids[id(value.dc)] = len(self._dc_ids)
            return ("c", dcid, value.dc.data_key(*value.indices))
        if isinstance(value, Data):
            return ("d", id(value))
        raise TypeError(f"cannot interpret {value!r} as a tile")

    def _ghost_insert(self, nargs) -> None:
        """Dep-tracking-only replay of one agreed-skippable insert: its
        writes advance tile versions through DONE pass-through
        surrogates (ordering numbering stays identical to the original
        stream on every rank) and nothing is counted, scheduled, or
        executed — the values of the skipped prefix are served by the
        designated holder ranks (``_dtd_skip_finalize_locked``)."""
        writes = [(self._as_tile(value),
                   region.rid if region is not None else None)
                  for value, mode, _f, region in nargs
                  if mode in (OUTPUT, INOUT)]
        with self._dep_lock:
            for tile, rid in writes:
                self._surrogate_write(tile, rid)

    def dtd_arm_skip(self, prefix: int, holders: Dict[Any, int],
                     seeds: Dict[Any, torch.Tensor],
                     vcut: Dict[Any, int]) -> None:
        """Arm the tid-gated replay filter (RecoveryCoordinator, after
        ``recovery_reset`` and before the replay callable runs)."""
        with self._dep_lock:
            self._dtd_skip = {"prefix": int(prefix),
                              "holders": dict(holders),
                              "seeds": dict(seeds),
                              "vcut": dict(vcut), "done": False}

    def _dtd_skip_finalize_locked(self) -> None:  # holds-lock: _dep_lock
        """Ghost prefix fully tracked: on each tile's designated HOLDER
        rank, replace the last ghost surrogate with a completed LOCAL
        writer over the seeded cut payload — local consumers read the
        datum directly, and the SPMD processing of a remote consumer's
        insert triggers the payload send exactly like a completed
        normal producer (``_insert_remote``'s ``lw.done`` path)."""
        sk = self._dtd_skip
        if sk is None or sk["done"]:
            return
        sk["done"] = True
        me = self.myrank
        for wire, holder in sk["holders"].items():
            tile = self._tiles_by_wire.get(wire)
            if tile is None:
                continue   # the replay stream never touched it
            vcut = sk["vcut"].get(wire, tile.version)
            if holder != me:
                # non-holders keep the done ghost surrogate; their
                # consumers revive it (_mark_needed) and the holder's
                # payload lands through the ordinary recv chain
                continue
            seed = sk["seeds"].get(wire)
            if seed is not None:
                tile.data.overwrite_host(to_host(seed))
            d = _DTDState(None, rank=me)
            d.done = True
            d.tile = tile
            d.version = vcut
            tile.last_writer = d
            tile.readers = []
            if tile.lanes:
                tile.lanes = {None: _Lane(d, version=vcut)}
            with self._apply_lock:
                if vcut > tile.applied_ver:
                    # the seeded bytes ARE the cut landing: an older
                    # stale payload must not clobber them
                    tile.applied_ver = vcut

    def dtd_skip_finish(self) -> None:
        """Replay stream done (RecoveryCoordinator): finalize (covers
        the all-skipped stream, where no post-prefix insert triggered
        it — the holder writers must still exist so ``_flush_home``
        ships the cut values home) and disarm.  A later death of this
        generation takes the full replay: the replayed ladder's
        placement went through the rank translation and is no longer
        holder-designation evidence."""
        with self._dep_lock:
            self._dtd_skip_finalize_locked()
            self._dtd_skip = None
            self._skip_done = True

    def dtd_skip_report(self) -> Dict[str, Any]:
        """This survivor's half of the skip agreement, computed AFTER
        the run_epoch fence and in-flight drain (the numbers are
        stable): either ``{"full": reason}`` — this rank votes full —
        or the insert-stream completion frontier plus the per-tile
        landed versions the coordinator cuts against.

        ``frontier`` = the largest K such that every LOCAL position
        < K completed; ``landed[wire]`` = the whole-covering version
        whose bytes this rank's datum actually holds
        (``DTDTile.applied_ver``) — the materializable cut evidence."""
        lin = self._lineage
        if lin is None or lin.overflow:
            return {"full": "evicted ring"}
        if self._skip_note is not None:
            return {"full": self._skip_note}
        if self._skip_done:
            return {"full": "skip already replayed this generation"}
        with self._window:
            frontier = self._insert_pos
            for p in sorted(self._pos_local):
                if p not in self._pos_done:
                    frontier = p
                    break
            landed = {t.wire_key: t.applied_ver
                      for t in self._tiles.values()}
            wlog = list(self._wlog)
        return {"frontier": frontier, "landed": landed, "writes": wlog}

    def dtd_capture_seeds(self, wires) -> Dict[Any, torch.Tensor]:
        """Host copies of the agreed cut values this rank holds —
        captured BEFORE recovery_reset discards the shadow datums (an
        adopted tile's cut bytes may live only in the old shadow).
        Raises KeyError/ValueError-free: an unpullable payload returns
        a partial map and the caller falls back."""
        out: Dict[Any, torch.Tensor] = {}
        with self._window:
            tiles = {w: self._tiles_by_wire.get(w) for w in wires}
        for wire, tile in tiles.items():
            if tile is None:
                continue
            copy = tile.data.pull_to_host()
            if copy is None or copy.payload is None:
                continue
            out[wire] = to_host(copy.payload).clone()
        return out

    def dtd_taint_stale(self, state: "_DTDState",
                        failed: bool = False) -> None:
        """Epoch-fence discard of a stale-generation body that RAN
        (core/scheduling.complete_execution): its in-place writes are
        LANDED bytes the skip report must see — advance applied_ver so
        the landed map can never claim an older version over mutated
        payloads (the DTD twin of the stale-body version taint).
        A body that FAILED may have mutated its tiles PARTWAY: those
        bytes match no version at all, so the pool latches unskippable
        instead of claiming the write landed.

        The position is completion evidence too: the landed map must
        never run AHEAD of the frontier.  A body straddling the fence
        (claimed pre-restart, completed post-fence) that advanced
        applied_ver without recording its position would leave NO rank
        holding the frontier's cut bytes — the agreement would cut
        prefix 0 and force a full replay on a fully-completed write."""
        if failed:
            if state.local_writes and self._skip_note is None:
                self._skip_note = "stale body failed mid-write"
            return
        self._advance_applied(state.local_writes)
        if self._lineage is not None and state.insert_pos is not None:
            with self._window:
                self._pos_done.add(state.insert_pos)

    def _advance_applied(self, local_writes) -> None:
        """A completed body's WHOLE-COVERING writes are LANDED values:
        advance each tile's applied_ver monotonically (sliced region
        lanes stay out — their extent never names the whole tile).
        One helper for both landing sites (dynamic_release and the
        stale-discard taint) so the landing-order guard and the
        skip-agreement landed map can never diverge."""
        for wtile, wver, wrid in local_writes:
            if wrid is None or wrid not in self._region_slices:
                with self._apply_lock:
                    if wver > wtile.applied_ver:
                        wtile.applied_ver = wver

    # -- task classes ------------------------------------------------------
    def _class_for(self, fn: Callable, modes: Tuple[_Mode, ...],
                   device: str) -> TaskClass:
        # Closure-free functions dedupe by code object, so the common
        # "insert a fresh lambda per iteration" pattern reuses one class
        # (and one jitted kernel) instead of registering one per insert.
        if getattr(fn, "__closure__", True) is None:
            key = (fn.__code__, fn.__defaults__, modes, device)
        else:
            key = (fn, modes, device)
        tc = self._classes.get(key)
        if tc is not None:
            return tc
        # keyword-only parameters (``donate``) are the device module's to
        # pass, not bound from insert arguments
        fn_names = [p.name for p in inspect.signature(fn).parameters.values()
                    if p.kind is not inspect.Parameter.KEYWORD_ONLY]
        # AFFINITY args are markers, not function parameters: they do not
        # consume a name from the signature
        names: List[Optional[str]] = []
        cursor = 0
        for mode in modes:
            if mode is AFFINITY:
                names.append(None)
            else:
                names.append(fn_names[cursor] if cursor < len(fn_names)
                             else f"arg{cursor}")
                cursor += 1
        flows = []
        for i, mode in enumerate(modes):
            if mode in (INPUT, OUTPUT, INOUT, DONT_TRACK, SCRATCH):
                # SCRATCH/DONT_TRACK read-class: a scratch temp is not an
                # output flow (it would join the body's return contract
                # and get donated on device); in-place writes to it are
                # fine, its datum is throwaway
                access = mode.access if mode in (INPUT, OUTPUT, INOUT) \
                    else ACCESS_READ
                flows.append(Flow(names[i], access))
        writable = [f.name for f in flows if f.access & ACCESS_WRITE]
        bound = [n for n in names if n is not None]   # fn's actual args
        incarnations = []
        if _is_device(device):
            incarnations.append((device, self._device_hook(fn, bound, flows,
                                                           writable)))
        incarnations.append(("cpu", self._cpu_hook(fn, bound, writable)))
        tc = TaskClass(fn.__name__ if hasattr(fn, "__name__") else "dtd_task",
                       params=[("tid", None)], flows=flows,
                       incarnations=incarnations)
        tc.dtd_names = names   # cached: insert_task must not re-inspect
        self.add_task_class_dynamic(tc)
        self._classes[key] = tc
        return tc

    def add_task_class_dynamic(self, tc: TaskClass) -> None:
        # DTD classes may share a name (same fn, different modes): key by id
        tc.task_class_id = len(self.task_classes)
        tc.taskpool = self
        self.task_classes[f"{tc.name}#{tc.task_class_id}"] = tc

    def create_task_class(self, name: str, arg_names: Sequence[str],
                          modes: Sequence[_Mode]) -> "DTDTaskClass":
        """Explicit task-class API (reference:
        parsec_dtd_create_task_classv, insert_function.c:2539 area):
        declare the argument layout once, attach one chore per device
        type with :meth:`DTDTaskClass.add_chore`, then pass the class to
        :meth:`insert_task` in place of a function.  One logical task
        can carry CPU and TPU chores; the runtime picks per execution
        (the incarnation iteration of scheduling.execute)."""
        if len(arg_names) != len(modes):
            raise ValueError("one name per argument mode")
        return DTDTaskClass(name, list(arg_names),
                            [m.base for m in modes])


    def _cpu_hook(self, fn: Callable, names: List[str],
                  writable: List[str]):
        def hook(es, task):
            args = []
            for i, n in enumerate(names):
                if n in task.data:
                    copy = task.data[n]
                    args.append(None if copy is None else copy.payload)
                elif n in task.locals:
                    args.append(task.locals[n])
            ret = fn(*args)
            if ret is None or isinstance(ret, HookReturn):
                return ret
            if not writable:
                return None
            outs = normalize_body_outputs(ret, writable, what=str(task))
            extents = task.dtd.extents if task.dtd is not None else None
            for fname, value in outs.items():
                copy = task.data.get(fname)
                if copy is None:
                    continue
                cur = copy.payload
                if isinstance(cur, torch.Tensor):
                    # Tensor.copy_ casts and broadcasts as np.copyto does
                    # in the JAX package; a numpy return is viewed first
                    val = value if isinstance(value, torch.Tensor) \
                        else to_host(value)
                    ext = extents.get(fname) if extents else None
                    if ext is not None:
                        # a lane writer writes back its extent only: a
                        # whole-tile write-back would undo another lane's
                        # bytes landed since the body read the tile (the
                        # JAX package's race)
                        if tuple(val.shape) == tuple(cur.shape):
                            val = val[ext]
                        cur = cur[ext]
                    cur.copy_(val)
                else:
                    copy.payload = value
            return None
        return hook

    def _device_hook(self, fn: Callable, names: List[str], flows, writable):
        from parsec_tpu_torch.devices.cuda import CudaKernel
        spec = CudaKernel(fn, names, [f.name for f in flows], writable)

        def hook(es, task):
            reg = getattr(es.context, "device_registry", None)
            if reg is None:
                return HookReturn.NEXT
            dev = None
            # an AFFINITY tile with a pinned device drives placement
            # (reference: data-affinity first, parsec_get_best_device)
            aff = getattr(task.dtd, "affinity", None) \
                if task.dtd is not None else None
            if aff is not None and not isinstance(aff, numbers.Integral):
                try:
                    pref = self._as_tile(aff).data.preferred_device
                except TypeError:
                    pref = None
                if pref is not None and 1 <= pref < len(reg.devices) \
                        and reg.devices[pref].enabled:
                    dev = reg.devices[pref]
            if dev is None:
                dev = reg.best_device(task)
            if dev is None:
                return HookReturn.NEXT
            return dev.submit(es, task, spec)
        return hook

    # -- insertion ---------------------------------------------------------
    def insert_task(self, fn: Callable, *args, priority: int = 0,
                    device: str = "cpu") -> Optional[Task]:
        """Insert one task; each arg is ``(value_or_tile, MODE)``
        (reference: parsec_dtd_insert_task, insert_function.c:3488).

        Tiles may be DTDTile, DataRef (``A(m, n)``), or Data.  VALUE args
        pass through; SCRATCH allocates a fresh buffer of the given shape.

        Distributed pools insert SPMD: every rank calls insert_task with
        the same stream of tasks; each task executes on ONE rank — the
        AFFINITY arg's rank (an int, or a tile whose owner rank is used),
        else the owner of its first written tile (owner computes).  Other
        ranks track the task as a remote writer/reader only (reference:
        insert_function.c:3014-3163 fake remote tasks).  Insertion must
        come from a single thread per rank (the reference's main-thread
        model).  Returns None for tasks placed on other ranks.
        """
        if self.context is None:
            raise RuntimeError(
                "attach the DTD pool to a context before inserting")
        nargs = _norm(args)
        lin = self._lineage
        pos = None
        if lin is not None:
            # SPMD stream position: every rank's counter advances on
            # every insert call, so positions name the same logical
            # task cluster-wide (the skip-agreement unit)
            with self._window:
                pos = self._insert_pos
                self._insert_pos += 1
        for *_x, r in nargs:
            if r is not None and r.slices is not None:
                self._region_slices[r.rid] = r.slices
            if r is not None and lin is not None \
                    and self._skip_note is None:
                # region lanes track sub-tile writers whose landing
                # versions applied_ver cannot name — unskippable
                self._skip_note = "region lanes"
        args = [(v, b) for v, b, _f, _r in nargs]
        rank = self._task_rank(args) if self.nranks > 1 else self.myrank
        if lin is not None:
            sk = self._dtd_skip
            if sk is not None and pos < sk["prefix"]:
                # agreed-skippable prefix: ghost-track the write
                # ordering (versions advance, no body runs, no counts)
                self._ghost_insert(nargs)
                return None
            if sk is not None:
                # first post-prefix insert: install the holder writers
                # and seed the cut payloads BEFORE this insert tracks
                with self._dep_lock:
                    self._dtd_skip_finalize_locked()
            self._note_insert(pos, nargs, rank)
        if rank != self.myrank:
            self._insert_remote(nargs, rank)
            return None
        if isinstance(fn, DTDTaskClass):
            tc = fn.materialize(self)
            fn.validate_modes(tuple(b for _v, b in args))
        else:
            modes = tuple(m for _, m in args)
            tc = self._class_for(fn, modes, device)
        names = tc.dtd_names

        task = Task(tc, self, {"tid": next(_seq)})
        task.priority = priority
        state = _DTDState(task, rank=self.myrank)
        state.insert_pos = pos
        task.dtd = state

        with self._window:
            # hysteresis: once the window fills, block until drained below
            # the threshold (reference: dtd_window_size/threshold,
            # insert_function.h:131-141)
            if self._inflight >= self.window_size:
                self.window_stalls += 1
                while self._inflight >= self.threshold:
                    self._raise_context_error()
                    self._window.wait(0.1)

        # parse/validate args FIRST: raising after the nb_tasks increment
        # would leave the count high forever and hang wait() (ADVICE r1)
        tracked: List[Tuple[DTDTile, _Mode, Any]] = []
        for i, (value, mode, flags, region) in enumerate(nargs):
            name = names[i]
            if mode is VALUE:
                task.locals[name] = value
            elif mode is AFFINITY:
                state.affinity = value   # placement hint (rank / tile)
            elif mode is SCRATCH:
                shape = value if isinstance(value, tuple) else (int(value),)
                datum = new_data(torch.zeros(shape, dtype=torch.float32))
                task.data[name] = datum.copy_on(0)
            elif mode in (INPUT, OUTPUT, INOUT, DONT_TRACK):
                tile = self._as_tile(value)
                task.data[name] = tile.data.copy_on(0)
                if mode is not DONT_TRACK:
                    tracked.append((tile, mode,
                                    region.rid if region is not None
                                    else None))
                if mode is not INPUT and region is not None \
                        and region.slices is not None:
                    if state.extents is None:
                        state.extents = {}
                    state.extents[name] = tuple(region.slices)
                if "PUSHOUT" in flags and mode is not INPUT:
                    # force the result home at completion instead of
                    # staying producer/device-resident until a flush
                    # (reference: PARSEC_PUSHOUT)
                    state.pushout.append(tile)
            else:
                raise TypeError(f"unsupported arg mode {mode!r}")

        self.termdet.taskpool_addto_nb_tasks(self, 1)
        to_schedule: List[Task] = []
        with self._dep_lock:
            self._inflight += 1
            for tile, mode, region in tracked:
                self._track(state, tile, mode, to_schedule, region=region)
            # read under the lock: once released, a completing predecessor
            # may drive remaining to 0 and schedule the task itself —
            # checking outside would double-schedule
            if state.remaining == 0:
                to_schedule.append(task)
        if to_schedule:
            scheduling.schedule(self.context.streams[0], to_schedule)
        return task

    # -- distributed placement & remote tracking ---------------------------
    def _task_rank(self, args) -> int:
        """Execution rank of a task: AFFINITY wins (int rank or tile
        owner), else the owner of the first written tile, else the first
        read tile, else 0 — identical on every rank by construction.
        Routed through the pool's recovery translation so re-inserted
        work lands on the dead rank's adopter (tile home_ranks already
        resolve through the collection's owner_of at tile_of time)."""
        first = None
        rank = None
        for value, mode in args:
            if mode is AFFINITY:
                rank = int(value) if isinstance(value, numbers.Integral) \
                    else self._as_tile(value).home_rank
                break
        if rank is None:
            for value, mode in args:
                if mode in (OUTPUT, INOUT):
                    rank = self._as_tile(value).home_rank
                    break
                if first is None and mode is INPUT:
                    first = self._as_tile(value)
        if rank is None:
            rank = first.home_rank if first is not None else 0
        t = getattr(self, "rank_translation", None)
        return t.get(rank, rank) if t else rank

    def _conflict_lanes(self, tile: DTDTile,
                        rid: Any) -> List[Tuple[Any, _Lane]]:
        """(lane rid, lane) pairs an access to ``rid`` conflicts with
        (caller holds _dep_lock; tile.lanes must exist): its own lane
        plus the whole-tile lane, or EVERY lane for a whole-tile
        access."""
        lanes = tile.lanes
        if rid is not None and rid not in lanes:
            lanes[rid] = _Lane()
        lanes.setdefault(None, _Lane())
        return [(rid, lanes[rid]), (None, lanes[None])] \
            if rid is not None else list(lanes.items())

    def _insert_remote(self, nargs, rank: int) -> None:
        """Track a task that executes on another rank: its reads of
        locally-produced versions trigger payload sends; its writes insert
        delivery surrogates so later local consumers chain correctly.
        Region-lane accesses conflict laneswise, and a lane write's
        payload is named (tile, version) with its lane rid riding along
        so the receiver applies only the lane's extent."""
        reads: List[Tuple[DTDTile, Any]] = []
        writes: List[Tuple[DTDTile, Any]] = []
        for value, mode, _f, region in nargs:
            if mode in (INPUT, OUTPUT, INOUT):
                tile = self._as_tile(value)
                rid = region.rid if region is not None else None
                if mode in (INPUT, INOUT):
                    reads.append((tile, rid))
                if mode in (OUTPUT, INOUT):
                    writes.append((tile, rid))
        sends: List[Tuple[int, DTDTile, int, Any]] = []
        with self._dep_lock:
            for tile, rid in reads:
                if tile.lanes is None and rid is None:
                    lws = [(tile.last_writer, None, tile.version)]
                    v0_needed = tile.last_writer is None
                else:
                    if tile.lanes is None:
                        tile.lanes = {None: _Lane(tile.last_writer,
                                                  list(tile.readers),
                                                  tile.version)}
                    lws = [(lane.last_writer, lrid, lane.version)
                           for lrid, lane in self._conflict_lanes(tile,
                                                                  rid)]
                    # mirrors _track_region's v0 rule EXACTLY (the SPMD
                    # streams keep lane states consistent, so sender and
                    # receiver reach the same verdict): the NONE lane
                    # writerless, and a lane-scoped read's own lane too
                    lanes = tile.lanes
                    v0_needed = lanes[None].last_writer is None \
                        and (rid is None
                             or lanes[rid].last_writer is None)
                if v0_needed and tile.home_rank == self.myrank \
                        and rank != self.myrank \
                        and rank not in tile.v0_sent:
                    # pristine home value: the owner forwards version 0
                    tile.v0_sent.add(rank)
                    sends.append((rank, tile, 0, None))
                for lw, lrid, lver in lws:
                    if lw is None or lw.is_recv or lw.rank != self.myrank:
                        continue   # a surrogate's rank serves its payload
                    key = (rank, tile, lver, lrid)
                    if key not in lw.remote_sends:
                        # recorded either way so N readers on one rank
                        # cost ONE payload on the wire
                        lw.remote_sends.add(key)
                        if lw.done:
                            sends.append(key)
            for tile, rid in writes:
                self._surrogate_write(tile, rid)
        for dst, tile, ver, lane in sends:
            self._send_payload(dst, tile, ver, lane)

    def _surrogate_write(self, tile: DTDTile, rid: Any = None) -> None:
        """Advance the tile's version past a remote write, leaving a
        delivery surrogate as (lane) last writer (caller holds _dep_lock).

        The WAW edge chains through EVERY surrogate — including unneeded
        ones — so WAR edges from still-pending readers of older versions
        survive skipped versions (the reference chains every fake remote
        writer, insert_function.c:3014-3163; ADVICE r2 high).  A
        surrogate whose ordering obligations are already met completes in
        place (``done``) instead of dangling; _edge then skips it."""
        tile.version += 1
        d = _DTDState(None, rank=self.myrank)
        d.is_recv = True
        d.tile = tile
        d.version = tile.version
        d.region = rid
        if tile.lanes is None and rid is None:
            for r in tile.readers:   # WAR: local readers finish first
                self._edge(r, d)
            lw = tile.last_writer    # WAW: order in-place datum writes
            if lw is not None:
                self._edge(lw, d)
            if d.remaining == 0:
                d.done = True        # no pending obligations: pass-through
            tile.last_writer = d
            tile.readers = []
            self._trace_lane("surrogate", tile.wire_key, None,
                             tile.version)
            return
        if tile.lanes is None:
            tile.lanes = {None: _Lane(tile.last_writer,
                                      list(tile.readers), tile.version)}
        lanes = tile.lanes
        self._warn_extentless_overlap(tile, rid, writer_is_recv=True)
        for _lrid, lane in self._conflict_lanes(tile, rid):
            for r in lane.readers:                     # WAR
                self._edge(r, d)
            if lane.last_writer is not None:           # WAW
                self._edge(lane.last_writer, d)
        if d.remaining == 0:
            d.done = True
        if rid is None:
            tile.lanes = {None: _Lane(d, version=tile.version)}
        else:
            lanes[rid].last_writer = d
            lanes[rid].readers = []
            lanes[rid].version = tile.version
        tile.last_writer = d
        tile.readers = []
        self._trace_lane("surrogate", tile.wire_key, rid, tile.version)

    @staticmethod
    def _edge(pred: "_DTDState", succ: "_DTDState") -> None:
        if pred is succ or pred.done:
            return
        pred.successors.append(succ)
        succ.remaining += 1

    def _mark_needed(self, d: "_DTDState",   # holds-lock: _dep_lock
                     to_schedule: List[Task]) -> None:
        """First local consumer of a surrogate's version: make it a real
        (counted, schedulable) task expecting the network payload (caller
        holds _dep_lock).

        A surrogate that completed IN PLACE (unneeded pass-through whose
        ordering obligations were already met — it is necessarily still
        the tile's last writer, with no successors) is revived here: its
        only remaining job is applying the payload before the new
        consumer runs."""
        if d.needed:
            return
        d.done = False               # revive a pass-through completion
        d.needed = True
        self._trace_lane("need", d.tile.wire_key, d.region, d.version)
        task = Task(self._recv_class(), self, {"tid": next(_seq)})
        task.dtd = d
        d.task = task
        key = (d.tile.wire_key, d.version)
        arr = self._received.pop(key, None)
        if arr is not None:
            d.payload = arr
        else:
            d.remaining += 1         # the payload arrival is a dependency
            self._expected[key] = d
        self.termdet.taskpool_addto_nb_tasks(self, 1)
        self._inflight += 1
        if d.remaining == 0:
            to_schedule.append(task)

    def _apply_data(self, tile: DTDTile, arr: torch.Tensor, lane: Any,
                    ver: int) -> None:
        """Apply an in-run network payload.  A lane payload writes only
        its slice extent.  A whole-tile payload must not clobber extents
        of lanes with NEWER versions whose newest writer is a surrogate:
        that lane's bytes arrive via its own recv chain, which is
        UNORDERED relative to this one (disjoint lanes take no mutual
        edges) — preserving makes both arrival orders converge.  A
        newer lane whose newest writer is a LOCAL task is ordered after
        this recv (it conflicts transitively), so its extent still wants
        this payload's bytes and is NOT preserved."""
        self._trace_lane("apply", tile.wire_key, lane, ver,
                         arr=arr)
        if lane is not None:
            sl = self._region_slices.get(lane)
            if sl is not None:
                self._merge_payload(tile, arr, sl, [])
                return
            # extent-less lane payload = whole tile: preserve newer
            # sliced lanes below, exactly as a whole-tile payload would
        preserve = []
        with self._dep_lock:       # lanes mutate under the pool dep lock
            if tile.lanes:
                for lrid, l in tile.lanes.items():
                    if lrid is None or lrid == lane or l.version <= ver:
                        continue
                    lw = l.last_writer
                    # preserve the lane when its newer bytes arrive via
                    # an UNORDERED channel: a surrogate's own recv chain,
                    # or — for the version-0 pristine pull, which takes
                    # no edges on pre-existing lane writers — any write
                    # at all (a local one may have already landed)
                    if (lw is not None and lw.is_recv) or ver == 0:
                        sl = self._region_slices.get(lrid)
                        if sl is not None:
                            preserve.append(sl)
        with self._apply_lock:
            # WHOLE-COVERING landing order guard (the r6 region-lane
            # stale-read race): disjoint-lane appliers take no mutual
            # dep edges, and extent-less lanes have no byte extent the
            # preserve list could protect — so an apply that lost the
            # race to a NEWER whole-covering landing (payload apply or
            # completed local write) must be dropped wholesale, not
            # merged.  Checked and advanced atomically under the same
            # lock the merge holds: two racing appliers serialize here
            # and the older one sees the newer one's version.
            if ver < tile.applied_ver:
                self._trace_lane("apply_stale", tile.wire_key, lane, ver)
                return
            tile.applied_ver = ver
            self._merge_payload_locked(tile, arr, None, preserve)

    def _recv_class(self) -> TaskClass:
        if self._recv_tc is None:
            def _recv_hook(es, task):
                st = task.dtd
                if st.payload is not None:
                    self._apply_data(st.tile, st.payload, st.region,
                                     st.version)
                    st.payload = None
                return None
            tc = TaskClass("_dtd_recv", params=[("tid", None)], flows=[],
                           incarnations=[("cpu", _recv_hook)])
            self.add_task_class_dynamic(tc)
            self._recv_tc = tc
        return self._recv_tc

    def _wire_msg(self, kind: str, tile: DTDTile, ver: int,
                  lane: Any = None) -> dict:
        """Encode a tile payload message (pulls the tile home first).

        A region-lane write ships ONLY the lane's slice extent (the
        reference's per-region datatypes, insert_function.h:60-78); the
        lane rid rides the message and the receiver applies the payload
        into the same extent read-modify-write.

        Payloads over the eager limit travel by RENDEZVOUS: a snapshot
        registers as a serve-once region and only its handle rides the
        message; the consumer pulls via the CE's one-sided get
        (reference: the eager/rendezvous split of the remote-dep
        protocol applied to DTD traffic)."""
        from parsec_tpu_torch.comm.engine import CommEngine
        copy = tile.data.pull_to_host()
        arr = to_host(copy.payload)
        base = {"tp": self.taskpool_id, "kind": kind,
                "tile": tile.wire_key, "ver": ver}
        if lane is not None:
            # extent-less (ordering-only) lanes ship the WHOLE tile with
            # the lane id + version riding for receiver-side ordering
            # (reference regions always carry a datatype,
            # insert_function.h:60-78; without one, whole-tile is the
            # only correct granularity)
            sl = self._region_slices.get(lane)
            if sl is not None:
                arr = arr[tuple(sl)]
            base["lane"] = lane
        self._trace_lane("encode", tile.wire_key, lane, ver,
                         arr=arr)
        eager = int(params.get("comm_eager_limit", 65536))
        comm = self.context.comm if self.context is not None else None
        if comm is not None and arr.numel() * arr.element_size() > eager:
            # snapshot: the datum may be rewritten by later local
            # writers before the consumer pulls
            rid = comm.ce.mem_register(
                arr.clone(memory_format=torch.contiguous_format),
                once=True)
            return {**base, "ref": rid, "from": self.myrank}
        # pack makes the eager snapshot: one owned host copy
        return {**base, **CommEngine.pack(arr)}

    def _send_payload(self, dst: int, tile: DTDTile, ver: int,
                      lane: Any = None) -> None:
        self._dtd_send_contained(dst, self._wire_msg("data", tile, ver,
                                                     lane))

    def _dtd_incoming(self, src: int, msg: dict) -> None:
        """Comm-thread entry for DTD payload/flush messages."""
        from parsec_tpu_torch.comm.engine import CommEngine
        if "ref" in msg:
            # rendezvous: pull the registered snapshot from the producer
            # (the pending-pull count was taken atomically with the
            # message credit in RemoteDepEngine._dtd_cb)
            comm = self.context.comm

            def on_data(arr, msg=msg, comm=comm):
                try:
                    if arr is None:
                        self.context.record_error(RuntimeError(
                            f"DTD rendezvous pull of {msg['tile']} "
                            f"v{msg['ver']} from rank {msg['from']} "
                            "failed"), None)
                        return
                    self._dtd_payload(msg, arr)
                finally:
                    comm.dtd_ref_done((msg.get("tp"),
                                       msg.get("pe", 0)))

            comm.ce.get(msg["from"], msg["ref"], on_data)
            return
        self._dtd_payload(msg, CommEngine.unpack(msg))

    def _dtd_payload(self, msg: dict, arr: torch.Tensor) -> None:
        wire = tuple(msg["tile"])
        self._trace_lane("payload", wire, msg.get("lane"), msg["ver"],
                         arr=arr)
        if msg["kind"] == "data":
            key = (wire, msg["ver"])
            to_schedule: List[Task] = []
            with self._dep_lock:
                d = self._expected.pop(key, None)
                if d is None:
                    self._received[key] = arr
                else:
                    d.payload = arr
                    d.remaining -= 1
                    if d.remaining == 0:
                        to_schedule.append(d.task)
            if to_schedule:
                scheduling.schedule(self.context.streams[0], to_schedule)
        elif msg["kind"] == "flush":
            lane = msg.get("lane")
            with self._dep_lock:
                if not self._drained:
                    self._flush_queue.append((wire, arr, lane,
                                              msg["ver"]))
                    return
                tile = self._tiles_by_wire.get(wire)
            if tile is not None:
                self._apply_flush(tile, arr, lane, msg["ver"])

    def _as_tile(self, value) -> DTDTile:
        if isinstance(value, DTDTile):
            return value
        if isinstance(value, DataRef):
            return self.tile_of(value.dc, *value.indices)
        if isinstance(value, Data):
            key = ("data", id(value))
            with self._dep_lock:
                t = self._tiles.get(key)
                if t is None:
                    if self._lineage is not None \
                            and self._skip_note is None:
                        # id()-based wire keys are neither rank- nor
                        # replay-stable: a skip plan over them would
                        # exchange meaningless landed evidence — vote
                        # full up front (the tile_new latch's twin)
                        self._skip_note = "raw Data wire keys are " \
                                          "not replay-stable"
                    # raw Data has no owner rank: local-only tile
                    t = DTDTile(value, home_rank=self.myrank,
                                wire_key=("d", id(value)))
                    self._tiles[key] = t
                return t
        raise TypeError(f"cannot interpret {value!r} as a tile")

    def _track(self, state: _DTDState, tile: DTDTile, mode: _Mode,
               to_schedule: List[Task], region: Any = None) -> None:
        """Register RAW/WAR/WAW edges against the tile's history (caller
        holds _dep_lock; reference: set_dependencies_for_function +
        parsec_dtd_ordering_correctly).  Versions produced on other ranks
        appear as delivery surrogates; consuming one marks it needed.

        ``region`` selects a partial-tile dependency lane (reference:
        the region masks of insert_function.h): distinct regions of one
        tile do not conflict; a region-free access conflicts with every
        lane."""
        if region is not None or tile.lanes is not None:
            self._track_region(state, tile, mode, region, to_schedule)
            return
        me = self.myrank
        lw = tile.last_writer
        if mode is INPUT:
            if lw is None and tile.home_rank != me and self.nranks > 1:
                # pristine remote-home value: pull version 0
                d = _DTDState(None, rank=me)
                d.is_recv, d.tile, d.version = True, tile, 0
                tile.last_writer = lw = d
            if lw is not None:
                if lw.is_recv:
                    # revives an in-place-completed (pass-through)
                    # surrogate; a needed one that already ran is kept
                    self._mark_needed(lw, to_schedule)
                self._edge(lw, state)              # RAW
            tile.readers.append(state)
            self._trace_lane("read", tile.wire_key, None, tile.version)
        else:  # OUTPUT / INOUT: this task becomes the tile's writer
            for r in tile.readers:                 # WAR
                self._edge(r, state)
            if lw is None and mode is INOUT and tile.home_rank != me \
                    and self.nranks > 1:
                d = _DTDState(None, rank=me)
                d.is_recv, d.tile, d.version = True, tile, 0
                tile.last_writer = lw = d
            if lw is not None:                     # WAW (+ RAW for INOUT)
                if lw.is_recv and mode is INOUT:
                    # INOUT reads the surrogate's version: needs payload
                    self._mark_needed(lw, to_schedule)
                # chain WAW through every writer, surrogates included —
                # _edge skips only a DONE one, whose ordering obligations
                # (WAR from pending readers, earlier WAW) are all met
                # (ADVICE r2 high)
                self._edge(lw, state)
            tile.version += 1
            state.version = tile.version
            state.local_writes.append((tile, tile.version, None))
            tile.last_writer = state
            tile.readers = []
            self._trace_lane("write", tile.wire_key, None, tile.version)

    def _warn_extentless_overlap(self, tile: DTDTile, rid: Any,
                                 writer_is_recv: bool) -> None:
        """Extent-less lanes merge across ranks at WHOLE-TILE granularity
        (no byte extent to cut), so two such lanes of one tile with
        concurrent writers on different ranks can lose one lane's
        update.  Make that LOUD at insert time — the r4 guard's
        diagnostic value without banning the legal serialized patterns
        (caller holds _dep_lock)."""
        if self.nranks <= 1 or rid is None or rid in self._region_slices:
            return
        for lrid, lane in (tile.lanes or {}).items():
            if lrid is None or lrid == rid \
                    or lrid in self._region_slices:
                continue
            lw = lane.last_writer
            if lw is None or lw.done or lw.is_recv == writer_is_recv:
                continue
            if tile.wire_key in self._extless_warned:
                return
            self._extless_warned.add(tile.wire_key)
            warning(
                "tile %s: extent-less region lanes %r and %r have "
                "concurrent writers on different ranks; payloads ship "
                "whole-tile, so one lane's bytes may be lost — declare "
                "Region(..., slices=...) for byte-exact disjoint "
                "merging", tile.wire_key, rid, lrid)
            return

    def _track_region(self, state: _DTDState, tile: DTDTile, mode: _Mode,
                      rid: Any, to_schedule: List[Task]) -> None:
        """Region-lane dependency tracking.  The first region-flagged
        access migrates the tile's whole-tile history into the ``None``
        lane; thereafter a region access conflicts with its own lane
        plus the whole-tile lane, and a whole-tile access conflicts with
        every lane.  Versions produced on other ranks appear as lane
        surrogates (same machinery as whole-tile distributed tracking);
        consuming one marks it needed and its payload applies into the
        lane's slice extent only."""
        me = self.myrank
        if tile.lanes is None:
            tile.lanes = {None: _Lane(tile.last_writer,
                                      list(tile.readers), tile.version)}
        lanes = tile.lanes
        conflict = self._conflict_lanes(tile, rid)
        if mode is INPUT or mode is INOUT:
            # pristine remote-home tile: materialize the v0 pull in the
            # whole-tile lane (mirrors _track's surrogate-on-demand).
            # Keyed on the NONE lane being writerless — another lane
            # having a writer must not suppress it, or a whole-tile read
            # after a lone OUTPUT lane write would read uninitialized
            # extents; the v0 apply preserves every written lane's bytes
            if self.nranks > 1 and tile.home_rank != me \
                    and lanes[None].last_writer is None \
                    and (rid is None
                         or lanes[rid].last_writer is None):
                d = _DTDState(None, rank=me)
                d.is_recv, d.tile, d.version = True, tile, 0
                lanes[None].last_writer = d
        mine = lanes[rid] if rid is not None else None
        if mode is INPUT:
            for _lrid, lane in conflict:
                lw = lane.last_writer
                if lw is not None:
                    if lw.is_recv:
                        self._mark_needed(lw, to_schedule)
                    self._edge(lw, state)                      # RAW
            (mine if mine is not None else lanes[None]).readers.append(
                state)
            self._trace_lane("read", tile.wire_key, rid, tile.version)
        else:
            self._warn_extentless_overlap(tile, rid, writer_is_recv=False)
            for _lrid, lane in conflict:
                for r in lane.readers:                         # WAR
                    self._edge(r, state)
                lw = lane.last_writer
                if lw is not None:                             # WAW
                    if lw.is_recv and mode is INOUT:
                        # INOUT reads the surrogate's version
                        self._mark_needed(lw, to_schedule)
                    self._edge(lw, state)
            tile.version += 1
            state.version = tile.version
            state.region = rid
            state.local_writes.append((tile, tile.version, rid))
            if rid is None:
                # whole-tile write supersedes every lane's history
                tile.lanes = {None: _Lane(state, version=tile.version)}
            else:
                mine.last_writer = state
                mine.readers = []
                mine.version = tile.version
            # keep the legacy fields coherent for flush/debug paths
            tile.last_writer = state
            tile.readers = []
            self._trace_lane("write", tile.wire_key, rid, tile.version)

    # -- dynamic release (called from engine.release_deps) ----------------
    def dynamic_release(self, es, task: Task) -> List[Task]:
        state = task.dtd
        if not isinstance(state, _DTDState):
            return []
        # the body has run: its whole-covering writes are LANDED values
        # now — advance each tile's applied_ver so an older whole-
        # covering payload racing in from an unordered lane cannot
        # clobber them (see _apply_data's landing-order guard)
        self._advance_applied(state.local_writes)
        for tile in state.pushout:
            # PUSHOUT: force the produced version home now (reference:
            # PARSEC_PUSHOUT — eager writeback instead of lazy residency)
            try:
                tile.data.pull_to_host()
                if tile.data.collection is not None:
                    tile.data.collection.refresh_backing(tile.data)
            except Exception as exc:
                self.context.record_error(exc, task)
        grapher = self.context.grapher if self.context else None
        ready: List[Task] = []
        outgoing: List[Tuple[int, dict]] = []
        # Encode payloads outside the pool lock — a 64MB D2H pull under
        # _dep_lock would stall the insertion and comm threads — but
        # BEFORE marking the task done: a later writer inserted while we
        # encode still takes an edge on us (done tasks are skipped by
        # _edge) and cannot run until the successor decrements below, so
        # the datum is stable.  Readers inserted mid-encode append to
        # remote_sends, hence the delta loop (reference: delayed dep
        # release + per-peer sends, remote_dep_mpi.c:519).
        encoded: set = set()
        while True:
            with self._window:
                delta = [e for e in state.remote_sends if e not in encoded]
                if not delta:
                    state.done = True
                    self._inflight -= 1
                    break
            for dst, tile, ver, lane in sorted(
                    delta, key=lambda e: (e[0], e[2])):
                outgoing.append((dst, self._wire_msg("data", tile, ver,
                                                     lane)))
                encoded.add((dst, tile, ver, lane))
        with self._window:
            if self._lineage is not None and state.insert_pos is not None:
                # insert-stream completion evidence: the skip report's
                # frontier is the contiguous prefix of these positions
                self._pos_done.add(state.insert_pos)
            # worklist: an unneeded surrogate whose last obligation clears
            # completes IN PLACE (no task to run) and propagates to its
            # own successors immediately — the ordering chain through
            # skipped versions stays intact (ADVICE r2 high)
            pending = [(state, s) for s in state.successors]
            while pending:
                pred, succ = pending.pop()
                if grapher is not None and succ.task is not None \
                        and pred.task is not None:
                    # cascaded edges (pred = an in-place-completed
                    # surrogate, task None) are not drawn: attributing
                    # them to the outer task would fabricate DAG edges
                    grapher.edge(pred.task, succ.task.key, "dtd")
                succ.remaining -= 1
                if succ.remaining != 0:
                    continue
                if succ.is_recv and not succ.needed:
                    succ.done = True
                    pending.extend((succ, s) for s in succ.successors)
                elif succ.task is not None:
                    ready.append(succ.task)
            if self._inflight < self.threshold:
                self._window.notify_all()
        for dst, msg in outgoing:
            self._dtd_send_contained(dst, msg)
        return ready


class DTDTaskClass:
    """User-declared DTD task class with explicit per-device chores
    (reference: parsec_dtd_create_task_classv + parsec_dtd_add_chore)."""

    def __init__(self, name: str, arg_names: List[str],
                 modes: List[_Mode]):
        self.name = name
        self.arg_names = arg_names
        self.modes = modes
        self.chores: List[Tuple[str, Callable]] = []
        self._tc: Optional[TaskClass] = None

    def add_chore(self, device: str, fn: Callable) -> "DTDTaskClass":
        if self._tc is not None:
            raise RuntimeError("add_chore after the class was first "
                               "inserted (chore table is frozen)")
        _is_device(device)      # a JAX package device name raises here
        self.chores.append((device, fn))
        return self

    def validate_modes(self, modes: Tuple[_Mode, ...]) -> None:
        if tuple(modes) != tuple(self.modes):
            raise TypeError(
                f"task class {self.name!r}: insert arg modes {modes} do "
                f"not match the declared {tuple(self.modes)}")

    def materialize(self, pool: DTDTaskpool) -> TaskClass:
        if self._tc is not None:
            if self._tc.taskpool is not pool:
                raise RuntimeError(
                    f"task class {self.name!r} is bound to another pool")
            return self._tc
        if not self.chores:
            raise RuntimeError(f"task class {self.name!r} has no chores")
        names: List[Optional[str]] = [
            None if mode is AFFINITY else self.arg_names[i]
            for i, mode in enumerate(self.modes)]
        flows = []
        for i, mode in enumerate(self.modes):
            if mode in (INPUT, OUTPUT, INOUT, DONT_TRACK, SCRATCH):
                access = mode.access if mode in (INPUT, OUTPUT, INOUT) \
                    else ACCESS_READ
                flows.append(Flow(names[i], access))
        writable = [f.name for f in flows if f.access & ACCESS_WRITE]
        bound = [n for n in names if n is not None]
        incarnations = []
        for device, fn in self.chores:
            if _is_device(device):
                incarnations.append(
                    (device, pool._device_hook(fn, bound, flows, writable)))
            else:
                incarnations.append(
                    ("cpu", pool._cpu_hook(fn, bound, writable)))
        tc = TaskClass(self.name, params=[("tid", None)], flows=flows,
                       incarnations=incarnations)
        tc.dtd_names = names
        pool.add_task_class_dynamic(tc)
        self._tc = tc
        return tc
