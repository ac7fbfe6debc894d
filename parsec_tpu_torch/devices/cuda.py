"""CUDA device module: task offload onto one CUDA device.

Rebuild of the reference's GPU device machinery (reference:
parsec/mca/device/device_gpu.{c,h} generic GPU base +
parsec/mca/device/cuda/device_cuda_module.c offload pipeline): each
attached device gets a manager thread (stage-in + kernel launch — the
reference's mutex-elected manager loop, device_cuda_module.c:2537-2763)
and a completer thread (CUDA-event polling, progress_stream:1961).  The
``PARSEC_HOOK_RETURN_ASYNC`` contract holds: the device owns a task from
submit until it re-enters ``complete_execution``.

Ordering.  Every launch, stage-in copy and host read-back of a device runs
on ONE stream: the device's default stream (``launch stream`` below).
Successor dependencies are released EAGERLY, right after the launch is
enqueued (README, "Eager async completion"); that is only sound because a
successor's launch is enqueued after its producer's on the same stream.
Host-side readers (``Data.pull_to_host``, ``engine.stage_in_host``) copy
down with a synchronous ``Tensor.to("cpu")`` on their thread's current
stream, which is the same default stream, so they too are ordered after
every launch.  With one stream, PyTorch's caching allocator never sees a
tensor allocated on one stream and consumed on another, so no
``record_stream`` is needed.  One manager thread per device launches;
the JAX package's ``device_dispatchers`` knob is not carried over.

Device memory is a coherency-tracked cache of datum copies with LRU
eviction, host writeback and byte accounting over ``device_mem_mb``
(reference: gpu_mem_lru + zone_malloc; PyTorch's caching allocator owns
the physical memory, this module manages copy lifetime).  Stage-in is an
explicit copy into fresh device storage, never an alias of the host
buffer (``torch.from_numpy``, a same-device ``.to()`` and ``.contiguous()``
all alias); it is ``non_blocking`` only from pinned host memory.

Kernels are functional torch functions over flow payloads (``CudaKernel``),
launching hand-written kernels through their wrappers.  Each task is one
launch: the wave fusion, chain fusion and buffer donation of the JAX
package's device module, and its degrade-to-CPU mode, are not ported —
their knobs raise NotImplementedError when set.

A CPU-backed instance (``torch.device("cpu")``) runs the same pipeline
with CPU tensors; its streams and events are no-ops and kernel wrappers
take their plain versions.  Tests use it; nothing falls back to it.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from parsec_tpu_torch.core.task import HookReturn, Task, \
    normalize_body_outputs
from parsec_tpu_torch.data.data import (ACCESS_WRITE, Coherency, Data,
                                        DataCopy, FLAG_COW, FLAG_SCRATCH,
                                        to_host)
from parsec_tpu_torch.devices.device import Device
from parsec_tpu_torch.utils.mca import params
from parsec_tpu_torch.utils.output import debug_verbose

params.register("device_inflight_depth", 8,
                "max in-flight device tasks per CUDA device")
params.register("device_mem_mb", 0,
                "device copy-cache capacity in MiB (0 = unlimited)")

#: max eagerly-completed tasks whose launch event has not fired before the
#: completer blocks on the oldest (the run-ahead memory valve)
_RUNAHEAD = 256

#: device-module knobs of the JAX package whose machinery is not ported:
#: (knob, value meaning "off").  Registered at the off value; any other
#: value raises at device bring-up.
_UNPORTED_KNOBS = (
    ("device_fuse", 1),             # wave fusion (one launch per task)
    ("device_fuse_panel", 0),       # chain fusion
    ("device_fuse_donate", 0),
    ("device_fuse_bg", 0),
    ("device_fuse_window_ms", 0.0),
    ("device_fuse_warm_wait_ms", 0.0),
    ("device_donate", 0),           # buffer donation
    ("device_max_faults", 0),       # degraded mode: a fault fails the run
)
for _knob, _off in _UNPORTED_KNOBS:
    params.register(_knob, _off, f"not ported yet (must stay {_off})")


def _check_unported_knobs() -> None:
    for knob, off in _UNPORTED_KNOBS:
        if float(params.get(knob, off)) != float(off):
            raise NotImplementedError(
                f"{knob}={params.get(knob)} is not ported yet: the CUDA "
                f"device module supports only {knob}={off}")


def _nbytes(payload: Any) -> int:
    if isinstance(payload, torch.Tensor):
        return payload.numel() * payload.element_size()
    return int(getattr(payload, "nbytes", 0))


def _forget_on(device_ref, key: int, nbytes: int) -> None:
    """Finalizer of a device copy.  It holds its device weakly: the
    finalizer registry is a root, and a strong reference would reach the
    device's context, its taskpools and their matrices, and so keep the
    very copy it waits on (and every tile of the context) alive."""
    device = device_ref()
    if device is not None:
        device._forget(key, nbytes)


class CudaKernel:
    """Device incarnation spec: a functional torch function over flow
    payloads.

    The function's named arguments are bound from flow payloads (device
    tensors) and task parameters or taskpool globals (plain values).  It
    returns the new values of the written flows: a dict {flow: tensor}, a
    tuple in written-flow declaration order, or a single tensor when
    exactly one flow is written.  It must not write its inputs in place.
    (reference: the BODY [type=CUDA] incarnation of a JDF task class,
    jdf2c.c:6556 GPU hook generation.)
    """

    def __init__(self, fn, arg_names: Sequence[str],
                 flow_names: Sequence[str], writable_flows: Sequence[str]):
        self.fn = fn
        self.arg_names = list(arg_names)
        self.flow_names = set(flow_names)
        self.writable = list(writable_flows)   # flow declaration order

    def bind_outputs(self, result: Any) -> Dict[str, Any]:
        return normalize_body_outputs(result, self.writable, what="kernel")


#: marks an LRU entry as an in-progress adopt claim
_PLACEHOLDER = object()


class _Inflight:
    """One launched task: its outputs, the event recorded after its
    launch, and what it holds until the event fires."""

    __slots__ = ("es", "task", "outputs", "event", "pinned", "load",
                 "release_after")

    def __init__(self, es, task, outputs, event, pinned, load,
                 release_after):
        self.es = es
        self.task = task
        self.outputs = outputs
        #: torch.cuda.Event recorded on the launch stream right after the
        #: launch (None on the CPU-backed module: work is already done)
        self.event = event
        self.pinned = pinned
        self.load = load
        #: host arena copies to return to their freelist once the launch
        #: (and therefore the H2D copy reading them) has completed
        self.release_after = release_after


class CudaDevice(Device):
    """One CUDA device (or the CPU-backed stand-in) as a runtime device
    module."""

    kind = "cuda"

    def __init__(self, tdev: torch.device, weight: float = 1.0):
        _check_unported_knobs()
        self.tdev = tdev
        self.is_cuda = tdev.type == "cuda"
        super().__init__(f"cuda:{tdev.index}" if self.is_cuda
                         else "cuda-on-cpu:0")
        self.weight = weight
        if self.is_cuda:
            #: the launch stream (see the module docstring: one stream)
            self.stream = torch.cuda.default_stream(tdev)
            self.device_name = torch.cuda.get_device_name(tdev)
        else:
            self.stream = None
            self.device_name = "cpu"
        self._depth = max(1, int(params.get("device_inflight_depth", 8)))
        self._runahead = max(self._depth, _RUNAHEAD)
        cap_mb = int(params.get("device_mem_mb", 0))
        self._capacity = cap_mb * (1 << 20) if cap_mb > 0 else None
        self._bytes_used = 0
        if self._capacity is not None:
            from parsec_tpu_torch.utils.zone_alloc import ZoneAllocator
            self._zone = ZoneAllocator(self._capacity)
        else:
            self._zone = None
        #: datum-id -> (weakref to device copy, nbytes, zone offset);
        #: insertion order = LRU order.  Weak so per-task temporaries
        #: (NEW-flow datums) do not accumulate here forever — a finalizer
        #: drops the accounting when the copy dies with its datum.
        self._lru: "OrderedDict[int, Tuple[Any, int, Any]]" = OrderedDict()
        self._pins: Dict[int, int] = {}
        self._mem_lock = threading.Condition()

        self._pending: deque = deque()
        self._inflight: deque = deque()
        #: eagerly-completed tasks whose launch event has not fired yet;
        #: finalized (pins/load/arena released) as their events fire,
        #: oldest-first
        self._retire: deque = deque()
        self._launching = 0
        self._completing = 0
        self._finalizing = 0
        self._cond = threading.Condition()
        self._stop = False
        self.es = None   # device execution stream, set on first submit
        self._manager = threading.Thread(
            target=self._manager_loop, name=f"cuda-mgr-{self.name}",
            daemon=True)
        self._completer = threading.Thread(
            target=self._completer_loop, name=f"cuda-fin-{self.name}",
            daemon=True)
        self._manager.start()
        self._completer.start()

    # ------------------------------------------------------------------
    # submit: worker thread -> device ownership (HOOK_RETURN_ASYNC)
    # ------------------------------------------------------------------
    def submit(self, es, task: Task, spec: CudaKernel) -> HookReturn:
        flops = task.task_class.properties.get("flops", 1.0)
        load = float(flops(task.locals)) if callable(flops) else float(flops)
        self.load_add(load)
        with self._cond:
            if self.es is None:
                from parsec_tpu_torch.core.context import ExecutionStream
                self.es = ExecutionStream(es.context, th_id=900 + self.space)
            self._pending.append((task, spec, load))
            self._cond.notify_all()
        return HookReturn.ASYNC

    # ------------------------------------------------------------------
    # manager: stage-in + launch (reference: parsec_cuda_kernel_push /
    # submit phases of the manager state machine)
    # ------------------------------------------------------------------
    def _manager_loop(self):
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait(0.1)
                if self._stop and not self._pending:
                    return
                item = self._pending.popleft()
                self._launching += 1
            try:
                self._launch(*item)
            except Exception as exc:   # stage-in/launch failure fails the
                # context (device_max_faults=0: no degraded mode)
                from parsec_tpu_torch.core import scheduling
                self.stats.faults += 1
                self.load_sub(item[2])
                self.es.context.record_error(exc, item[0])
                scheduling.complete_execution(self.es, item[0], failed=True)
            finally:
                with self._cond:
                    self._launching -= 1
                    self._cond.notify_all()

    def _launch(self, task: Task, spec: CudaKernel, load: float) -> None:
        """Stage one task's flows in, launch its kernel on the launch
        stream, record the launch event, and queue it for completion."""
        tc = task.task_class
        pinned: List[Any] = []
        release_after: List[DataCopy] = []
        try:
            # pin every datum this task touches before any eviction
            # decision
            for flow in tc.flows:
                copy = task.data.get(flow.name)
                if copy is not None and copy.data is not None:
                    self._pin(copy.data)
                    pinned.append(copy.data)
            with self._on_stream():
                staged: Dict[str, Any] = {}
                for flow in tc.flows:
                    copy = task.data.get(flow.name)
                    if copy is None:
                        continue
                    dc = self._stage_in(copy, flow.access,
                                        pinned=flow.name in task.pinned_flows)
                    if dc is not copy and copy.device == 0 \
                            and copy.arena is not None:
                        # host arena temp fully superseded by the device
                        # copy: return it to the freelist once the launch
                        # completes (the H2D copy may still read it)
                        copy.data.detach_copy(0)
                        release_after.append(copy)
                    task.data[flow.name] = dc
                    staged[flow.name] = dc.payload
                args = []
                for a in spec.arg_names:
                    if a in staged:
                        args.append(staged[a])
                    elif a in task.locals:
                        args.append(task.locals[a])
                    else:
                        args.append(task.taskpool.globals.get(a))
                outputs = spec.bind_outputs(spec.fn(*args))
                event = None
                if self.is_cuda:
                    event = torch.cuda.Event()
                    event.record(self.stream)
        except Exception:
            for d in pinned:
                self._unpin(d)
            for copy in release_after:
                copy.arena.release_unheld(copy)
            raise
        self.stats.executed_tasks += 1
        with self._cond:
            while len(self._inflight) >= self._depth and not self._stop:
                self._cond.wait(0.1)
            self._inflight.append(_Inflight(self.es, task, outputs, event,
                                            pinned, load, release_after))
            self._cond.notify_all()

    def _on_stream(self):
        """Context making this device and its launch stream current (a
        no-op on the CPU-backed module)."""
        if not self.is_cuda:
            import contextlib
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _to_device(self, payload: Any) -> torch.Tensor:
        """An explicit copy of ``payload`` into fresh storage on this
        device — never an alias of the source."""
        src = payload if isinstance(payload, torch.Tensor) \
            else to_host(payload)
        dst = torch.empty(tuple(src.shape), dtype=src.dtype,
                          device=self.tdev)
        dst.copy_(src, non_blocking=self.is_cuda
                  and src.device.type == "cpu" and src.is_pinned())
        return dst

    def _stage_in(self, copy: DataCopy, access: int,
                  pinned: bool = False) -> DataCopy:
        """Ensure a valid copy of ``copy``'s datum on this device
        (reference: parsec_gpu_data_stage_in, device_cuda_module.c:1261).

        A bound copy that a writeback replacement detached — or, for a
        task-fed (pinned) input, invalidated in place — is a
        version-pinned snapshot; it stages into a private standalone
        device copy without consulting the datum's coherency, which has
        moved on."""
        datum = copy.data
        if copy.flags & FLAG_SCRATCH and copy.version == 0 \
                and access & ACCESS_WRITE and copy.arena is not None:
            # NEW-flow scratch straight from the arena: the host buffer's
            # content is undefined, so materialize the copy directly in
            # device memory (zeros) instead of copying garbage bytes
            nbytes = _nbytes(copy.payload)
            off = self._reserve(nbytes)
            dc = datum.copy_on(self.space)
            if dc is None:
                dc = datum.create_copy(self.space)
            dc.payload = torch.zeros(tuple(copy.payload.shape),
                                     dtype=copy.payload.dtype,
                                     device=self.tdev)
            dc.version = copy.version
            datum.transfer_ownership(self.space, access)
            self._account(datum, dc, nbytes, off)
            self._touch(datum)
            return dc
        if (copy.flags & FLAG_COW) == 0 and copy.is_pinned_snapshot(pinned):
            payload = copy.payload
            nbytes = _nbytes(payload)
            off = self._reserve(nbytes)
            staged = self._to_device(payload)
            snap = Data(nb_elts=datum.nb_elts)
            dc = snap.create_copy(self.space, payload=staged,
                                  coherency=Coherency.SHARED,
                                  version=copy.version)
            self.stats.bytes_in += nbytes
            self._account(snap, dc, nbytes, off)
            return dc
        dc = datum.copy_on(self.space)
        fresh = dc is None
        if fresh:
            dc = datum.create_copy(self.space)
        src = datum.transfer_ownership(self.space, access)
        if src is not None or dc.payload is None:
            payload = src.payload if src is not None else copy.payload
            nbytes = _nbytes(payload)
            # only a FRESH copy claims a zone segment: a re-staged copy
            # already owns one
            off = self._reserve(nbytes) if fresh else None
            dc.payload = self._to_device(payload)
            dc.version = src.version if src is not None else copy.version
            self.stats.bytes_in += nbytes
            if fresh:
                self._account(datum, dc, nbytes, off)
        if copy.flags & FLAG_COW and copy is not dc:
            # the COW alias's payload aliases the producer's buffer; the
            # device copy above is private, so drop the alias from the
            # datum NOW — otherwise flush()/_evict() would later copy an
            # intermediate result through the alias into shared storage
            datum.detach_copy(copy.device)
            copy.payload = None
            copy.coherency = Coherency.INVALID
            copy.flags &= ~FLAG_COW
        self._touch(datum)
        return dc

    # ------------------------------------------------------------------
    # completer: EAGER completion in launch order (reference:
    # parsec_cuda_kernel_pop/epilog + progress_stream events).  Deps are
    # released as soon as the launch is enqueued — the stream orders
    # every successor launch after it — and pins, arena buffers and load
    # accounting are held until the launch event fires (_finalize), with
    # a bounded run-ahead window of unfinished launches as backpressure.
    # ------------------------------------------------------------------
    def _completer_loop(self):
        from parsec_tpu_torch.core import scheduling
        while True:
            with self._cond:
                while not self._inflight and not self._stop:
                    self._cond.wait(0.1)
                if not self._inflight:
                    break       # _stop and drained
                inf = self._inflight.popleft()
                # _completing keeps the task visible to sync() between the
                # queue pop and the retire append
                self._completing += 1
                self._cond.notify_all()
            try:
                for fname, out in inf.outputs.items():
                    dc = inf.task.data.get(fname)
                    if dc is not None:
                        dc.payload = out
                scheduling.complete_execution(inf.es, inf.task)
            except Exception as exc:
                self.stats.faults += 1
                inf.es.context.record_error(exc, inf.task)
            with self._cond:
                self._retire.append(inf)
                self._completing -= 1
                self._cond.notify_all()
            try:
                self._drain_retired(max_unfinalized=self._runahead)
            except Exception as exc:   # the completer thread must survive
                self.stats.faults += 1
                inf.es.context.record_error(exc, inf.task)
        self._drain_retired(max_unfinalized=0)

    def _drain_retired(self, max_unfinalized: int) -> None:
        """Finalize retired tasks whose launch event fired; when more
        than ``max_unfinalized`` are still running, block on the oldest
        (the run-ahead memory valve).  The stream is in order, so the
        newest entry's event covers the whole list."""
        while True:
            block = False
            with self._cond:
                if not self._retire:
                    return
                newest = self._retire[-1]
            newest_ready = self._outputs_ready(newest)
            with self._cond:
                if not self._retire:
                    return
                if self._retire[-1] is not newest:
                    continue   # the list moved on; re-probe
                if newest_ready:
                    batch = list(self._retire)
                    self._retire.clear()
                elif len(self._retire) > max_unfinalized:
                    batch = [self._retire.popleft()]
                    block = True
                else:
                    return
                # popped entries stay visible to sync() until their
                # finalization lands (late errors must beat wait())
                self._finalizing += len(batch)
                self._cond.notify_all()
            try:
                for inf in batch:
                    self._finalize(inf, block=block)
            finally:
                with self._cond:
                    self._finalizing -= len(batch)
                    self._cond.notify_all()

    @staticmethod
    def _outputs_ready(inf: _Inflight) -> bool:
        return inf.event is None or inf.event.query()

    def _finalize(self, inf: _Inflight, block: bool) -> None:
        try:
            if block and inf.event is not None:
                inf.event.synchronize()
        except Exception as exc:
            # deps were already released at launch; a late device-side
            # failure surfaces as a context error (sync()/wait raise)
            self.stats.faults += 1
            inf.es.context.record_error(exc, inf.task)
        finally:
            self.load_sub(inf.load)
            for d in inf.pinned:
                self._unpin(d)
            for copy in inf.release_after:
                # a predecessor's repo entry may still hold this
                # superseded host buffer for its OTHER consumers
                copy.arena.release_unheld(copy)

    def adopt(self, datum, dc: DataCopy) -> None:
        """Account a device copy attached from outside the pipeline —
        tiles born on the device through ``Data.overwrite_on``: claim its
        bytes against the memory budget and enter it in the LRU so
        eviction and flush can see it."""
        key = id(datum)
        nbytes = _nbytes(dc.payload)
        with self._mem_lock:
            while True:
                ent = self._lru.get(key)
                if ent is None:
                    # placeholder claims the key atomically with the
                    # check; pinned so eviction skips the stub
                    self._lru[key] = (weakref.ref(dc), 0, _PLACEHOLDER)
                    self._pins[key] = self._pins.get(key, 0) + 1
                    break
                if ent[2] is not _PLACEHOLDER:
                    return      # already accounted (payload refresh)
                self._mem_lock.wait(0.05)

        def _drop_pin_locked():
            n = self._pins.get(key, 0) - 1
            if n <= 0:
                self._pins.pop(key, None)
            else:
                self._pins[key] = n

        try:
            off = self._reserve(nbytes)
        except BaseException:
            with self._mem_lock:
                ent = self._lru.get(key)
                if ent is not None and ent[2] is _PLACEHOLDER:
                    self._lru.pop(key)
                _drop_pin_locked()
                self._mem_lock.notify_all()
            raise
        with self._mem_lock:
            self._lru[key] = (weakref.ref(dc), nbytes, off)
            self._bytes_used += nbytes
            _drop_pin_locked()
            self._mem_lock.notify_all()
        weakref.finalize(dc, _forget_on, weakref.ref(self), key, nbytes)
        self.stats.bytes_in += nbytes

    def sync(self, timeout: Optional[float] = None) -> None:
        """Drain the device: wait for every queued task to be launched
        and completed, finalize every launch, and synchronize the launch
        stream (reference: the GPU manager drains its streams before
        epilog).  ``timeout`` bounds the wait for the dispatch queues;
        the stream synchronize is unbounded."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: (not self._pending and self._launching == 0
                         and self._completing == 0
                         and self._finalizing == 0
                         and not self._inflight) or self._stop,
                timeout=timeout)
            if not ok:
                raise TimeoutError(f"device {self.name}: sync timed out")
            entries = list(self._retire)
            self._retire.clear()
        if self.is_cuda:
            self.stream.synchronize()
        for inf in entries:
            self._finalize(inf, block=False)

    # ------------------------------------------------------------------
    # device memory cache management (reference: gpu_mem_lru / zone_malloc)
    # ------------------------------------------------------------------
    def _pin(self, datum) -> None:
        with self._mem_lock:
            self._pins[id(datum)] = self._pins.get(id(datum), 0) + 1

    def _unpin(self, datum) -> None:
        with self._mem_lock:
            n = self._pins.get(id(datum), 0) - 1
            if n <= 0:
                self._pins.pop(id(datum), None)
            else:
                self._pins[id(datum)] = n

    def _touch(self, datum) -> None:
        with self._mem_lock:
            if id(datum) in self._lru:
                self._lru.move_to_end(id(datum))

    def _account(self, datum, dc: DataCopy, nbytes: int,
                 offset: Any = None) -> None:
        key = id(datum)
        with self._mem_lock:
            self._lru[key] = (weakref.ref(dc), nbytes, offset)
            self._bytes_used += nbytes
        weakref.finalize(dc, _forget_on, weakref.ref(self), key, nbytes)

    def _forget(self, key: int, nbytes: int) -> None:
        """Finalizer: a device copy died with its (temporary) datum —
        drop its cache accounting, if the entry still refers to the dead
        copy (the key may have been reused)."""
        with self._mem_lock:
            ent = self._lru.get(key)
            if ent is not None and ent[0]() is None:
                self._lru.pop(key)
                self._bytes_used -= ent[1]
                self._zone_free(ent[2])

    def _zone_free(self, offset: Any) -> None:
        if self._zone is not None and offset is not None \
                and offset is not _PLACEHOLDER:
            self._zone.free(offset)

    def _reserve(self, nbytes: int) -> Any:
        """Claim a segment of the memory budget, evicting LRU unpinned
        copies until it fits (reference:
        parsec_gpu_data_reserve_device_space, device_cuda_module.c:864).
        Returns the zone offset (None when the budget is unlimited)."""
        if self._zone is None:
            return None
        import time as _time
        deadline = _time.monotonic() + 30.0
        while True:
            with self._mem_lock:
                while True:
                    off = self._zone.malloc(nbytes)
                    if off is not None:
                        return off
                    victim = None
                    for key in self._lru.keys():
                        if self._pins.get(key, 0) <= 0:
                            victim = key
                            break
                    if victim is None:
                        break   # all pinned right now: wait outside
                    dcref, sz, voff = self._lru.pop(victim)
                    dc = dcref()
                    if dc is None:
                        self._bytes_used -= sz
                        self._zone_free(voff)
                        continue
                    self._evict(dc.data, dc, sz, voff)
            # every resident copy is transiently pinned by in-flight
            # tasks: wait for a finalization to unpin instead of failing
            if _time.monotonic() > deadline:
                from parsec_tpu_torch.utils.output import show_help
                raise MemoryError(show_help(
                    "device-oom", warn=False,
                    budget=(self._capacity or 0) >> 20, nbytes=nbytes))
            _time.sleep(0.001)

    def _evict(self, datum, dc: DataCopy, nbytes: int,
               offset: Any = None) -> None:
        """Write back if authoritative, then drop (caller holds _mem_lock)."""
        if dc.coherency in (Coherency.OWNED, Coherency.EXCLUSIVE) and \
                dc.version >= datum.newest_version():
            self._writeback_host(datum, dc)
        datum.detach_copy(self.space)
        dc.payload = None
        dc.coherency = Coherency.INVALID
        self._bytes_used -= nbytes
        self._zone_free(offset)
        self.stats.evictions += 1

    def _writeback_host(self, datum, dc: DataCopy) -> None:
        """Pull the datum home (one locked, version-guarded path:
        Data.pull_to_host), accounting the transfer."""
        host = datum.copy_on(0)
        if host is None or host.coherency == Coherency.INVALID or \
                host.version < dc.version:
            self.stats.bytes_out += _nbytes(dc.payload)
        datum.pull_to_host()

    def flush(self) -> None:
        """Push every authoritative device copy home (reference: GPU w2r
        writeback tasks).  Flush is a quiescent point, so replaced host
        payloads re-link into their collection's backing storage."""
        with self._mem_lock:
            entries = [ref() for ref, _sz, _off in self._lru.values()]
        for dc in entries:
            if dc is None or dc.data is None:
                continue
            datum = dc.data
            with datum._lock:
                if dc.payload is not None and \
                        dc.coherency in (Coherency.OWNED, Coherency.EXCLUSIVE) \
                        and dc.version >= datum.newest_version():
                    self._writeback_host(datum, dc)
            if datum.collection is not None:
                datum.collection.refresh_backing(datum)

    def fini(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._manager.join(timeout=5)
        self._completer.join(timeout=5)
        self.flush()
        debug_verbose(3, "device %s down: %s", self.name,
                      self.stats.as_dict())
