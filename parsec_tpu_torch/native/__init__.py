"""Build-and-load of the native runtime core.

The C++ library (core.cpp, bound through ctypes) carries the hot-path
primitives the reference keeps native — MPMC handle queues, the zone
allocator, binary trace buffers — the CPython extension schedext.c
carries the scheduler hot path (ready queue, dep countdown, C task
objects and the ``run_quantum`` worker loop), the CPython extension
pinsext.c the binary tracer's per-event sink, and the CPython
extension commext.c the comm layer's frame parser and frame assembly.
All are compiled at first use with g++ into ``parsec_tpu_torch/_build/``
(never next to the sources), to a temp name renamed into place, and
rebuilt whenever a source is newer than its artifact.

Consumers:

  core/scheduling, core/engine,   <- schedext (``sched_native``, default
  core/task, core/taskpool,          on: the default scheduler)
  sched/native
  devices/cuda (device ledger)    <- NativeZoneAllocator
  prof/profiling (StreamBuffer)   <- pinsext (TraceSink)
  comm/frames, comm/engine        <- commext (FrameParser, frame_parts;
                                     ``comm_frame_native``, default on)

NativeDequeue and NativeTraceBuffer are carried whole with core.cpp but
have no consumer: the scheduler's object queues stay the Python
``Dequeue`` (a ctypes crossing per op made the native one ~4x slower
for Python payloads in the JAX package, which keeps it opt-in), and the
tracer's streams write through pinsext, never the ctypes buffer.

Deliberate differences from the JAX package's loader: no silent
fallback and no ``native_core`` knob.  There a failed build logs one
warning and the consumers run their Python twins (for the tracer: the
ctypes trace buffer, then plain Python lists); here a failed build or
load raises ``NativeBuildError`` with the compiler's stderr,
``sched_native=0`` is the one way onto the Python scheduler, and
``comm_frame_native=0`` the one way onto the Python frame parser.
"""

from __future__ import annotations

import ctypes
import os
import struct as struct_mod
import subprocess
import threading
from typing import Optional

from parsec_tpu_torch.utils.output import debug_verbose

#: sources live here; artifacts go to the package's build directory
_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_NAME = "libparsec_tpu_torch.so"
#: CPython extensions get a module name of their own (PyInit_<name>), so
#: the port's and the JAX package's extensions load in one process
_CEXT_PREFIX = "parsec_tpu_torch_"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: a failed build of core.cpp, re-raised on every later load
_lib_error: Optional["NativeBuildError"] = None


class NativeBuildError(RuntimeError):
    """A native source did not build or load (the message carries the
    compiler's stderr)."""


def _stale(so: str, src: str) -> bool:
    """Rebuild when the artifact is missing or older than its source
    (an edited .c next to a stale .so must never load the old code)."""
    return not os.path.exists(so) or \
        os.path.getmtime(so) < os.path.getmtime(src)


def _compile(cmd: list, so: str, what: str) -> None:
    """Compile to a temp name and rename into place: concurrent test
    workers may build on a fresh checkout at once, and a reader must
    never dlopen a half-written .so (rename is atomic)."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        try:
            r = subprocess.run(cmd + ["-o", tmp],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise NativeBuildError(
                f"{what}: build tool error ({' '.join(cmd[:1])}): "
                f"{exc}") from exc
        if r.returncode != 0:
            raise NativeBuildError(
                f"{what}: build failed ({' '.join(cmd)}):\n"
                + r.stderr[-4000:])
        os.replace(tmp, so)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def load() -> ctypes.CDLL:
    """Build (once) and load core.cpp's shared library.  Raises
    NativeBuildError when it does not build or load."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise _lib_error
        so = os.path.join(_BUILD, _LIB_NAME)
        src = os.path.join(_HERE, "core.cpp")
        try:
            if _stale(so, src):
                _compile(["g++", "-O2", "-std=c++17", "-fPIC", "-Wall",
                          "-Wextra", "-shared", src], so, "native core")
            try:
                lib = ctypes.CDLL(so)
            except OSError as exc:
                raise NativeBuildError(
                    f"native core: load failed: {exc}") from exc
        except NativeBuildError as exc:
            _lib_error = exc
            raise
        _sign(lib)
        _lib = lib
        debug_verbose(5, "native core loaded: %s", so)
        return _lib


#: CPython extension modules: name -> loaded module, or the
#: NativeBuildError its build raised (re-raised on every later load)
_cexts: dict = {}


def _load_cext(name: str):
    """Build (once per process) and import the CPython extension
    ``<name>.c`` -> ``_build/parsec_tpu_torch_<name>.so``, whose module
    name is ``parsec_tpu_torch_<name>``.  Raises NativeBuildError when
    the toolchain or the Python headers are missing."""
    with _lock:
        got = _cexts.get(name)
        if isinstance(got, NativeBuildError):
            raise got
        if got is not None:
            return got
        modname = _CEXT_PREFIX + name
        src = os.path.join(_HERE, f"{name}.c")
        so = os.path.join(_BUILD, f"{modname}.so")
        try:
            if _stale(so, src):
                import sysconfig
                inc = sysconfig.get_paths()["include"]
                _compile(["g++", "-O2", "-fPIC", "-shared", f"-I{inc}",
                          src], so, name)
            try:
                import importlib.util
                spec = importlib.util.spec_from_file_location(modname, so)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            except Exception as exc:
                raise NativeBuildError(
                    f"{name}: load failed: {exc}") from exc
        except NativeBuildError as exc:
            _cexts[name] = exc
            raise
        _cexts[name] = mod
        debug_verbose(5, "%s loaded: %s", name, so)
        return mod


def load_schedext():
    """The native scheduler hot path (schedext.c: ReadyQueue, DepTable,
    TaskCore/TaskVT, run_quantum); gated by ``sched_native`` at its
    consumers (sched/__init__.py, core/task.py, core/taskpool.py)."""
    return _load_cext("schedext")


def load_commext():
    """The comm layer's native framing (commext.c: FrameParser,
    frame_parts); gated by ``comm_frame_native`` at its consumers
    (comm/frames.py, comm/engine.py).  Raises NativeBuildError when it
    does not build or load (the JAX package falls back to its Python
    parser then)."""
    return _load_cext("commext")


#: the pinsext module once its clock was checked (load_pinsext)
_pinsext = None


def load_pinsext():
    """The binary tracer's per-event sink (pinsext.c: TraceSink, one
    METH_FASTCALL per event with the timestamp taken in C).  Raises
    NativeBuildError when it does not build or load, and when its clock
    is not the timeline ``time.perf_counter`` reads: C-stamped and
    Python-stamped events must merge on one timeline (the JAX package
    falls back to slower tracer paths in both cases)."""
    global _pinsext
    if _pinsext is not None:
        return _pinsext
    mod = _load_cext("pinsext")
    # the sink stamps with CLOCK_MONOTONIC, perf_counter's clock on Linux.
    # Bracket the C read between two Python reads, a few times: one
    # unlucky deschedule between two reads must not fail the check
    import time as _time
    for _ in range(5):
        a = _time.perf_counter()
        b = mod.now()
        c = _time.perf_counter()
        if a - 1e-4 <= b <= c + 1e-4:
            _pinsext = mod
            return mod
    raise NativeBuildError(
        f"pinsext: the sink's clock ({b:.6f}) is not perf_counter's "
        f"({a:.6f}..{c:.6f}); C- and Python-stamped events would not "
        "merge on one timeline")


def _sign(lib: ctypes.CDLL) -> None:
    C = ctypes
    u64, i64, i32 = C.c_uint64, C.c_int64, C.c_int32
    p, d = C.c_void_p, C.c_double
    sigs = {
        "ptq_deq_new": ([], p),
        "ptq_deq_delete": ([p], None),
        "ptq_deq_push_back": ([p, u64], None),
        "ptq_deq_push_front": ([p, u64], None),
        "ptq_deq_pop_front": ([p, C.POINTER(u64)], C.c_int),
        "ptq_deq_pop_back": ([p, C.POINTER(u64)], C.c_int),
        "ptq_deq_len": ([p], u64),
        "ptq_zone_new": ([u64, u64], p),
        "ptq_zone_delete": ([p], None),
        "ptq_zone_malloc": ([p, u64], i64),
        "ptq_zone_release": ([p, i64], C.c_int),
        "ptq_zone_used": ([p], u64),
        "ptq_zone_free_bytes": ([p], u64),
        "ptq_zone_defragmented": ([p], C.c_int),
        "ptq_trace_new": ([u64], p),
        "ptq_trace_delete": ([p], None),
        "ptq_trace_event": ([p, i32, i32, u64, u64, u64, d], None),
        "ptq_trace_events_bulk": ([p, C.POINTER(C.c_uint8), u64], None),
        "ptq_trace_count": ([p], u64),
        "ptq_trace_event_size": ([], u64),
        "ptq_trace_read": ([p, u64, C.POINTER(C.c_uint8), u64], u64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


# ---------------------------------------------------------------------------
# Python wrappers
# ---------------------------------------------------------------------------

class NativeDequeue:
    """MPMC dequeue of Python objects over native u64 handles (reference:
    parsec_dequeue_t).  Handles are id()s parked in a side table so the
    queue discipline itself runs without the interpreter lock."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.ptq_deq_new()
        self._objs = {}
        self._olock = threading.Lock()

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.ptq_deq_delete(h)
            self._h = None

    def _park(self, obj) -> int:
        key = id(obj)
        with self._olock:
            self._objs.setdefault(key, []).append(obj)
        return key

    def _claim(self, key: int):
        with self._olock:
            lst = self._objs[key]
            obj = lst.pop()
            if not lst:
                del self._objs[key]
            return obj

    def push_back(self, obj) -> None:
        self._lib.ptq_deq_push_back(self._h, self._park(obj))

    def push_front(self, obj) -> None:
        self._lib.ptq_deq_push_front(self._h, self._park(obj))

    def chain_back(self, objs) -> None:
        for o in objs:
            self.push_back(o)

    def _pop(self, fn):
        out = ctypes.c_uint64()
        if not fn(self._h, ctypes.byref(out)):
            return None
        return self._claim(out.value)

    def pop_front(self):
        return self._pop(self._lib.ptq_deq_pop_front)

    def pop_back(self):
        return self._pop(self._lib.ptq_deq_pop_back)

    def __len__(self):
        return int(self._lib.ptq_deq_len(self._h))


class NativeZoneAllocator:
    """Drop-in twin of utils.zone_alloc.ZoneAllocator over the C++
    segment allocator (reference: utils/zone_malloc.c)."""

    def __init__(self, total_bytes: int, unit_bytes: int = 512):
        self._lib = load()
        self._h = self._lib.ptq_zone_new(int(total_bytes), int(unit_bytes))
        if not self._h:
            raise ValueError("zone size and unit must be positive and "
                             "total >= unit")
        self.unit = unit_bytes
        self.nb_units = total_bytes // unit_bytes

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.ptq_zone_delete(h)
            self._h = None

    def malloc(self, nbytes: int):
        off = self._lib.ptq_zone_malloc(self._h, int(nbytes))
        return None if off < 0 else int(off)

    def free(self, offset: int) -> None:
        if self._lib.ptq_zone_release(self._h, int(offset)) != 0:
            raise ValueError(f"bad free at offset {offset}")

    def used_bytes(self) -> int:
        return int(self._lib.ptq_zone_used(self._h))

    def free_bytes(self) -> int:
        return int(self._lib.ptq_zone_free_bytes(self._h))

    def check_defrag(self) -> bool:
        return bool(self._lib.ptq_zone_defragmented(self._h))


class NativeTraceBuffer:
    """Append-only event buffer (reference: the per-thread buffers of
    profiling.c).  ``drain()`` returns (key, flags, taskpool_id,
    event_id, object_id, ts) tuples."""

    #: signed 64-bit fields on the way OUT so negative sentinels (e.g.
    #: object_id -1) round-trip through the C struct's two's complement
    _EVFMT = "<iiqqqd"

    def __init__(self, reserve: int = 4096):
        self._lib = load()
        self._h = self._lib.ptq_trace_new(int(reserve))
        self._evsz = int(self._lib.ptq_trace_event_size())

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.ptq_trace_delete(h)
            self._h = None

    def event(self, key: int, flags: int, taskpool_id: int, event_id: int,
              object_id: int, ts: float) -> None:
        self._lib.ptq_trace_event(self._h, key, flags, taskpool_id,
                                  event_id, object_id, ts)

    #: whole-chunk packers, one C pack call per batch instead of one per
    #: event; lazily built per batch length
    _CHUNK_PACKERS: dict = {}

    def events_bulk(self, events) -> None:
        """One boundary crossing for a batch of (key, flags, tp, eid,
        oid, ts) tuples."""
        if not events:
            return
        n = len(events)
        packer = self._CHUNK_PACKERS.get(n)
        if packer is None:
            # signed 64-bit: same bit pattern as the unsigned layout for
            # the values in range, and it accepts the odd negative id too
            packer = self._CHUNK_PACKERS[n] = \
                struct_mod.Struct("<" + "iiqqqd" * n)
            if len(self._CHUNK_PACKERS) > 64:   # odd tail sizes: bounded
                self._CHUNK_PACKERS.clear()
        flat = []
        ext = flat.extend
        for ev in events:
            ext(ev)
        buf = packer.pack(*flat)
        carr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
        self._lib.ptq_trace_events_bulk(self._h, carr, len(buf))

    def __len__(self):
        return int(self._lib.ptq_trace_count(self._h))

    def drain(self, start: int = 0):
        n = len(self) - start
        if n <= 0:
            return []
        buf = (ctypes.c_uint8 * (n * self._evsz))()
        got = self._lib.ptq_trace_read(self._h, start, buf, len(buf))
        raw = bytes(buf[:got])
        return [struct_mod.unpack_from(self._EVFMT, raw, i * self._evsz)
                for i in range(got // self._evsz)]
