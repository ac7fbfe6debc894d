"""Binary trace: per-stream event buffers with a typed dictionary.

Rebuild of the reference's profiling subsystem (reference:
parsec/profiling.c + parsec/parsec_binary_profile.h — per-thread
append-only buffers of fixed-size events {key, flags, taskpool_id,
event_id, timestamp} plus typed info payloads; a dictionary maps key ->
name + info-converter string; buffer types EVENTS/DICTIONARY/THREAD/
GLOBAL_INFO/HEADER, :29-33; API parsec_profiling_{init,start,fini},
_trace_flags, _dbp_dump, profiling.h:133-395).

Here an event is a struct-packed record; "info" payloads are key=value
dicts pickled per event when present (the reference's converter strings
describe C structs — the python-native equivalent is self-describing).
The writer is wait-free per stream: each stream appends to its own list;
dump() serializes header + dictionary + per-stream sections into one
.ptt file the reader (reader.py) loads into rows with the columns of
the pbt2ptt pipeline's tables (tools/profiling/python/pbt2ptt.pyx).
"""

from __future__ import annotations

import io
import itertools
import os
import pickle
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"PTPT0001"
EV_START = 1 << 0     # event marks an interval start
EV_END = 1 << 1       # event marks an interval end
EV_POINT = 1 << 2     # standalone point event

_EV = struct.Struct("!HHIQqd")   # key, flags, taskpool_id, event_id,
                                 # object id (task key hash), timestamp


class EventClass:
    """Dictionary entry (reference: parsec_profiling_add_dictionary_keyword)."""

    __slots__ = ("name", "key", "attributes")

    def __init__(self, name: str, key: int, attributes: str = ""):
        self.name = name
        self.key = key
        self.attributes = attributes   # converter-string analog


class StreamBuffer:
    """Per-execution-stream event buffer (reference: per-thread profiling
    buffers; appending never takes a lock).

    Info-less events — the overwhelming majority — go to the C trace
    sink of the pinsext extension (reference: profiling.c's record path —
    one fixed-size append, timestamp taken in C).  Events carrying a
    Python info payload stay in a Python list; both merge, ordered by
    timestamp, at dump time.

    Deliberate difference from the JAX package: no fallback tier.  There
    a pinsext that does not build (or whose clock is not perf_counter's)
    degrades to the ctypes trace buffer, then to a plain list; here
    ``load_pinsext`` raises NativeBuildError and so does the Profile
    that asked for the stream.
    """

    def __init__(self, stream_id: int, name: str):
        from parsec_tpu_torch.native import load_pinsext
        self.stream_id = stream_id
        self.name = name
        self.events: List[Tuple] = []
        self._sink = load_pinsext().TraceSink()
        #: one-crossing interval append (both edges of a task interval)
        self._sink_interval = self._sink.interval

    def trace(self, key: int, flags: int, taskpool_id: int, event_id: int,
              object_id: int = 0, info: Any = None,
              timestamp: Optional[float] = None) -> None:
        if info is None:
            if timestamp is None:
                # ONE C call; the timestamp is taken inside, on the
                # same CLOCK_MONOTONIC timeline as perf_counter
                self._sink.event(key, flags, taskpool_id, event_id,
                                 object_id)
            else:
                self._sink.event_at(key, flags, taskpool_id, event_id,
                                    object_id, timestamp)
            return
        ts = timestamp if timestamp is not None else time.perf_counter()
        self.events.append((key, flags, taskpool_id, event_id, object_id,
                            ts, info))

    def interval(self, key: int, taskpool_id: int, event_id: int,
                 object_id: int, t_begin: float) -> None:
        """Both edges of one task interval in ONE C call: the START record
        carries the caller-captured begin timestamp (perf_counter), the
        END record is stamped at call time."""
        self._sink_interval(key, taskpool_id, event_id, object_id, t_begin,
                            EV_START, EV_END)

    def merged_events(self) -> List[Tuple]:
        """All events (C sink and python), timestamp-ordered."""
        merged = [ev + (None,) for ev in self._sink.drain()]
        # a drained sink would lose events on a second call: keep them in
        # the python list so dump() stays idempotent
        self.events = merged + self.events
        self.events.sort(key=lambda e: e[5])
        return list(self.events)


class Profile:
    """One trace session (reference: parsec_profiling state)."""

    def __init__(self, hr_id: str = "parsec_tpu_torch"):
        # the sink every stream writes through: a pinsext that does not
        # build raises here, when the session is made, not on the first
        # event a worker records (where it would fail a task)
        from parsec_tpu_torch.native import load_pinsext
        load_pinsext()
        self.hr_id = hr_id
        self._dict: Dict[str, EventClass] = {}
        self._keys = itertools.count(1)
        self._streams: Dict[int, StreamBuffer] = {}
        self._lock = threading.Lock()
        self._info: Dict[str, str] = {}
        self._event_ids = itertools.count(1)
        self.enabled = True
        #: (perf_counter, time.time_ns()) read together: lays the
        #: profile's timestamps onto the wall clock (``set_clock_anchor``)
        self.clock_anchor: Optional[Tuple[float, int]] = None

    # -- dictionary -------------------------------------------------------
    def add_event_class(self, name: str, attributes: str = "") -> EventClass:
        with self._lock:
            ec = self._dict.get(name)
            if ec is None:
                ec = EventClass(name, next(self._keys), attributes)
                self._dict[name] = ec
            return ec

    def event_class(self, name: str) -> Optional[EventClass]:
        return self._dict.get(name)

    def add_information(self, key: str, value: str) -> None:
        self._info[key] = str(value)

    def set_clock_anchor(self) -> Tuple[float, int]:
        """Take the header's anchor pair: a ``perf_counter`` read between
        two ``time.time_ns()`` reads, paired with their midpoint (the
        tightest of three tries).  A timestamp ``ts`` of this profile is
        then the wall-clock ``ns + (ts - pc) * 1e9`` (``reader.wall_ns``),
        the clock a ``torch.profiler`` trace puts device activity on."""
        best = None
        for _ in range(3):
            n0 = time.time_ns()
            pc = time.perf_counter()
            n1 = time.time_ns()
            if best is None or n1 - n0 < best[0]:
                best = (n1 - n0, pc, (n0 + n1) // 2)
        self.clock_anchor = (best[1], best[2])
        return self.clock_anchor

    # -- streams ----------------------------------------------------------
    def stream(self, stream_id: int, name: str = "") -> StreamBuffer:
        with self._lock:
            sb = self._streams.get(stream_id)
            if sb is None:
                sb = StreamBuffer(stream_id, name or f"stream-{stream_id}")
                self._streams[stream_id] = sb
            return sb

    def next_event_id(self) -> int:
        return next(self._event_ids)

    # -- convenience: interval tracing ------------------------------------
    def trace_interval_start(self, sb: StreamBuffer, name: str,
                             taskpool_id: int, event_id: int,
                             object_id: int = 0, info: Any = None) -> None:
        if self.enabled:
            ec = self.add_event_class(name)
            sb.trace(ec.key, EV_START, taskpool_id, event_id, object_id,
                     info)

    def trace_interval_end(self, sb: StreamBuffer, name: str,
                           taskpool_id: int, event_id: int,
                           object_id: int = 0, info: Any = None) -> None:
        if self.enabled:
            ec = self.add_event_class(name)
            sb.trace(ec.key, EV_END, taskpool_id, event_id, object_id, info)

    # -- dump (reference: parsec_profiling_dbp_dump) ----------------------
    def dump(self, path: str) -> str:
        with self._lock:
            streams = list(self._streams.values())
            dico = list(self._dict.values())
        merged = {sb.stream_id: sb.merged_events() for sb in streams}
        buf = io.BytesIO()
        buf.write(MAGIC)
        meta = {
            "hr_id": self.hr_id,
            "info": self._info,
            "dictionary": [(ec.key, ec.name, ec.attributes) for ec in dico],
            "streams": [(sb.stream_id, sb.name, len(merged[sb.stream_id]))
                        for sb in streams],
            "clock_anchor": self.clock_anchor,
        }
        mb = pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL)
        buf.write(struct.pack("!Q", len(mb)))
        buf.write(mb)
        for sb in streams:
            infos = {}
            for i, (key, flags, tp, eid, oid, ts, info) in \
                    enumerate(merged[sb.stream_id]):
                buf.write(_EV.pack(key, flags, tp, eid, oid, ts))
                if info is not None:
                    infos[i] = info
            ib = pickle.dumps(infos, protocol=pickle.HIGHEST_PROTOCOL)
            buf.write(struct.pack("!Q", len(ib)))
            buf.write(ib)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        return path


_profile: Optional[Profile] = None


def profiling_init(hr_id: str = "parsec_tpu_torch") -> Profile:
    """reference: parsec_profiling_init (profiling.c:473)."""
    global _profile
    _profile = Profile(hr_id)
    return _profile


def profiling_get() -> Optional[Profile]:
    return _profile


def profiling_fini(path: Optional[str] = None) -> Optional[str]:
    """Dump and drop the session (reference: parsec_profiling_fini)."""
    global _profile
    p = _profile
    _profile = None
    if p is not None and path is not None:
        return p.dump(path)
    return None
