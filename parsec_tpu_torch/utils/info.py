"""Extensible per-object info registry.

Rebuild of the reference's info system (reference: parsec/class/info.{c,h}
— ``parsec_info_t`` named-slot registries + ``parsec_info_object_array_t``
per-object storage with lazy constructors; used to hang user/device state
off taskpools and devices without changing their types).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class InfoSpace:
    """A named-slot registry (reference: parsec_info_t).  Each name is
    registered once and yields a dense integer id; object arrays index by
    that id."""

    def __init__(self, name: str = "info"):
        self.name = name
        self._lock = threading.Lock()
        self._ids: Dict[str, int] = {}
        self._ctors: List[Optional[Callable[[Any], Any]]] = []

    def register(self, name: str,
                 constructor: Optional[Callable[[Any], Any]] = None) -> int:
        """Register (or look up) a named slot; ``constructor(owner)``
        lazily builds the per-object value on first access
        (reference: parsec_info_register)."""
        with self._lock:
            iid = self._ids.get(name)
            if iid is not None:
                if constructor is not None:
                    self._ctors[iid] = constructor
                return iid
            iid = len(self._ctors)
            self._ids[name] = iid
            self._ctors.append(constructor)
            return iid

    def unregister(self, name: str) -> None:
        with self._lock:
            iid = self._ids.pop(name, None)
            if iid is not None:
                self._ctors[iid] = None

    def lookup(self, name: str) -> Optional[int]:
        with self._lock:
            return self._ids.get(name)

    def constructor_of(self, iid: int):
        with self._lock:
            return self._ctors[iid] if 0 <= iid < len(self._ctors) else None


class InfoObjectArray:
    """Per-object slot storage (reference: parsec_info_object_array_t)."""

    def __init__(self, space: InfoSpace, owner: Any = None):
        self.space = space
        self.owner = owner
        self._lock = threading.Lock()
        self._slots: Dict[int, Any] = {}

    def get(self, name_or_id, default: Any = None) -> Any:
        iid = self._resolve(name_or_id)
        if iid is None:
            return default
        with self._lock:
            if iid in self._slots:
                return self._slots[iid]
        ctor = self.space.constructor_of(iid)
        if ctor is None:
            return default
        value = ctor(self.owner)
        with self._lock:
            return self._slots.setdefault(iid, value)

    def set(self, name_or_id, value: Any) -> None:
        iid = self._resolve(name_or_id)
        if iid is None:
            raise KeyError(f"unregistered info {name_or_id!r}")
        with self._lock:
            self._slots[iid] = value

    def _resolve(self, name_or_id) -> Optional[int]:
        if isinstance(name_or_id, int):
            return name_or_id
        return self.space.lookup(name_or_id)


#: process-wide spaces mirroring the reference's pre-declared registries
#: (per-taskpool and per-device info; reference: parsec_per_stream_infos /
#: the device info arrays)
taskpool_info = InfoSpace("taskpool")
device_info = InfoSpace("device")
stream_info = InfoSpace("stream")
