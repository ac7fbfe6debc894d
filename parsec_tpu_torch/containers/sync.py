"""Synchronization primitives: barrier, rwlock, atomic counter.

Reference: parsec/class/parsec_rwlock.*, parsec/barrier.c,
include/parsec/sys/atomic.h.  Python's GIL makes plain ints atomic for
single ops, but the engine's counters need read-modify-write atomicity, so
AtomicCounter wraps a lock explicitly (and maps onto std::atomic in the
native core).
"""

from __future__ import annotations

import threading


Barrier = threading.Barrier  # parsec_barrier_t


class AtomicCounter:
    """fetch_add/fetch_sub/cas counter (reference: parsec_atomic_fetch_*)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: int = 0):
        self._lock = threading.Lock()
        self._value = value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def fetch_add(self, delta: int = 1) -> int:
        with self._lock:
            old = self._value
            self._value += delta
            return old

    def add_and_fetch(self, delta: int = 1) -> int:
        with self._lock:
            self._value += delta
            return self._value

    def fetch_sub(self, delta: int = 1) -> int:
        return self.fetch_add(-delta)

    def sub_and_fetch(self, delta: int = 1) -> int:
        return self.add_and_fetch(-delta)

    def cas(self, expected: int, desired: int) -> bool:
        with self._lock:
            if self._value == expected:
                self._value = desired
                return True
            return False

    def set(self, value: int) -> None:
        with self._lock:
            self._value = value


class RWLock:
    """Readers-writer lock (reference: parsec_rwlock, ticket-based)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    class _Guard:
        def __init__(self, lock, write):
            self._lock, self._write = lock, write

        def __enter__(self):
            (self._lock.acquire_write if self._write
             else self._lock.acquire_read)()

        def __exit__(self, *exc):
            (self._lock.release_write if self._write
             else self._lock.release_read)()

    def read(self):
        return RWLock._Guard(self, False)

    def write(self):
        return RWLock._Guard(self, True)
