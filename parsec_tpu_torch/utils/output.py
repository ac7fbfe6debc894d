"""Leveled, multiplexed output/debug streams.

Rebuild of the reference's output and debug facilities
(reference: parsec/utils/output.c, parsec/utils/debug.c, utils/colors.c):
numbered output streams with independent verbosity, optional color, optional
per-stream files, plus the ``fatal`` / ``warning`` / ``inform`` /
``debug_verbose`` entry points.  Verbosity is driven by MCA params
(``debug_verbose``, ``debug_color``) so ``--mca debug_verbose 10`` works like
the reference.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, TextIO

from parsec_tpu_torch.utils.mca import params

params.register("debug_verbose", 1, "global debug verbosity (0=errors only)")
params.register("debug_color", True, "colorize terminal output")
# (ring size and tier live in utils/debug_history: debug_history_size,
# debug_paranoid)

_COLORS = {
    "fatal": "\x1b[1;31m", "warning": "\x1b[33m", "inform": "\x1b[36m",
    "debug": "\x1b[2m", "reset": "\x1b[0m",
}


@dataclass
class OutputStream:
    """One multiplexed output stream (reference: parsec_output_stream_t)."""
    stream_id: int
    prefix: str = ""
    verbosity: int = 1
    file: Optional[TextIO] = None
    want_stderr: bool = True

    def close(self):
        if self.file is not None and self.file not in (sys.stdout, sys.stderr):
            self.file.close()
            self.file = None


class Output:
    def __init__(self):
        self._lock = threading.Lock()
        self._streams: Dict[int, OutputStream] = {
            0: OutputStream(stream_id=0, verbosity=params.get("debug_verbose", 1))
        }
        self._next_id = 1
        self.rank = 0  # stamped by the comm layer at init

    # -- stream management (parsec_output_open/close/set_verbosity) ------
    def open(self, prefix: str = "", verbosity: int = 1,
             filename: Optional[str] = None) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            f = open(filename, "a") if filename else None
            self._streams[sid] = OutputStream(stream_id=sid, prefix=prefix,
                                              verbosity=verbosity, file=f)
            return sid

    def close(self, sid: int) -> None:
        with self._lock:
            s = self._streams.pop(sid, None)
        if s:
            s.close()

    def set_verbosity(self, sid: int, level: int) -> None:
        with self._lock:
            if sid in self._streams:
                self._streams[sid].verbosity = level

    def get_verbosity(self, sid: int) -> int:
        with self._lock:
            s = self._streams.get(sid)
            return s.verbosity if s else -1

    # -- emit ------------------------------------------------------------
    def emit(self, sid: int, level: int, kind: str, msg: str) -> None:
        with self._lock:
            s = self._streams.get(sid) or self._streams[0]
            if level > s.verbosity:
                return
            target = s.file if s.file else (sys.stderr if s.want_stderr else sys.stdout)
            use_color = (params.get("debug_color", True)
                         and getattr(target, "isatty", lambda: False)())
            c0 = _COLORS.get(kind, "") if use_color else ""
            c1 = _COLORS["reset"] if use_color and c0 else ""
            stamp = time.strftime("%H:%M:%S")
            line = (f"{c0}[{stamp}][R{self.rank}]"
                    f"{('[' + s.prefix + ']') if s.prefix else ''}"
                    f"[{kind[0].upper()}] {msg}{c1}\n")
            target.write(line)
            target.flush()
        _history.record(kind, msg)


output = Output()


# ---------------------------------------------------------------------------
# Debug-history ring buffer (reference: parsec/utils/debug_marks, debug.c
# PARSEC_DEBUG_HISTORY) — cheap always-on marks dumpable post-mortem.
# ---------------------------------------------------------------------------

class _DebugHistory:
    """Back-compat facade over utils.debug_history — ONE ring for output
    lines and protocol marks (lazy import: mca <-> output cycle)."""

    def record(self, kind: str, msg: str) -> None:
        from parsec_tpu_torch.utils.debug_history import mark
        mark("%s: %s", kind, msg)

    def mark(self, msg: str) -> None:
        from parsec_tpu_torch.utils.debug_history import mark
        mark("%s", msg)

    def dump(self) -> list:
        from parsec_tpu_torch.utils.debug_history import dump_history
        return dump_history()


_history = _DebugHistory()
debug_history = _history


# -- reference-style entry points -------------------------------------------

class FatalError(RuntimeError):
    pass


def fatal(msg: str, *args) -> None:
    """parsec_fatal: unrecoverable — raises instead of abort()."""
    m = msg % args if args else msg
    output.emit(0, 0, "fatal", m)
    raise FatalError(m)


def warning(msg: str, *args) -> None:
    output.emit(0, 0, "warning", msg % args if args else msg)


def inform(msg: str, *args) -> None:
    output.emit(0, 1, "inform", msg % args if args else msg)


def debug_verbose(level: int, msg: str, *args, stream: int = 0) -> None:
    output.emit(stream, level, "debug", msg % args if args else msg)


# -- templated help/error texts (reference: utils/show_help.{c,h}) ----------

#: topic -> template; ``register_help`` lets components ship their own
#: texts the way the reference installs help-*.txt files
_help_topics = {
    "no-comm-engine": (
        "A task has successors on other ranks but no comm engine is\n"
        "attached to this context.  Wire a SocketCE + RemoteDepEngine\n"
        "(see parsec_tpu_torch.comm.launch.run_distributed) before adding\n"
        "distributed taskpools."),
    "device-oom": (
        "The device memory budget ({budget} MiB) cannot hold a {nbytes}-byte\n"
        "tile while every resident copy is pinned.  Raise --mca\n"
        "device_mem_mb, shrink tiles, or lower device_inflight_depth."),
    "scheduler-unknown": (
        "Unknown scheduler component {name!r}; available: {available}."),
}


def register_help(topic: str, template: str) -> None:
    _help_topics[topic] = template


def show_help(topic: str, *, warn: bool = True, **kwargs) -> str:
    """Emit a templated help text (reference: parsec_show_help): returns
    the formatted message and, by default, prints it as a warning."""
    template = _help_topics.get(topic)
    if template is None:
        text = f"(no help text for topic {topic!r}; args: {kwargs})"
    else:
        try:
            text = template.format(**kwargs)
        except (KeyError, IndexError):
            text = f"{template}  [unformatted args: {kwargs}]"
    if warn:
        output.emit(0, 0, "help", f"[{topic}]\n{text}")
    return text
