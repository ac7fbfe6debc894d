"""Live gauge aggregator: the aggregator_visu counterpart.

Rebuild of the reference's live-visualization pipeline (reference:
tools/aggregator_visu/aggregator.py + *_thread.py — per-rank PAPI-SDE
gauges stream to an aggregator process holding a keyed time-series
store; GUIs subscribe and plot).  TPU-first reshape: one lightweight
TCP aggregator thread holds the latest snapshot and a bounded history
per (rank, gauge); ranks publish via ``GaugePublisher`` (a periodic
thread reading prof/gauges.py Gauges.snapshot()); consumers poll
``Aggregator.table()`` or subscribe a callback — the JAX package's
terminal viewer ``tools/live_view.py`` renders it live (the aggregator
GUI's role without a display server).  The port's copy of the JAX
package's prof/aggregator.py; nothing differs but this sentence.

Wire format: one JSON object per line — {"rank": r, "t": seconds,
"gauges": {...}} — so anything (curl, netcat, a notebook) can publish
or scrape.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple


class Aggregator:
    """Keyed latest-value + bounded-history store behind a TCP listener
    (reference: aggregator_database_thread.py's store)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 history: int = 512):
        self._lock = threading.Lock()
        self._latest: Dict[int, Dict[str, float]] = {}
        self._seen_at: Dict[int, float] = {}
        self._hist: Dict[Tuple[int, str], deque] = {}
        self._history = history
        self._subs: List[Callable[[int, Dict[str, float]], None]] = []
        self._stop = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="gauge-aggregator",
                                        daemon=True)
        self._thread.start()

    # -- ingest ------------------------------------------------------------
    def _accept_loop(self) -> None:
        # close() flags _stop and joins this thread BEFORE closing the
        # socket, so the fd stays valid for the life of the loop; the
        # guard covers the join-timeout fallback where close() proceeds.
        try:
            self._srv.settimeout(0.2)
        except OSError:
            return
        while not self._stop:
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # daemon handlers self-terminate on _stop / peer close
            threading.Thread(target=self._recv_loop, args=(conn,),
                             daemon=True).start()

    def _recv_loop(self, conn: socket.socket) -> None:
        buf = b""
        conn.settimeout(1.0)
        while not self._stop:
            try:
                chunk = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                try:
                    msg = json.loads(line)
                    self.ingest(int(msg["rank"]), msg["gauges"],
                                float(msg.get("t", time.time())))
                except (ValueError, KeyError, TypeError):
                    continue   # malformed line: drop, keep the stream

    def ingest(self, rank: int, gauges: Dict[str, float],
               t: Optional[float] = None) -> None:
        t = time.time() if t is None else t
        # The wire accepts arbitrary JSON values; keep only numerics so
        # render_table/history never see a string/null from a publisher.
        clean = {k: float(v) for k, v in gauges.items()
                 if isinstance(v, (int, float))}
        with self._lock:
            self._latest[rank] = dict(clean)
            self._seen_at[rank] = t
            for k, v in clean.items():
                h = self._hist.get((rank, k))
                if h is None:
                    h = self._hist[(rank, k)] = deque(maxlen=self._history)
                h.append((t, v))
            subs = list(self._subs)
        for cb in subs:
            cb(rank, clean)

    # -- consume -----------------------------------------------------------
    def subscribe(self, cb: Callable[[int, Dict[str, float]], None]):
        with self._lock:
            self._subs.append(cb)

    def table(self) -> Dict[int, Dict[str, float]]:
        """Latest snapshot per rank (plus staleness in seconds)."""
        now = time.time()
        with self._lock:
            out = {}
            for r, g in sorted(self._latest.items()):
                row = dict(g)
                row["_age_s"] = round(now - self._seen_at.get(r, now), 2)
                out[r] = row
            return out

    def history(self, rank: int, gauge: str) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._hist.get((rank, gauge), ()))

    def totals(self) -> Dict[str, float]:
        """Cross-rank sums — the math-thread's aggregate view
        (reference: aggregator_math_thread.py)."""
        with self._lock:
            tot: Dict[str, float] = {}
            for g in self._latest.values():
                for k, v in g.items():
                    if isinstance(v, (int, float)):
                        tot[k] = tot.get(k, 0.0) + v
            return tot

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=2)
        try:
            self._srv.close()
        except OSError:
            pass


class GaugePublisher:
    """Periodically publish a rank's Gauges snapshot to an aggregator
    (reference: the app-side PAPI-SDE stream the demo servers emit)."""

    def __init__(self, gauges: Any, rank: int, host: str, port: int,
                 interval: float = 0.25):
        self.gauges = gauges
        self.rank = rank
        self.interval = interval
        self._addr = (host, port)
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"gauge-pub-{rank}",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.publish_once()
            self._stop.wait(self.interval)

    def publish_once(self) -> bool:
        try:
            if self._sock is None:
                self._sock = socket.create_connection(self._addr,
                                                      timeout=1.0)
            msg = {"rank": self.rank, "t": time.time(),
                   "gauges": self.gauges.snapshot()}
            self._sock.sendall((json.dumps(msg) + "\n").encode())
            return True
        except OSError:
            try:
                if self._sock is not None:
                    self._sock.close()
            finally:
                self._sock = None
            return False

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self.publish_once()          # final flush
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


def render_table(table: Dict[int, Dict[str, float]],
                 totals: Optional[Dict[str, float]] = None) -> str:
    """Fixed-width text rendering of the per-rank gauge table (the
    basic_gui.py role, terminal-friendly)."""
    if not table:
        return "(no ranks reporting)"
    cols = sorted({k for g in table.values() for k in g if k != "_age_s"})
    widths = {c: max(len(c), 12) for c in cols}
    lines = ["rank  " + "  ".join(c.rjust(widths[c]) for c in cols)
             + "   age"]
    for r, g in table.items():
        lines.append(f"{r:4d}  " + "  ".join(
            f"{g.get(c, 0):{widths[c]}.0f}" for c in cols)
            + f"  {g.get('_age_s', 0):4.1f}s")
    if totals:
        lines.append(" sum  " + "  ".join(
            f"{totals.get(c, 0):{widths[c]}.0f}" for c in cols) + "      ")
    return "\n".join(lines)
