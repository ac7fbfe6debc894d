"""Frame-stream parsing shared by the byte-stream transports.

The event-loop TCP transport (comm/engine.py) and the shared-memory
ring transport (comm/shm.py) speak one wire format: a 16-byte header
(``!IQI``: tag, pickle length, out-of-band buffer count), the pickle
body, then per-buffer length (``!Q``) + raw bytes.  This module is the
parser seam: ``make_parser`` hands out the native incremental parser
(parsec_tpu_torch/native/commext.c — one C crossing consumes a whole
read and returns the completed frames) behind the ``comm_frame_native``
A/B knob, with ``PyFrameParser`` as its Python twin.

Deliberate difference from the JAX package: no silent tier.  There a
commext that does not build leaves the transports on the Python parser;
here it raises ``NativeBuildError`` with the compiler's stderr, and
``comm_frame_native=0`` is the one way onto the Python parser.

Parser API (both implementations):

  ``feed(buf) -> [(tag, body|None, [oob, ...]), ...]`` — consume bytes,
      return completed frames; raises ValueError on a bound violation
      (the caller severs the connection: wire corruption).
  ``bulk_target() -> memoryview | None`` — writable view of an
      in-progress large payload's remaining region, so the transport
      can ``recv_into`` it directly (the zero-copy out-of-band path);
      commit with ``bulk_commit(n) -> [frames...]``.
  ``idle() -> bool`` — True exactly between frames (EOF here is a
      clean close; anywhere else the peer died mid-frame).
  ``stats() -> int`` — frames completed through this parser.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from parsec_tpu_torch.utils.mca import params

params.register("comm_frame_native", 1,
                "parse comm frames with the native (C) incremental "
                "parser, which must build (0 = the Python state machine; "
                "the frame-path A/B knob).  Applies to the evloop and "
                "shm transports; the threads transport keeps its "
                "blocking per-peer recv loops either way")

_LEN = struct.Struct("!IQI")
_BUFLEN = struct.Struct("!Q")

#: below this many remaining bytes, copying through feed() beats a
#: dedicated recv_into (mirrors commext.c BULK_MIN)
_BULK_MIN = 65536

_ST_HDR, _ST_BODY, _ST_BLEN, _ST_BUF = range(4)


class PyFrameParser:
    """Pure-Python twin of commext.FrameParser (same API, same wire
    semantics): the shm transport's parser at ``comm_frame_native=0``
    and the reference implementation its tests diff against."""

    __slots__ = ("_max", "_stage", "_want", "_got", "_small", "_target",
                 "_tag", "_ln", "_nbufs", "_body", "_oob", "_frames")

    def __init__(self, max_frame: int):
        self._max = int(max_frame)
        self._small = bytearray(_LEN.size)
        self._frames = 0
        self._expect_hdr()

    def _expect_hdr(self) -> None:
        self._stage = _ST_HDR
        self._want = _LEN.size
        self._got = 0
        self._target = None
        self._body = None
        self._oob: List[bytearray] = []

    def idle(self) -> bool:
        return self._stage == _ST_HDR and self._got == 0

    def stats(self) -> int:
        return self._frames

    def feed(self, data) -> List[Tuple[int, Optional[bytearray], list]]:
        out: List = []
        mv = memoryview(data)
        while len(mv):
            take = self._want - self._got
            if take > len(mv):
                take = len(mv)
            tgt = self._target if self._target is not None else self._small
            tgt[self._got:self._got + take] = mv[:take]
            self._got += take
            mv = mv[take:]
            if self._got == self._want:
                self._advance(out)
        return out

    def bulk_target(self):
        if self._target is None or self._want - self._got < _BULK_MIN:
            return None
        return memoryview(self._target)[self._got:]

    def bulk_commit(self, n: int) -> List:
        if self._target is None or n < 0 or self._got + n > self._want:
            raise ValueError("bulk_commit outside an in-progress payload")
        out: List = []
        self._got += n
        if self._got == self._want:
            self._advance(out)
        return out

    def _advance(self, out: List) -> None:
        st = self._stage
        if st == _ST_HDR:
            tag, ln, nbufs = _LEN.unpack_from(self._small)
            if ln > self._max or nbufs > 4096:
                raise ValueError(
                    f"frame length {ln}/{nbufs} bufs exceeds the bound "
                    f"(tag={tag})")
            self._tag, self._ln, self._nbufs = tag, ln, nbufs
            self._body = None
            self._oob = []
            if ln:
                self._target = bytearray(ln)
                self._stage = _ST_BODY
                self._want = ln
                self._got = 0
                return
        elif st == _ST_BODY:
            self._body = self._target
            self._target = None
        elif st == _ST_BLEN:
            (bln,) = _BUFLEN.unpack_from(self._small)
            if bln > self._max:
                raise ValueError(
                    f"oob buffer length {bln} (tag={self._tag})")
            if bln:
                self._target = bytearray(bln)
                self._stage = _ST_BUF
                self._want = bln
                self._got = 0
                return
            self._oob.append(bytearray(0))
        elif st == _ST_BUF:
            self._oob.append(self._target)
            self._target = None
        if len(self._oob) < self._nbufs:
            self._stage = _ST_BLEN
            self._want = _BUFLEN.size
            self._got = 0
            self._target = None
            return
        out.append((self._tag, self._body, self._oob))
        self._frames += 1
        self._expect_hdr()


def make_parser(max_frame: int, require: bool = False):
    """The frame parser for one peer stream: ``(parser, is_native)``.

    With ``comm_frame_native`` on, the native parser (a failed build
    raises NativeBuildError).  Off, ``require=False`` (the evloop
    caller) returns ``(None, False)`` — the transport keeps its own
    inline Python machinery, which IS the A/B path there — and
    ``require=True`` (the shm transport, which has no inline path)
    returns a PyFrameParser.
    """
    if int(params.get("comm_frame_native", 1)):
        from parsec_tpu_torch.native import load_commext
        return load_commext().FrameParser(int(max_frame)), True
    if require:
        return PyFrameParser(int(max_frame)), False
    return None, False
