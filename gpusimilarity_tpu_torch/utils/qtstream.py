"""Qt ``QDataStream``-compatible binary (de)serialization, dependency-free
(the port's copy of ``gpusimilarity_tpu/utils/qtstream.py``, cut to what
:mod:`.fsim` and :mod:`.strings` use).

The reference system serializes its ``.fsim`` databases and its socket protocol
with Qt's ``QDataStream`` at version ``Qt_5_2`` (see reference
``gpusim.cpp:183`` and ``python/gpusim_createdb.py:137``). This module
implements only the primitives that format actually uses, in pure Python on
top of :mod:`struct` and :mod:`zlib`, so the package can read and write
byte-identical files without Qt.

Wire rules (all big-endian):

* ``int32`` / ``uint32`` / ``uint64``: plain fixed-width big-endian integers.
* ``writeString(char*)``: ``uint32`` length *including* a terminating NUL,
  followed by the bytes and the NUL. A null pointer is ``0xFFFFFFFF`` with no
  payload; an empty string is length ``1`` + a single NUL byte.
* ``QByteArray``: ``uint32`` byte length + raw bytes (``0xFFFFFFFF`` = null).
* ``qCompress``: ``uint32`` big-endian *uncompressed* length + a raw zlib
  stream (RFC 1950).
* ``float``/``double``: at stream version Qt_5_2 the default floating point
  precision is double, so a "float" travels as an 8-byte IEEE double (this is
  what both sides of the reference socket protocol rely on).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

_NULL = 0xFFFFFFFF


class QtStreamError(ValueError):
    """Raised on malformed QDataStream input."""


class QtStreamCorruptError(QtStreamError):
    """The input is complete enough to decode but structurally invalid.

    Framed protocols distinguish this from the base class: a plain
    ``QtStreamError`` from a partial buffer means "wait for more bytes",
    while this means the bytes that DID arrive can never parse — retrying
    with a longer buffer cannot help, so fail the request immediately.
    """


class QtStreamReader:
    """Sequential reader over a bytes-like object in QDataStream layout."""

    __slots__ = ("_buf", "_pos")

    def __init__(self, data: bytes, pos: int = 0):
        self._buf = memoryview(data)
        self._pos = pos

    @property
    def pos(self) -> int:
        return self._pos

    def at_end(self) -> bool:
        return self._pos >= len(self._buf)

    def _take(self, n: int) -> memoryview:
        if self._pos + n > len(self._buf):
            raise QtStreamError(
                f"truncated stream: wanted {n} bytes at offset {self._pos}, "
                f"only {len(self._buf) - self._pos} available"
            )
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def read_int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def read_uint32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def read_string(self) -> Optional[bytes]:
        """Read a ``writeString``-encoded char* (length includes the NUL)."""
        n = self.read_uint32()
        if n == _NULL:
            return None
        if n == 0:
            return b""
        raw = bytes(self._take(n))
        if raw[-1] != 0:
            # the payload is COMPLETE but structurally wrong — distinct
            # from a truncated buffer, so framed readers (the socket
            # server) can fail the request instead of waiting for bytes
            # that will never arrive
            raise QtStreamCorruptError("writeString payload not NUL-terminated")
        return raw[:-1]

    def read_bytearray_view(self) -> Optional[memoryview]:
        """Zero-copy variant of :meth:`read_bytearray`."""
        n = self.read_uint32()
        if n == _NULL:
            return None
        return self._take(n)


class QtStreamWriter:
    """Accumulating writer producing QDataStream-layout bytes."""

    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def getvalue(self) -> bytes:
        return b"".join(self._parts)

    def write_int32(self, v: int) -> None:
        self._parts.append(struct.pack(">i", v))

    def write_uint32(self, v: int) -> None:
        self._parts.append(struct.pack(">I", v))

    def write_string(self, s: Optional[bytes | str]) -> None:
        """Write a char* as ``writeString`` does (length includes a NUL)."""
        if s is None:
            self.write_uint32(_NULL)
            return
        if isinstance(s, str):
            s = s.encode("utf-8")
        self._parts.append(struct.pack(">I", len(s) + 1))
        self._parts.append(s)
        self._parts.append(b"\x00")

    def write_bytearray(self, data: Optional[bytes]) -> None:
        if data is None:
            self.write_uint32(_NULL)
            return
        self._parts.append(struct.pack(">I", len(data)))
        self._parts.append(bytes(data))


def qcompress(data: bytes, level: int = -1) -> bytes:
    """Byte-compatible ``qCompress``: BE uncompressed size + zlib stream."""
    return struct.pack(">I", len(data)) + zlib.compress(bytes(data), level)


def quncompress(data: bytes) -> bytes:
    """Byte-compatible ``qUncompress`` with a size sanity check."""
    if len(data) < 4:
        raise QtStreamError("qCompress payload shorter than its size header")
    (expected,) = struct.unpack(">I", bytes(data[:4]))
    out = zlib.decompress(bytes(data[4:]))
    if len(out) != expected:
        raise QtStreamError(
            f"qUncompress size mismatch: header says {expected}, got {len(out)}"
        )
    return out


def parse_string_chunk(chunk: bytes) -> list[bytes]:
    """Parse a decompressed string chunk: back-to-back ``writeString`` records.

    Mirrors the reference's ``DecompressAssignStringRunnable``
    (``gpusim.cpp:66-85``) which reads char* records until the stream ends.
    """
    out: list[bytes] = []
    reader = QtStreamReader(chunk)
    while not reader.at_end():
        s = reader.read_string()
        out.append(b"" if s is None else s)
    return out

