"""Zero-copy string tables for billion-row SMILES/ID storage (the port's
copy of ``gpusimilarity_tpu/utils/strings.py``).

The reference holds every SMILES and ID as an individually heap-allocated
``char*`` (``gpusim.cpp:66-85``) — tens of GB of small allocations at 1 B
rows. ``StringTable`` instead keeps the decompressed chunk blobs intact and
indexes them with one ``int64 (n, 2)`` offsets array, decoding lazily. It
satisfies the sequence protocol, so it is a drop-in for ``list[bytes]``
wherever ``FingerprintData.smiles`` / ``.ids`` travel.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from . import native
from .qtstream import QtStreamReader


def mmap_backing(arr):
    """The ``np.memmap`` ultimately backing ``arr``, or None.

    Views (``ascontiguousarray``, ``reshape``, dtype views) downcast the
    ``np.memmap`` subclass to plain ``ndarray`` while still paging lazily
    from the file — an ``isinstance`` check on the array itself misses
    them; walk the base chain instead.
    """
    a = arr
    while a is not None:
        if isinstance(a, np.memmap):
            return a
        a = getattr(a, "base", None)
    return None


def _parse_offsets_py(buf: np.ndarray) -> np.ndarray:
    """Pure-python fallback for native.parse_string_records."""
    reader = QtStreamReader(buf.tobytes())
    spans = []
    while not reader.at_end():
        n = reader.read_uint32()
        if n in (0, 0xFFFFFFFF):
            spans.append((reader.pos, reader.pos))
            continue
        start = reader.pos
        reader._take(n)
        if reader._buf[reader.pos - 1] != 0:
            raise ValueError("string record not NUL-terminated")
        spans.append((start, start + n - 1))
    return np.asarray(spans, dtype=np.int64).reshape(-1, 2)


class StringTable(Sequence):
    """Immutable sequence of byte strings backed by one blob + offsets."""

    __slots__ = ("_blob", "_offsets")

    def __init__(self, blob: np.ndarray, offsets: np.ndarray):
        self._blob = np.ascontiguousarray(blob, dtype=np.uint8)
        self._offsets = np.ascontiguousarray(offsets, dtype=np.int64)

    @classmethod
    def from_record_chunks(cls, chunks: Iterable[np.ndarray | bytes]) -> "StringTable":
        """Build from decompressed writeString-record chunks."""
        blobs = [np.frombuffer(c, dtype=np.uint8) if isinstance(c, (bytes, memoryview)) else c for c in chunks]
        offset_arrays = []
        base = 0
        for b in blobs:
            try:
                offs = native.parse_string_records(b)
            except ImportError:
                offs = _parse_offsets_py(b)
            offset_arrays.append(offs + base)
            base += len(b)
        blob = np.concatenate(blobs) if blobs else np.zeros(0, np.uint8)
        offsets = (
            np.concatenate(offset_arrays)
            if offset_arrays
            else np.zeros((0, 2), np.int64)
        )
        return cls(blob, offsets)

    @classmethod
    def from_strings(cls, strings: Iterable[bytes]) -> "StringTable":
        parts = []
        spans = []
        pos = 0
        for s in strings:
            parts.append(np.frombuffer(s, dtype=np.uint8))
            spans.append((pos, pos + len(s)))
            pos += len(s)
        blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return cls(blob, np.asarray(spans, dtype=np.int64).reshape(-1, 2))

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        start, end = self._offsets[i]
        return self._blob[start:end].tobytes()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, StringTable):
            if len(self) != len(other):
                return False
            return all(a == b for a, b in zip(self, other))
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __repr__(self):
        return f"StringTable(n={len(self)}, bytes={self._blob.nbytes})"

    @property
    def nbytes(self) -> int:
        return self._blob.nbytes + self._offsets.nbytes


class StridedStringTable(Sequence):
    """Fixed-width records: row ``i`` is ``blob[i*itemsize:(i+1)*itemsize]``.

    At 1B rows an explicit int64 (n, 2) offsets array costs 16 GB on disk
    and in RAM; production compound IDs are typically fixed-width
    (ZINC/Enamine serials), where the offsets are pure redundancy. This
    table keeps only the blob. Drop-in for ``list[bytes]`` like
    :class:`StringTable`.
    """

    __slots__ = ("_blob", "itemsize")

    def __init__(self, blob: np.ndarray, itemsize: int):
        self._blob = np.ascontiguousarray(blob, dtype=np.uint8).reshape(-1)
        if itemsize <= 0:
            raise ValueError(f"itemsize must be positive, got {itemsize}")
        if self._blob.size % itemsize:
            raise ValueError(
                f"blob size {self._blob.size} not a multiple of itemsize "
                f"{itemsize}"
            )
        self.itemsize = itemsize

    @classmethod
    def from_strings(cls, strings: Iterable[bytes]) -> "StridedStringTable":
        strings = list(strings)
        if not strings:
            return cls(np.zeros(0, np.uint8), 1)
        itemsize = len(strings[0])
        if any(len(s) != itemsize for s in strings):
            raise ValueError("strings are not fixed-width")
        return cls(np.frombuffer(b"".join(strings), np.uint8), itemsize)

    def __len__(self) -> int:
        return self._blob.size // self.itemsize

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self._blob[i * self.itemsize : (i + 1) * self.itemsize].tobytes()

    def __eq__(self, other):
        if isinstance(other, (StridedStringTable, StringTable, list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __repr__(self):
        return (
            f"StridedStringTable(n={len(self)}, itemsize={self.itemsize})"
        )

    @property
    def nbytes(self) -> int:
        return self._blob.nbytes


class ConstantStringTable(Sequence):
    """Every row maps to the same byte string (synthetic benchmark
    libraries have no per-row structures; storing N copies of "C" plus an
    offsets array would be pure waste)."""

    __slots__ = ("value", "_count")

    def __init__(self, value: bytes, count: int):
        if count < 0:
            raise ValueError(f"negative count {count}")
        self.value = bytes(value)
        self._count = count

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.value] * len(range(*i.indices(self._count)))
        if i < 0:
            i += self._count
        if not 0 <= i < self._count:
            raise IndexError(i)
        return self.value

    def __eq__(self, other):
        if isinstance(other, Sequence):
            return len(self) == len(other) and all(
                s == self.value for s in other
            )
        return NotImplemented

    def __repr__(self):
        return f"ConstantStringTable(n={self._count}, value={self.value!r})"

    @property
    def nbytes(self) -> int:
        return len(self.value)
