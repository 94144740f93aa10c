"""Reader/writer for the reference ``.fsim`` v3 fingerprint database format
(the port's copy of ``gpusimilarity_tpu/utils/fsim.py``; the merge of
several files is not ported).

Format (big-endian QDataStream Qt_5_2; see reference ``gpusim.cpp:173-253``
for the reader and ``python/gpusim_createdb.py:135-143`` for the writer)::

    int32   version            == 3
    char*   dbkey              (writeString: uint32 len-incl-NUL + bytes + NUL)
    int32   fp_bitcount        (1024 for RDKit Morgan; must be % 32 == 0)
    int32   fp_count
    int32   n_fp_chunks
    n x QByteArray(qCompress(packed fingerprint bits, <=1 GiB uncompressed))
    int32   n_smiles_chunks
    n x QByteArray(qCompress(back-to-back writeString records))
    int32   n_id_chunks
    n x QByteArray(qCompress(back-to-back writeString records))

The <=1 GiB chunking is the reference's multi-GPU shard unit
(``gpusim_createdb.py:56-69``); the port loads the library onto one card
whole, so chunk boundaries only matter for file compatibility.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from . import native
from .qtstream import (
    QtStreamError,
    QtStreamReader,
    QtStreamWriter,
    parse_string_chunk,
    qcompress,
    quncompress,
)
from .strings import StringTable

DATABASE_VERSION = 3
GIBIBYTE = 2**30
DEFAULT_BITCOUNT = 1024


@dataclass
class FingerprintData:
    """In-memory contents of one fingerprint database.

    ``fingerprints`` is packed little-endian-bit-order data, one row per
    compound, dtype ``uint8`` with shape ``(count, bitcount // 8)``. Bit ``i``
    of a fingerprint is bit ``i % 8`` of byte ``i // 8`` — the layout RDKit's
    ``BitVectToBinaryText`` emits and the layout the engine's packed-word
    kernels consume (after a ``view(uint32)``).

    ``smiles``/``ids`` are any ``Sequence[bytes]`` — plain lists or zero-copy
    :class:`~.strings.StringTable`s at scale.
    """

    dbkey: str = ""
    bitcount: int = DEFAULT_BITCOUNT
    fingerprints: np.ndarray = field(
        default_factory=lambda: np.zeros((0, DEFAULT_BITCOUNT // 8), np.uint8)
    )
    smiles: Sequence[bytes] = field(default_factory=list)
    ids: Sequence[bytes] = field(default_factory=list)
    # provenance tag of the fingerprint generator that built this data
    # (``fingerprints.generator_tag()``); "" = unknown (e.g. a reference-
    # built .fsim, which is always RDKit)
    generator: str = ""

    @property
    def count(self) -> int:
        return int(self.fingerprints.shape[0])

    def validate(self) -> None:
        if self.bitcount % 32 != 0:
            raise ValueError(f"bitcount {self.bitcount} not divisible by 32")
        n, nbytes = self.fingerprints.shape
        if nbytes != self.bitcount // 8:
            raise ValueError(
                f"fingerprint row width {nbytes} B != bitcount/8 = "
                f"{self.bitcount // 8} B"
            )
        if len(self.smiles) != n or len(self.ids) != n:
            raise ValueError(
                f"row count mismatch: {n} fingerprints, {len(self.smiles)} "
                f"smiles, {len(self.ids)} ids"
            )

    def packed_words(self) -> np.ndarray:
        """Fingerprints as ``uint32[count, bitcount // 32]`` packed words.

        For a synthetic (v3 ``.tfsim``) source this is the lazy
        :class:`~.synth.VirtualWords` face — rows
        materialize from their indices on demand; nothing is stored.
        """
        from .synth import VirtualFingerprints

        if isinstance(self.fingerprints, VirtualFingerprints):
            return self.fingerprints.words
        fp = np.ascontiguousarray(self.fingerprints)
        return fp.view(np.uint32).reshape(self.count, self.bitcount // 32)


def _read_chunk_list(reader: QtStreamReader) -> list[memoryview]:
    n = reader.read_int32()
    if n < 0:
        raise QtStreamError(f"negative chunk count {n}")
    chunks = []
    for _ in range(n):
        chunk = reader.read_bytearray_view()
        if chunk is None:
            raise QtStreamError("null QByteArray chunk")
        chunks.append(chunk)
    return chunks


def _decompress_all(chunks, max_workers):
    """qUncompress a chunk list: native parallel path, else GIL-free threads
    (mirrors the reference's QThreadPool decompress, ``gpusim.cpp:202-236``)."""
    if not chunks:
        return []
    try:
        return native.decompress_chunks(chunks)
    except ImportError:
        pass
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return [
            np.frombuffer(raw, dtype=np.uint8)
            for raw in pool.map(quncompress, chunks)
        ]


def read_fsim(
    path: str | os.PathLike,
    max_workers: Optional[int] = None,
    string_tables: bool = True,
) -> FingerprintData:
    """Load a ``.fsim`` v3 file.

    Chunk decompression runs in parallel (native C++ pool when built, else
    Python threads — zlib releases the GIL). With ``string_tables=True`` the
    SMILES/ID lists are zero-copy :class:`StringTable`s over the decompressed
    blobs — the scalable layout for billion-row libraries; pass ``False`` for
    plain ``list[bytes]``.
    """
    with open(path, "rb") as f:
        raw = f.read()
    reader = QtStreamReader(raw)
    version = reader.read_int32()
    if version != DATABASE_VERSION:
        raise QtStreamError(
            f"database version {version} incompatible (expected {DATABASE_VERSION})"
        )
    dbkey = reader.read_string() or b""
    bitcount = reader.read_int32()
    count = reader.read_int32()

    fp_chunks = _read_chunk_list(reader)
    smi_chunks = _read_chunk_list(reader)
    id_chunks = _read_chunk_list(reader)

    fp_parts = _decompress_all(fp_chunks, max_workers)
    smi_parts = _decompress_all(smi_chunks, max_workers)
    id_parts = _decompress_all(id_chunks, max_workers)

    fp_bytes_per_row = bitcount // 8
    fp_raw = (
        np.concatenate(fp_parts) if fp_parts else np.zeros(0, np.uint8)
    )
    if fp_raw.size != count * fp_bytes_per_row:
        raise QtStreamError(
            f"fingerprint payload is {fp_raw.size} B, expected "
            f"{count} x {fp_bytes_per_row} B"
        )
    fingerprints = fp_raw.reshape(count, fp_bytes_per_row)

    if string_tables:
        smiles: Sequence[bytes] = StringTable.from_record_chunks(smi_parts)
        ids: Sequence[bytes] = StringTable.from_record_chunks(id_parts)
    else:
        smiles, ids = [], []
        for p in smi_parts:
            smiles.extend(parse_string_chunk(p.tobytes()))
        for p in id_parts:
            ids.extend(parse_string_chunk(p.tobytes()))

    data = FingerprintData(
        dbkey=dbkey.decode("utf-8"),
        bitcount=bitcount,
        fingerprints=fingerprints,
        smiles=smiles,
        ids=ids,
        generator=_read_fsim_sidecar(path).get("generator", ""),
    )
    data.validate()
    return data


def _sidecar_path(path: str | os.PathLike) -> str:
    return f"{path}.meta.json"


def _read_fsim_sidecar(path: str | os.PathLike) -> dict:
    """The v3 byte format has no room for new fields, so builder metadata
    (currently the fingerprint-generator tag) rides in an optional
    ``<name>.fsim.meta.json`` sidecar. Reference-built files have none."""
    import json

    try:
        with open(_sidecar_path(path)) as f:
            meta = json.load(f)
        return meta if isinstance(meta, dict) else {}
    except (OSError, ValueError):
        return {}


def _write_fsim_sidecar(path: str | os.PathLike, data: FingerprintData) -> None:
    import json

    if data.generator:
        with open(_sidecar_path(path), "w") as f:
            json.dump({"generator": data.generator}, f)
    else:
        # rewriting a .fsim with untagged data must not leave the previous
        # build's tag attached to the new fingerprints
        try:
            os.remove(_sidecar_path(path))
        except OSError:
            pass


def _chunk_rows(total_rows: int, row_bytes: int, limit: int) -> list[tuple[int, int]]:
    """Split ``total_rows`` into (start, stop) spans of <= ``limit`` bytes."""
    if total_rows == 0:
        return [(0, 0)]
    rows_per_chunk = max(1, limit // max(1, row_bytes))
    spans = []
    start = 0
    while start < total_rows:
        stop = min(total_rows, start + rows_per_chunk)
        spans.append((start, stop))
        start = stop
    return spans


def _chunk_strings(strings: Sequence[bytes], limit: int) -> list[bytes]:
    """Pack strings into writeString chunks, rolling at ~``limit`` bytes."""
    chunks: list[bytes] = []
    w = QtStreamWriter()
    size = 0
    for s in strings:
        if size >= limit and size:
            chunks.append(w.getvalue())
            w = QtStreamWriter()
            size = 0
        w.write_string(s)
        size += len(s) + 5  # uint32 length + payload + NUL
    chunks.append(w.getvalue())
    return chunks


def write_fsim(
    path: str | os.PathLike,
    data: FingerprintData,
    chunk_limit: int = GIBIBYTE,
    compress_level: int = -1,
    max_workers: Optional[int] = None,
) -> None:
    """Write a ``.fsim`` v3 file byte-compatible with the reference reader."""
    data.validate()
    w = QtStreamWriter()
    w.write_int32(DATABASE_VERSION)
    w.write_string(data.dbkey.encode("utf-8"))
    w.write_int32(data.bitcount)
    w.write_int32(data.count)

    fp = np.ascontiguousarray(data.fingerprints)
    row_bytes = data.bitcount // 8
    fp_chunks = [
        fp[a:b].tobytes() for a, b in _chunk_rows(data.count, row_bytes, chunk_limit)
    ]
    smi_chunks = _chunk_strings(data.smiles, chunk_limit)
    id_chunks = _chunk_strings(data.ids, chunk_limit)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        compressed = {
            "fp": list(pool.map(lambda c: qcompress(c, compress_level), fp_chunks)),
            "smi": list(pool.map(lambda c: qcompress(c, compress_level), smi_chunks)),
            "id": list(pool.map(lambda c: qcompress(c, compress_level), id_chunks)),
        }

    for kind in ("fp", "smi", "id"):
        w.write_int32(len(compressed[kind]))
        for c in compressed[kind]:
            w.write_bytearray(c)

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(w.getvalue())
    os.replace(tmp, path)
    _write_fsim_sidecar(path, data)

