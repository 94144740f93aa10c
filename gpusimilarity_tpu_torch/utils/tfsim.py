"""Native sharded database format (``.tfsim`` directory): the port's copy
of ``gpusimilarity_tpu/utils/tfsim.py``.

The reference's only on-disk format is the zlib-compressed ``.fsim`` stream,
which must be fully decompressed and re-laid-out at every server start
(``gpusim.cpp:173-253``). For production restarts at billion-row scale the
rebuild adds a native format designed for the load path:

``<name>.tfsim/``
    ``meta.json``        — version, dbkey, bitcount, count
    ``fingerprints.npy`` — packed ``uint8 (count, bitcount//8)`` rows
    ``smiles.blob`` / ``smiles.idx.npy`` — concatenated bytes + int64 (n,2)
    ``ids.blob``    / ``ids.idx.npy``

String-table layouts (``meta.json``'s optional ``strings`` map, per field):

* ``{"kind": "offsets"}`` (default) — blob + explicit int64 (n, 2) index;
* ``{"kind": "strided", "itemsize": K}`` — fixed-width records, blob only
  (row i = blob[i*K:(i+1)*K]; no 16 GB-at-1B-rows index file);
* ``{"kind": "constant", "value": "..."}`` — every row is the same string,
  no files at all (synthetic benchmark libraries).

Everything memory-maps: startup cost is O(metadata), fingerprints stream to
the device directly from the page cache, and the string tables are the same
zero-copy :class:`StringTable` the engine serves from. ``.fsim`` remains the
interchange format (:func:`convert` goes both ways).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

from .fsim import FingerprintData
from .strings import ConstantStringTable, StridedStringTable, StringTable

# Version 1: fingerprints.npy + "offsets" string tables. Version 2 adds
# the "strided"/"constant" string-table kinds (and the "encoding" field);
# files are stamped v2 only when they actually use one, so v1-only readers
# reject them with a clear version error instead of a missing-file crash.
# Version 3 adds the "synthetic" fingerprint kind (meta "fingerprints":
# {"kind": "synthetic", "seed": N}): rows are the deterministic counter-
# mixer function of their index (utils/synth.py) and no fingerprints.npy
# exists — the storage layer for libraries whose full-width matrix exceeds
# the HOST's disk (a 1.024B-row x 128 B matrix is 122 GB), while string
# tables stay real on-disk blobs.
FORMAT_VERSION = 1
MAX_FORMAT_VERSION = 3


def _save_strings(dirpath: Path, field: str, strings) -> dict:
    """Write one string field under its most compact layout; returns its
    ``meta.json`` descriptor."""
    if isinstance(strings, ConstantStringTable):
        try:
            return {
                "kind": "constant",
                "value": strings.value.decode("utf-8"),
            }
        except UnicodeDecodeError:
            # the table API is bytes-based; latin1 round-trips any byte
            # value through JSON one-to-one
            return {
                "kind": "constant",
                "value": strings.value.decode("latin1"),
                "encoding": "latin1",
            }
    if isinstance(strings, StridedStringTable):
        strings._blob.tofile(dirpath / f"{field}.blob")
        return {"kind": "strided", "itemsize": strings.itemsize}
    if isinstance(strings, StringTable):
        blob, offsets = strings._blob, strings._offsets
    else:
        table = StringTable.from_strings(strings)
        blob, offsets = table._blob, table._offsets
    blob.tofile(dirpath / f"{field}.blob")
    np.save(dirpath / f"{field}.idx.npy", offsets)
    return {"kind": "offsets"}


def _load_strings(dirpath: Path, field: str, desc: dict, count: int, mmap: bool):
    kind = desc.get("kind", "offsets")
    if kind == "constant":
        encoding = desc.get("encoding", "utf-8")
        return ConstantStringTable(desc["value"].encode(encoding), count)
    blob_path = dirpath / f"{field}.blob"
    blob = np.memmap(blob_path, dtype=np.uint8, mode="r") if (
        mmap and blob_path.stat().st_size > 0
    ) else np.fromfile(blob_path, dtype=np.uint8)
    if kind == "strided":
        return StridedStringTable(blob, int(desc["itemsize"]))
    if kind != "offsets":
        raise ValueError(f"unknown string-table kind {kind!r} for {field}")
    offsets = np.load(
        dirpath / f"{field}.idx.npy", mmap_mode="r" if mmap else None
    )
    return StringTable(blob, offsets)


def _format_version(strings_meta: dict, fp_meta: dict | None = None) -> int:
    """Lowest version that can express this file: v3 for synthetic
    fingerprints, v2 for strided/constant strings, else v1."""
    if fp_meta is not None and fp_meta.get("kind") == "synthetic":
        return 3
    needs_v2 = any(
        d.get("kind", "offsets") != "offsets" for d in strings_meta.values()
    )
    return 2 if needs_v2 else FORMAT_VERSION


def _swap_into_place(tmp: Path, path: Path, overwrite: bool) -> None:
    """Rename ``tmp`` onto ``path``; with ``overwrite``, swap the existing
    target aside first and remove it only after the new one is in place —
    the old database survives any failure before this point.

    The window between the two renames is brief but non-atomic: a concurrent
    reader opening ``path`` exactly then sees ENOENT (a directory cannot be
    atomically replaced by rename on Linux). Serving processes keep their
    already-open memory maps either way.
    """
    import shutil

    if path.exists():
        if not overwrite:
            raise FileExistsError(f"{path} already exists")
        # sweep stale .old.* leftovers from crashed earlier runs first: pid
        # reuse could otherwise make the aside name collide (renaming onto
        # an existing non-empty directory raises and aborts the overwrite)
        for stale in path.parent.glob(path.name + ".old.*"):
            if stale.is_dir():
                shutil.rmtree(stale, ignore_errors=True)
            else:
                stale.unlink(missing_ok=True)
        old = path.with_name(path.name + f".old.{os.getpid()}")
        seq = 0
        while old.exists():  # sweep couldn't remove it (e.g. perms): step past
            seq += 1
            old = path.with_name(path.name + f".old.{os.getpid()}.{seq}")
        path.rename(old)
        try:
            tmp.rename(path)
        except Exception:
            old.rename(path)  # restore the previous database
            raise
        if old.is_dir():
            shutil.rmtree(old, ignore_errors=True)
        else:
            old.unlink(missing_ok=True)
    else:
        tmp.rename(path)


def save_native(
    path: str | os.PathLike, data: FingerprintData, overwrite: bool = False
) -> None:
    """Write a ``.tfsim`` directory (atomically: build under a temp name)."""
    data.validate()
    path = Path(path)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=False)
    try:
        # a virtual library's fingerprints exist only once .synth (which
        # imports torch) is loaded: the host tools never import it
        synth = sys.modules.get(f"{__package__}.synth")
        if synth is not None and isinstance(data.fingerprints, synth.VirtualFingerprints):
            fp_meta = {"kind": "synthetic", "seed": data.fingerprints.seed}
        else:
            fp_meta = {"kind": "npy"}
            np.save(
                tmp / "fingerprints.npy",
                np.ascontiguousarray(data.fingerprints),
            )
        strings_meta = {
            field: _save_strings(tmp, field, strings)
            for field, strings in (("smiles", data.smiles), ("ids", data.ids))
        }
        (tmp / "meta.json").write_text(
            json.dumps(
                {
                    "format_version": _format_version(strings_meta, fp_meta),
                    "dbkey": data.dbkey,
                    "bitcount": data.bitcount,
                    "count": data.count,
                    "generator": data.generator,
                    "strings": strings_meta,
                    "fingerprints": fp_meta,
                }
            )
        )
        _swap_into_place(tmp, path, overwrite)
    except Exception:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_native(path: str | os.PathLike, mmap: bool = True) -> FingerprintData:
    """Load a ``.tfsim`` directory; arrays are memory-mapped by default."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    version = meta.get("format_version")
    # type() check, not isinstance: JSON `true` parses to Python True, an
    # int subclass equal to 1 — a corrupt meta.json must error, not load as v1
    if type(version) is not int or not 1 <= version <= MAX_FORMAT_VERSION:
        raise ValueError(f"unsupported .tfsim format version {version}")
    mode = "r" if mmap else None
    fp_meta = meta.get("fingerprints", {"kind": "npy"})
    fp_kind = fp_meta.get("kind", "npy")
    if fp_kind == "synthetic":
        from .synth import VirtualFingerprints

        fingerprints = VirtualFingerprints(
            meta["count"], meta["bitcount"], int(fp_meta.get("seed", 0))
        )
    elif fp_kind == "npy":
        fingerprints = np.load(path / "fingerprints.npy", mmap_mode=mode)
    else:
        raise ValueError(f"unknown fingerprint kind {fp_kind!r}")
    strings_meta = meta.get("strings", {})
    tables = {
        field: _load_strings(
            path, field, strings_meta.get(field, {}), meta["count"], mmap
        )
        for field in ("smiles", "ids")
    }
    data = FingerprintData(
        dbkey=meta["dbkey"],
        bitcount=meta["bitcount"],
        fingerprints=fingerprints,
        smiles=tables["smiles"],
        ids=tables["ids"],
        generator=meta.get("generator", ""),
    )
    if data.count != meta["count"]:
        raise ValueError(
            f"count mismatch: meta says {meta['count']}, data has {data.count}"
        )
    data.validate()
    return data


_NPY_HEADER_LEN = 128  # reserved fixed-size .npy header (v1, padded)


def _write_npy_header(f, shape: tuple, dtype_str: str) -> None:
    """Write a fixed-length numpy v1 header at the file's current start.

    Reserving a constant-size header lets a streaming writer append array
    data with the row count unknown, then seek back and stamp the final
    shape — no rewrite of a ~100 GB file. Padding with spaces is exactly
    what ``np.lib.format`` itself does; only the length is pinned here.
    """
    dict_str = (
        "{'descr': '%s', 'fortran_order': False, 'shape': %s, }"
        % (dtype_str, repr(shape))
    )
    # magic(6) + version(2) + hlen(2) + dict + '\n' == _NPY_HEADER_LEN
    pad = _NPY_HEADER_LEN - 10 - len(dict_str) - 1
    if pad < 0:
        raise ValueError(f"npy header dict too long: {dict_str!r}")
    header = dict_str.encode("latin1") + b" " * pad + b"\n"
    f.seek(0)
    f.write(b"\x93NUMPY" + bytes([1, 0]) + len(header).to_bytes(2, "little"))
    f.write(header)


class TfsimStreamWriter:
    """Stream rows straight into a ``.tfsim`` directory (the same bytes as
    the JAX package's writer for the same batches).

    Building ``.fsim`` and converting afterwards writes the library twice
    and needs all of it in RAM. This writer appends fingerprint rows and
    string records batch-by-batch with O(batch) memory (offsets stream to
    disk too), then stamps the final counts into the reserved npy headers
    on :meth:`close`. Builds atomically under a temp name like
    :func:`save_native`.
    """

    def __init__(
        self,
        path: str | os.PathLike,
        bitcount: int = 1024,
        dbkey: str = "",
        generator: str = "",
        overwrite: bool = False,
        synthetic_seed: int | None = None,
        strided: "dict[str, int] | None" = None,
    ):
        """``synthetic_seed``: write a v3 synthetic-fingerprint database,
        with no ``fingerprints.npy`` (rows are the counter-mixer function of
        their index, ``utils/synth.py``); ``append_batch`` then takes
        ``fingerprints=None``. ``strided``: a fixed record width per field
        (e.g. ``{"ids": 13}``); that field writes a bare fixed-width blob
        with no offsets index (16 bytes a row saved)."""
        self.path = Path(path)
        self._overwrite = overwrite
        if self.path.exists() and not overwrite:
            raise FileExistsError(f"{self.path} already exists")
        self.bitcount = bitcount
        self.dbkey = dbkey
        self.generator = generator
        self.count = 0
        self._row_bytes = bitcount // 8
        self._synthetic_seed = synthetic_seed
        self._strided = dict(strided or {})
        self._tmp = self.path.with_name(self.path.name + f".tmp.{os.getpid()}")
        self._tmp.mkdir(parents=True, exist_ok=False)
        self._fp = None
        if synthetic_seed is None:
            self._fp = open(self._tmp / "fingerprints.npy", "wb")
            self._fp.write(b"\0" * _NPY_HEADER_LEN)
        self._files = {}
        self._offsets = {}
        self._tails = {}
        for field in ("smiles", "ids"):
            self._files[field] = open(self._tmp / f"{field}.blob", "wb")
            if field not in self._strided:
                self._offsets[field] = open(self._tmp / f"{field}.idx.npy", "wb")
                self._offsets[field].write(b"\0" * _NPY_HEADER_LEN)
            self._tails[field] = 0

    def _write_strided(self, field: str, strings) -> int:
        """Write one fixed-width field batch; returns its record count."""
        width = self._strided[field]
        if isinstance(strings, np.ndarray):
            raw = np.ascontiguousarray(strings, dtype=np.uint8).tobytes()
        elif isinstance(strings, (bytes, bytearray, memoryview)):
            raw = bytes(strings)
        else:
            strings = list(strings)
            bad = [s for s in strings if len(s) != width]
            if bad:
                raise ValueError(
                    f"strided field {field!r} needs {width}-byte records; "
                    f"got length {len(bad[0])}"
                )
            raw = b"".join(strings)
        if len(raw) % width:
            raise ValueError(
                f"strided field {field!r}: {len(raw)} bytes is not a "
                f"multiple of record width {width}"
            )
        self._files[field].write(raw)
        return len(raw) // width

    def append_batch(self, fingerprints: "np.ndarray | bytes | None", smiles,
                     ids) -> None:
        """Append rows: packed fingerprint bytes and parallel string batches.

        String batches are ``list[bytes]`` (any field) or, for strided
        fields, raw fixed-width bytes or a ``uint8 (n, width)`` array.
        ``fingerprints`` must be None exactly when the writer is synthetic.
        """
        n = None
        if self._fp is None:
            if fingerprints is not None:
                raise ValueError(
                    "synthetic writer: pass fingerprints=None (rows are "
                    "derived from the index)"
                )
        else:
            if isinstance(fingerprints, (bytes, bytearray, memoryview)):
                fp = np.frombuffer(fingerprints, np.uint8)
            else:
                fp = np.asarray(fingerprints)
                if fp.dtype != np.uint8:
                    # np.asarray(arr, np.uint8) would VALUE-truncate packed
                    # uint32 words (every word mod 256) and write a silently
                    # corrupt database; callers with packed words must pass
                    # row-major bytes (e.g. arr.view/astype explicitly)
                    raise TypeError(
                        f"fingerprints must be raw uint8 bytes, got dtype "
                        f"{fp.dtype}; reinterpret packed words with "
                        ".view(np.uint8) (little-endian rows) instead"
                    )
            fp = np.ascontiguousarray(fp).reshape(-1, self._row_bytes)
            n = fp.shape[0]
            self._fp.write(fp.tobytes())
        for field, strings in (("smiles", smiles), ("ids", ids)):
            if field in self._strided:
                n_field = self._write_strided(field, strings)
            else:
                strings = list(strings)
                n_field = len(strings)
                pos = self._tails[field]
                spans = np.empty((n_field, 2), np.int64)
                for i, s in enumerate(strings):
                    spans[i] = (pos, pos + len(s))
                    pos += len(s)
                self._files[field].write(b"".join(strings))
                self._offsets[field].write(spans.tobytes())
                self._tails[field] = pos
            if n is None:
                n = n_field
            elif n_field != n:
                raise ValueError(
                    f"batch mismatch: {n} rows but {n_field} {field} records"
                )
        self.count += n

    def close(self) -> None:
        """Stamp headers, write meta, atomically rename into place."""
        try:
            if self._fp is not None:
                _write_npy_header(self._fp, (self.count, self._row_bytes), "|u1")
                self._fp.close()
                fp_meta = {"kind": "npy"}
            else:
                fp_meta = {"kind": "synthetic", "seed": self._synthetic_seed}
            strings_meta = {}
            for field in ("smiles", "ids"):
                self._files[field].close()
                if field in self._strided:
                    strings_meta[field] = {
                        "kind": "strided", "itemsize": self._strided[field],
                    }
                else:
                    _write_npy_header(self._offsets[field], (self.count, 2), "<i8")
                    self._offsets[field].close()
                    strings_meta[field] = {"kind": "offsets"}
            (self._tmp / "meta.json").write_text(
                json.dumps(
                    {
                        "format_version": _format_version(strings_meta, fp_meta),
                        "dbkey": self.dbkey,
                        "bitcount": self.bitcount,
                        "count": self.count,
                        "generator": self.generator,
                        "strings": strings_meta,
                        "fingerprints": fp_meta,
                    }
                )
            )
            _swap_into_place(self._tmp, self.path, self._overwrite)
        except Exception:
            self.abort()
            raise

    def abort(self) -> None:
        import shutil

        for f in [self._fp, *self._files.values(), *self._offsets.values()]:
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


def is_native(path: str | os.PathLike) -> bool:
    return Path(path).is_dir() and (Path(path) / "meta.json").exists()


def load_any(path: str | os.PathLike) -> FingerprintData:
    """Load either format by inspection: ``.tfsim`` dir or ``.fsim`` file."""
    if is_native(path):
        return load_native(path)
    from .fsim import read_fsim

    return read_fsim(path)


def convert(src: str | os.PathLike, dst: str | os.PathLike) -> None:
    """Convert between formats by destination extension (.fsim <-> .tfsim)."""
    data = load_any(src)
    if str(dst).endswith(".fsim"):
        from .fsim import write_fsim

        write_fsim(dst, data)
    else:
        save_native(dst, data)
