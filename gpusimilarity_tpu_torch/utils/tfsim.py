"""Native sharded database format (``.tfsim`` directory): the port's copy
of ``gpusimilarity_tpu/utils/tfsim.py``, its reader and writer (the
streaming writer and the format converter are not ported).

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
interchange format.
"""

from __future__ import annotations

import json
import os
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
        from .synth import VirtualFingerprints

        if isinstance(data.fingerprints, VirtualFingerprints):
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


def is_native(path: str | os.PathLike) -> bool:
    return Path(path).is_dir() and (Path(path) / "meta.json").exists()


def load_any(path: str | os.PathLike) -> FingerprintData:
    """Load either format by inspection: ``.tfsim`` dir or ``.fsim`` file."""
    if is_native(path):
        return load_native(path)
    from .fsim import read_fsim

    return read_fsim(path)

