"""The library a run serves: a version-3 synthetic ``.tfsim`` directory.

Written from the format documented at the top of the program's
``utils/tfsim.py`` and from nothing of the program's code: ``meta.json``
names the synthetic fingerprint kind and the run's seed (the server
generates the rows on the card), and the string tables are the
configuration's. A ``strided`` id table (fixed-width ids, a prefix and
``digits`` characters of ``alphabet``, most significant first) depends on
no seed, so its blob is written once into a fixed directory of the checkout
and linked into each run's library; the SMILES table is a link to the same
blob, so every row's SMILES is its id and no two rows merge as duplicates.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

BLOB_DIR = Path("build") / "benchmark-strings"
_CHUNK_ROWS = 1 << 24


class IdScheme:
    """Fixed-width row ids: ``prefix`` then ``digits`` characters of
    ``alphabet`` for the row index. The server breaks ties between equal
    scores by id, so an alphabet in ASCII order keeps that the row order."""

    def __init__(self, spec: dict):
        self.prefix = spec.get("prefix", "")
        self.alphabet = spec["alphabet"]
        self.digits = int(spec["digits"])
        self.width = len(self.prefix) + self.digits
        self._value = {ch: v for v, ch in enumerate(self.alphabet)}

    def capacity(self) -> int:
        return len(self.alphabet) ** self.digits

    def encode(self, idx: np.ndarray) -> np.ndarray:
        """``uint8 (n, width)`` ids of rows ``idx``."""
        idx = np.asarray(idx, np.int64)
        base = len(self.alphabet)
        table = np.frombuffer(self.alphabet.encode(), np.uint8)
        out = np.empty((len(idx), self.width), np.uint8)
        out[:, :len(self.prefix)] = np.frombuffer(self.prefix.encode(), np.uint8)
        rest = idx.copy()
        for d in range(self.width - 1, len(self.prefix) - 1, -1):
            rest, digit = np.divmod(rest, base)
            out[:, d] = table[digit]
        return out

    def text(self, idx: int) -> str:
        """The id of row ``idx``."""
        return self.encode(np.array([idx]))[0].tobytes().decode()

    def decode(self, text) -> int | None:
        """The row an id names, or None."""
        if (not isinstance(text, str) or len(text) != self.width
                or not text.startswith(self.prefix)):
            return None
        v = 0
        for ch in text[len(self.prefix):]:
            d = self._value.get(ch)
            if d is None:
                return None
            v = v * len(self.alphabet) + d
        return v


def id_blob(root: Path, config_name: str, rows: int, scheme: IdScheme,
            log=print) -> Path:
    """The strided id blob of ``rows`` rows under the checkout's fixed blob
    directory, written (atomically) only if it is not there yet."""
    if rows > scheme.capacity():
        raise ValueError(f"{rows} rows exceed the id scheme's {scheme.capacity()}")
    tag = hashlib.sha256(f"{scheme.prefix}|{scheme.alphabet}|{scheme.digits}".encode())
    path = root / BLOB_DIR / f"{config_name}.ids-{tag.hexdigest()[:12]}.blob"
    if path.exists() and path.stat().st_size == rows * scheme.width:
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".partial")
    with open(tmp, "wb") as f:
        for lo in range(0, rows, _CHUNK_ROWS):
            scheme.encode(np.arange(lo, min(rows, lo + _CHUNK_ROWS))).tofile(f)
    os.replace(tmp, path)
    log(f"wrote {rows * scheme.width} bytes of ids to {path}")
    return path


def _link(src: Path, dst: Path) -> None:
    try:
        os.link(src, dst)
    except OSError:  # another filesystem: a symbolic link maps the same
        os.symlink(src.resolve(), dst)


def write_library(directory: Path, root: Path, config: dict, seed: int,
                  log=print) -> Path:
    """Write the run's ``<name>.tfsim`` under ``directory``; returns it."""
    lib = config
    path = directory / f"{lib['database']}.tfsim"
    path.mkdir(parents=True)
    strings = {}
    ids = lib["ids"]
    if ids["kind"] == "strided":
        scheme = IdScheme(ids)
        blob = id_blob(root, config["name"], lib["rows"], scheme, log)
        for field in ("ids", "smiles"):
            _link(blob, path / f"{field}.blob")
            strings[field] = {"kind": "strided", "itemsize": scheme.width}
    else:
        raise ValueError(f"unknown id kind {ids['kind']!r}")
    meta = {
        "format_version": 3,
        "dbkey": lib.get("dbkey", ""),
        "bitcount": lib["bitcount"],
        "count": lib["rows"],
        "generator": "",
        "strings": strings,
        "fingerprints": {"kind": "synthetic", "seed": int(seed)},
    }
    (path / "meta.json").write_text(json.dumps(meta))
    return path
