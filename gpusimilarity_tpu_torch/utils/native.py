"""ctypes bindings for the native host runtime (``native/libtpusim_native.so``,
the repository's C++ library): the port's copy of
``gpusimilarity_tpu/utils/native.py``, cut to the functions the port calls.

Every entry point has a pure-numpy fallback; the native library is an
accelerator, not a requirement. ``available()`` reports whether it loaded.
Build with ``make -C native``; the loader also honors ``TPUSIM_NATIVE_LIB``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_c_u8pp = ctypes.POINTER(ctypes.c_char_p)


def _candidate_paths():
    env = os.environ.get("TPUSIM_NATIVE_LIB")
    if env:
        yield env
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    yield os.path.join(repo, "native", "libtpusim_native.so")
    yield os.path.join(here, "libtpusim_native.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TPUSIM_NO_NATIVE"):
        return None
    for path in _candidate_paths():
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
            lib.tsn_version.restype = ctypes.c_int
            if lib.tsn_version() != 3:
                continue
            _configure(lib)
            _LIB = lib
            break
        except OSError:
            continue
    return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    lib.tsn_decompress_chunks.restype = ctypes.c_int
    lib.tsn_decompress_chunks.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
        ctypes.c_int,
    ]
    lib.tsn_parse_string_records.restype = ctypes.c_long
    lib.tsn_parse_string_records.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
    ]
    lib.tsn_fold_rows.restype = None
    lib.tsn_fold_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.tsn_rescore.restype = None
    lib.tsn_rescore.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.tsn_synth_rescore.restype = None
    lib.tsn_synth_rescore.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.tsn_smiles_fingerprint.restype = ctypes.c_long
    lib.tsn_smiles_fingerprint.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
    ]


def available() -> bool:
    return _load() is not None


def _as_void(arr: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(arr.ctypes.data)


def decompress_chunks(chunks: Sequence[bytes | memoryview]) -> list[np.ndarray]:
    """Parallel qUncompress of framed chunks -> list of uint8 arrays.

    Returns None-equivalent fallback signal by raising ImportError when the
    native library is unavailable (callers catch and use zlib).
    """
    lib = _load()
    if lib is None:
        raise ImportError("native library not available")
    n = len(chunks)
    srcs = [np.frombuffer(c, dtype=np.uint8) for c in chunks]
    import struct

    dst_lens = []
    for s in srcs:
        if len(s) < 4:
            raise ValueError("chunk shorter than qCompress header")
        dst_lens.append(struct.unpack(">I", s[:4].tobytes())[0])
    dsts = [np.empty(dl, dtype=np.uint8) for dl in dst_lens]

    src_ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
    src_lens = (ctypes.c_long * n)(*[len(s) for s in srcs])
    dst_ptrs = (ctypes.c_void_p * n)(*[d.ctypes.data for d in dsts])
    dst_lens_c = (ctypes.c_long * n)(*dst_lens)
    rc = lib.tsn_decompress_chunks(src_ptrs, src_lens, dst_ptrs, dst_lens_c, n, 0)
    if rc != 0:
        raise ValueError(f"chunk {rc - 1} failed to decompress")
    return dsts


def parse_string_records(buf: np.ndarray) -> np.ndarray:
    """Parse writeString records -> int64 offsets array of shape (n, 2)."""
    lib = _load()
    if lib is None:
        raise ImportError("native library not available")
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    # each record is >= 5 bytes (len + payload>=0 + NUL) except null records (4)
    max_strings = len(buf) // 4 + 1
    offsets = np.empty((max_strings, 2), dtype=np.int64)
    count = lib.tsn_parse_string_records(
        _as_void(buf), len(buf), _as_void(offsets), max_strings
    )
    if count == -1:
        raise ValueError("malformed string record stream")
    if count == -2:
        raise ValueError("string record stream overflow")
    return offsets[:count]


def fold_rows(words: np.ndarray, fold: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise ImportError("native library not available")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n, w = words.shape
    if w % fold:
        raise ValueError("fold must divide word count")
    out = np.empty((n, w // fold), dtype=np.uint32)
    lib.tsn_fold_rows(_as_void(words), n, w, fold, _as_void(out), 0)
    return out


def rescore(
    words: np.ndarray,
    rows: np.ndarray,
    query: np.ndarray,
    alpha: float = 1.0,
    beta: float = 1.0,
    tversky: bool = False,
) -> np.ndarray:
    """Exact Tanimoto/Tversky scores of ``words[rows]`` against one query.

    The folded-scan recovery path (reference re-scores candidates on CPU,
    ``fingerprintdb_cuda.cu:307-331``): candidates are few (k * overfetch),
    so a host popcount loop beats staging a gather onto the device.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native library not available")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    query = np.ascontiguousarray(query, dtype=np.uint32)
    w = words.shape[1]
    if query.shape != (w,):
        raise ValueError(f"query must be ({w},) packed words")
    # imported here: the host-only modules (createdb and its workers) load
    # this file and must not import torch
    from ..ops.scan import popcount_rows_np

    qpop = int(popcount_rows_np(query[None, :])[0])
    out = np.empty(len(rows), dtype=np.float32)
    lib.tsn_rescore(
        _as_void(words), w, _as_void(rows), len(rows), _as_void(query),
        qpop, alpha, beta, 1 if tversky else 0, _as_void(out),
    )
    return out


def synth_rescore(
    rows: np.ndarray,
    query: np.ndarray,
    seed: int = 0,
    alpha: float = 1.0,
    beta: float = 1.0,
    tversky: bool = False,
) -> np.ndarray:
    """Exact scores of virtual-library rows (by index) against one query.

    The fold-benchmark's timed rescore: same scoring as :func:`rescore`
    but candidate rows are recomputed from the ``utils/synth.py`` mixer
    instead of read from a host matrix. Pass ``rows`` index-sorted so the
    native cluster-core cache hits.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native library not available")
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    query = np.ascontiguousarray(query, dtype=np.uint32)
    from ..ops.scan import popcount_rows_np

    qpop = int(popcount_rows_np(query[None, :])[0])
    out = np.empty(len(rows), dtype=np.float32)
    lib.tsn_synth_rescore(
        _as_void(rows), len(rows), _as_void(query), len(query), seed,
        qpop, alpha, beta, 1 if tversky else 0, _as_void(out),
    )
    return out


def smiles_fingerprint(
    smiles: str, radius: int = 2, nbits: int = 1024
) -> tuple[bytes, bytes]:
    """SMILES -> (packed Morgan fingerprint bytes, canonical SMILES bytes).

    The native chemistry pipeline (``native/tsn_chem.cpp``) — byte-exact
    with the Python ``smiles.py``/``rdmorgan.py`` stack but ~6x faster;
    raises ``ValueError`` on unparseable input (the Python path raises
    ``SmilesError``; ``fingerprints.py`` normalizes both)."""
    lib = _load()
    if lib is None:
        raise ImportError("native library not available")
    if nbits % 8:
        raise ValueError("nbits must be a multiple of 8")
    fp = ctypes.create_string_buffer(nbits // 8)
    cap = max(4096, 8 * len(smiles) + 64)
    canon = ctypes.create_string_buffer(cap)
    rc = lib.tsn_smiles_fingerprint(
        smiles.encode("utf-8"), radius, nbits,
        ctypes.cast(fp, ctypes.c_void_p), canon, cap,
    )
    if rc == -2:  # canonical output larger than the generous buffer
        raise ValueError("canonical SMILES too long")
    if rc < 0:
        raise ValueError("Bad structure")
    return fp.raw, canon.value
