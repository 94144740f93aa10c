"""ctypes bindings for the native host runtime (``native/libtpusim_native.so``,
the repository's C++ library): the port's copy of
``gpusimilarity_tpu/utils/native.py``, cut to the functions the port calls.

Every entry point has a pure-numpy fallback; the native library is an
accelerator, not a requirement. ``available()`` reports whether it loaded
and :func:`origin` where it came from. The loader tries, in order:

1. ``TPUSIM_NATIVE_LIB``;
2. ``native/libtpusim_native.so`` of the checkout, built by hand with
   ``make -C native`` (then a copy installed beside this file);
3. a build at first use: when none of those loads and the checkout holds
   ``native/tpusim_native.cpp`` and ``native/tsn_chem.cpp``, both are
   compiled with ``native/Makefile``'s flags by ``$CXX`` (else ``g++``) into
   ``<build dir>/tpusim_native-<hash>.so``, the build dir of the CUDA
   kernels (:func:`~.kernels.build_dir`). The hash covers the two sources,
   the flags and the host CPU (:func:`cpu_key`): ``-march=native`` code
   copied to another machine could fault on an instruction its CPU lacks,
   so there it rebuilds. A file lock lets concurrent processes build once;
   later processes load the cached file.

``TPUSIM_NO_NATIVE`` disables the library. Without a compiler or the
sources (an installed package), or when the build fails, every entry point
falls back to numpy, and the process logs one warning that says why (a
failed build's warning carries the compiler's output). ``native/`` is only
read.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .kernels import build_dir

log = logging.getLogger("tpusimilarity")

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("tpusim_native.cpp", "tsn_chem.cpp")
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Werror")
LDFLAGS = ("-shared", "-lz", "-lpthread")
ABI_VERSION = 3  # tsn_version() of the bindings below

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ORIGIN = "not loaded yet"
_LOAD_LOCK = threading.Lock()

_c_u8pp = ctypes.POINTER(ctypes.c_char_p)


class NativeUnavailable(RuntimeError):
    """No library could be built here; the message says why."""


def _candidate_paths():
    env = os.environ.get("TPUSIM_NATIVE_LIB")
    if env:
        yield env
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    yield os.path.join(repo, "native", "libtpusim_native.so")
    yield os.path.join(here, "libtpusim_native.so")


def cpu_key() -> str:
    """What ``-march=native`` compiles for: the machine type and the first
    processor's model and feature flags from ``/proc/cpuinfo``."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the end of the first processor's block
                key = line.split(":", 1)[0].strip()
                if key in ("vendor_id", "model name", "flags", "Features",
                           "CPU implementer", "CPU part"):
                    parts.append(line.strip())
    except OSError:
        pass
    return "\n".join(parts)


def build_name() -> str:
    """``tpusim_native-<16 hex digits>.so``: the hash of the sources' names
    and bytes, the flags and :func:`cpu_key`."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes() + b"\0")
    h.update(" ".join((*CXXFLAGS, "|", *LDFLAGS)).encode() + b"\0")
    h.update(cpu_key().encode())
    return f"tpusim_native-{h.hexdigest()[:16]}.so"


def build(out_dir: Path | None = None) -> tuple[Path, float]:
    """The host runtime compiled from ``native/`` into ``out_dir`` (default
    :func:`~.kernels.build_dir`): ``(path, compile seconds)``, 0.0 when the
    cached file was there. Holds ``<name>.lock`` while it builds, so one of
    several concurrent callers compiles and the rest load its file; the
    compiler writes a temporary file that replaces the target atomically.
    Raises :class:`NativeUnavailable` without the sources or a compiler, or
    when the compile fails (with the compiler's output)."""
    if not all((NATIVE_DIR / name).is_file() for name in SOURCES):
        raise NativeUnavailable(f"no C++ sources at {NATIVE_DIR} to build")
    out_dir = Path(out_dir) if out_dir is not None else build_dir()
    out = out_dir / build_name()
    if out.exists():
        return out, 0.0
    cxx = os.environ.get("CXX") or "g++"
    if shutil.which(cxx) is None:
        raise NativeUnavailable(f"no C++ compiler to build it ({cxx!r} not found)")
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out, 0.0
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}.{threading.get_ident()}")
        cmd = [cxx, *CXXFLAGS, "-o", str(tmp),
               *(str(NATIVE_DIR / name) for name in SOURCES), *LDFLAGS]
        t0 = time.monotonic()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeUnavailable(f"{cxx} could not run: {e}") from e
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeUnavailable(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                + (proc.stdout + proc.stderr).strip()
            )
        os.replace(tmp, out)  # atomic: no process loads half a file
    return out, seconds


def open_library(path) -> ctypes.CDLL:
    """Load ``path`` and declare its functions; raises ``OSError`` when it
    does not load and ``ValueError`` when its ABI is not this module's."""
    lib = ctypes.CDLL(str(path))
    lib.tsn_version.restype = ctypes.c_int
    if lib.tsn_version() != ABI_VERSION:
        raise ValueError(f"{path}: tsn_version {lib.tsn_version()} != {ABI_VERSION}")
    _configure(lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _ORIGIN
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if _TRIED:
            return _LIB
        if os.environ.get("TPUSIM_NO_NATIVE"):
            _ORIGIN = "disabled by TPUSIM_NO_NATIVE"
        else:
            _LIB, _ORIGIN = _find_or_build()
        _TRIED = True
    return _LIB


def _find_or_build() -> tuple[Optional[ctypes.CDLL], str]:
    for path in _candidate_paths():
        if not os.path.exists(path):
            continue
        try:
            return open_library(path), str(path)
        except (OSError, ValueError):
            continue
    try:
        path, seconds = build()
        lib = open_library(path)
    except (NativeUnavailable, OSError, ValueError) as e:
        log.warning("native host runtime unavailable, numpy fallback: %s", e)
        return None, f"numpy fallback ({e})"
    how = f"built in {seconds:.1f}s" if seconds else "cached build"
    return lib, f"{path} ({how})"


def origin() -> str:
    """Where the loaded library came from (a path, and for a build at first
    use whether it was compiled now or cached), or why none loaded."""
    _load()
    return _ORIGIN


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
    lib.tsn_synth_fill.restype = None
    lib.tsn_synth_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_long, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int,
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


def synth_fill(
    n_rows: int,
    word_count: int = 32,
    seed: int = 0,
    row0: int = 0,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Materialise virtual-library rows ``[row0, row0 + n_rows)``
    (``utils/synth.py`` mixer) in bulk: bit-identical to
    ``synth.virtual_rows_np`` and about an order of magnitude faster. The
    bench's full-width oracle holds its library matrix in host RAM this
    way."""
    lib = _load()
    if lib is None:
        raise ImportError("native library not available")
    if out is None:
        out = np.empty((n_rows, word_count), dtype=np.uint32)
    if out.dtype != np.uint32 or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous uint32")
    if out.shape != (n_rows, word_count):
        raise ValueError(f"out must have shape ({n_rows}, {word_count})")
    lib.tsn_synth_fill(_as_void(out), row0, n_rows, word_count, seed, 0)
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
