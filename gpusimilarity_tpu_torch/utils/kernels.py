"""Build the package's CUDA sources on first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``<build dir>/<name>-<source hash>.so``, with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v

and never ``--use_fast_math``: the kernels must divide with correct IEEE
rounding to match the plain PyTorch versions bit for bit. The hash of the
source, of every header under ``csrc/`` it includes (``#include "x.cuh"``,
followed through the headers) and of the flags names the library, so an
edited source or header rebuilds and an unchanged one loads the cached
build. A failed build raises with the compiler's output.

The build dir is ``build/gpusim_torch`` in the checkout when the package
runs from source (``build/`` is git-ignored), and ``gpusim_torch`` under
the user's cache directory (``$XDG_CACHE_HOME``, else ``~/.cache``) when it
is installed.

Every launch of a kernel goes through this module: a wrapper in ``ops/``
binds its C entry once (:func:`bind`), checks its inputs
(:func:`check_inputs`) and calls :func:`launch`, which runs the entry on
the tensors' card and stream, raises on its error code and counts the
launch (:func:`launches`, :func:`launch_counts`). Adding a kernel is a
``csrc/<name>.cu``, its wrapper ``ops/<name>.py`` and its name here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the kernels one search pass launches, by scan mode, its phase 1 first
PASS_KERNELS = {
    "bitplane": ("bitplane_phase1", "bitplane_rescore"),
    "dense": ("dense_phase1",),
}
# the kernels a server builds and counts in /stats
SERVED = tuple(name for names in PASS_KERNELS.values() for name in names)
# every kernel of the package, by source name: the served ones and the
# matrix-product scan, which only its probe runs
KERNELS = (*SERVED, "mxu_phase1")

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LOADED: dict[str, "Build"] = {}
_BOUND: dict[tuple[str, str], object] = {}
_COUNT_LOCK = threading.Lock()
_LAUNCHES: Counter[str] = Counter()


@dataclass(frozen=True)
class Build:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time; 0.0 when the cached build was loaded
    log: str  # nvcc's output (ptxas register/shared-memory report)


def build_dir(pkg: Path = _PKG) -> Path:
    """Where kernels are built: in the source tree that holds ``pkg`` (its
    parent has the ``pyproject.toml``), else in the user's cache directory."""
    checkout = pkg.parent
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "gpusim_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "gpusim_torch"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build kernels")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_files(src: Path) -> list[Path]:
    """``src`` and every header it includes by a quoted name, directly or
    through another such header, that exists beside it; in inclusion order,
    each once."""
    found: list[Path] = []
    todo = [src]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        names = _INCLUDE.findall(path.read_bytes())
        todo.extend(
            h for h in (path.parent / n.decode() for n in reversed(names))
            if h.is_file()
        )
    return found


def source_digest(src: Path) -> str:
    """The 16 hex digits that name a build of ``src``: its bytes, its
    headers' and the compiler flags."""
    h = hashlib.sha256()
    for path in source_files(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(src: Path, out: Path) -> tuple[float, str]:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {src.name}:\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return seconds, log


def load_all(names=KERNELS) -> dict[str, Build]:
    """:func:`load` every kernel, the nvcc runs started together."""
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source (and
    the headers it includes) exists: ``(path, seconds, nvcc's output)``,
    ``(path, 0.0, "")`` for the cached build. Needs nvcc, not a card: an
    image build runs it to ship the kernels compiled."""
    src = CSRC / f"{name}.cu"
    out = build_dir() / f"{name}-{source_digest(src)}.so"
    if out.exists():
        return out, 0.0, ""
    return (out, *_compile(src, out))


def load(name: str) -> Build:
    """:func:`build` ``csrc/<name>.cu``, then load it. Thread-safe, one lock
    per kernel; later calls return the loaded library."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        loaded = _LOADED.get(name)
        if loaded is not None:
            return loaded
        out, seconds, log = build(name)
        loaded = Build(ctypes.CDLL(str(out)), out, seconds, log)
        _LOADED[name] = loaded
        return loaded


def bind(kernel: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of ``kernel``'s library (:func:`load`),
    its signature declared once; later calls return the same function."""
    fn = _BOUND.get((kernel, symbol))
    if fn is None:
        fn = getattr(load(kernel).lib, symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        _BOUND[(kernel, symbol)] = fn
    return fn


def launch(kernel: str, fn, device, *args, n: int = 1) -> None:
    """``fn(*args, stream)``: one call of ``kernel``'s bound C entry on the
    current stream of ``device``, the tensors' card, made the thread's
    current device for the call (the C launchers work on it: a shard on
    another card, a card's worker thread). Raises ``RuntimeError`` with the
    library's error string if the entry returns non-zero; otherwise counts
    ``n``, the kernel launches the call made."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        error = bind(kernel, "gpusim_error_string", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{kernel} kernel launch failed: {error(rc).decode()}")
    with _COUNT_LOCK:
        _LAUNCHES[kernel] += n


def launches(kernel: str) -> int:
    """``kernel``'s launches since the last :func:`reset_launches`."""
    return _LAUNCHES[kernel]


def launch_counts(names=SERVED) -> dict[str, int]:
    """``{name: launches}`` of ``names``, by default the served kernels."""
    with _COUNT_LOCK:
        return {name: _LAUNCHES[name] for name in names}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    with _COUNT_LOCK:
        _LAUNCHES.clear()


def check_inputs(specs, device=None) -> None:
    """Raise ``ValueError`` unless every ``(tensor, dtype, shape)`` of
    ``specs`` is contiguous, of that dtype and shape, and on ``device``
    (by default the first tensor's)."""
    specs = list(specs)
    if device is None:
        device = specs[0][0].device
    for t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"expected contiguous {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != device:
            raise ValueError("all inputs must be on one device")
