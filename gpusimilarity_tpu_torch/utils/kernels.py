"""Build the package's CUDA sources on first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``<build dir>/<name>-<source hash>.so``, with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v

and never ``--use_fast_math``: the kernels must divide with correct IEEE
rounding to match the plain PyTorch versions bit for bit. The source hash
names the library, so an edited source rebuilds and an unchanged one loads
the cached build. A failed build raises with the compiler's output.

The build dir is ``build/gpusim_torch`` in the checkout when the package
runs from source (``build/`` is git-ignored), and ``gpusim_torch`` under
the user's cache directory (``$XDG_CACHE_HOME``, else ``~/.cache``) when it
is installed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every kernel of the package, by source name
KERNELS = ("bitplane_phase1", "dense_phase1", "mxu_phase1")

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LOADED: dict[str, "Build"] = {}


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


def load(name: str) -> Build:
    """Build ``csrc/<name>.cu`` if no build of this exact source exists, then
    load it. Thread-safe, one lock per kernel; later calls return the
    loaded library."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        build = _LOADED.get(name)
        if build is not None:
            return build
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = build_dir() / f"{name}-{digest}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            seconds, log = _compile(src, out)
        build = Build(ctypes.CDLL(str(out)), out, seconds, log)
        _LOADED[name] = build
        return build
