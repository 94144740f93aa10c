"""PyTorch port: the native host runtime built at first use
(``gpusimilarity_tpu_torch/utils/native.py``), on the CPU.

The loader compiles ``native/tpusim_native.cpp`` and ``native/tsn_chem.cpp``
with ``native/Makefile``'s flags into ``<build dir>/tpusim_native-<hash>.so``
when no hand-built library loads. Pinned here: a build loads with the ABI the
bindings expect; its rescore and fold equal the numpy fallback; a second load
reuses the cached file; the name follows the flags and the CPU; two processes
building at once both load one file; ``TPUSIM_NO_NATIVE`` disables it; and
without a compiler the numpy path runs after exactly one warning. The builds
need ``g++`` and zlib's header, and the tests skip without them.
"""

import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpusimilarity_tpu_torch.models.fingerprint_db import rescore_rows
from gpusimilarity_tpu_torch.ops import fold as fold_ops
from gpusimilarity_tpu_torch.ops.scan import scores_np
from gpusimilarity_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]


def _can_build() -> bool:
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        return False
    probe = subprocess.run(
        [os.environ.get("CXX") or "g++", "-E", "-x", "c++", "-"],
        input="#include <zlib.h>\n", capture_output=True, text=True)
    return probe.returncode == 0


@pytest.fixture(scope="module")
def toolchain():
    if not _can_build():
        pytest.skip("no g++ with zlib's header here: the host runtime cannot build")


@pytest.fixture(scope="module")
def built(toolchain, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("native_build")
    path, seconds = native.build(out_dir)
    return out_dir, path, seconds


@pytest.fixture
def fresh_loader(monkeypatch):
    """The loader's process state, reset for one test and restored after."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_ORIGIN", "not loaded yet")


def test_a_build_loads_with_the_bindings_abi(built):
    out_dir, path, seconds = built
    assert path.parent == out_dir and seconds > 0
    assert path.name == native.build_name() and path.name.startswith("tpusim_native-")
    lib = native.open_library(path)
    assert lib.tsn_version() == 3 == native.ABI_VERSION
    assert sorted(p.name for p in out_dir.iterdir()) == [path.name, path.name + ".lock"]


@pytest.mark.parametrize("similarity,ab", [("tanimoto", (1.0, 1.0)),
                                           ("tversky", (0.7, 0.3))])
def test_built_rescore_and_fold_equal_the_numpy_fallback(built, fresh_loader,
                                                         monkeypatch, similarity, ab):
    rng = np.random.default_rng(31)
    words = (rng.integers(0, 2**32, size=(3000, 32), dtype=np.uint32)
             & rng.integers(0, 2**32, size=(3000, 32), dtype=np.uint32))
    query = words[17] | words[1200]
    idx = np.sort(rng.choice(3000, 400, replace=False))
    want = scores_np(words[idx], query[None, :], similarity, *ab)[0]
    folds = {f: np.bitwise_or.reduce(words.reshape(3000, f, 32 // f), axis=1)
             for f in (2, 4, 8)}

    monkeypatch.setattr(native, "_LIB", native.open_library(built[1]))
    monkeypatch.setattr(native, "_TRIED", True)
    assert native.available()
    got = native.rescore(words, idx, query, *ab, similarity == "tversky")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        rescore_rows(words, idx, query, similarity, *ab), want)
    for f, plain in folds.items():
        np.testing.assert_array_equal(native.fold_rows(words, f), plain)
        np.testing.assert_array_equal(fold_ops.fold_words(words, f), plain)


def test_a_second_load_reuses_the_cached_file(built):
    out_dir, path, _ = built
    mtime = path.stat().st_mtime_ns
    again, seconds = native.build(out_dir)
    assert (again, seconds) == (path, 0.0)
    assert path.stat().st_mtime_ns == mtime
    assert native.open_library(again).tsn_version() == 3


def test_the_name_follows_the_flags_and_the_cpu(monkeypatch):
    name = native.build_name()
    assert native.build_name() == name
    cpu = native.cpu_key()
    monkeypatch.setattr(native, "cpu_key", lambda: cpu + " avx512f")
    assert native.build_name() != name
    monkeypatch.setattr(native, "cpu_key", lambda: cpu)
    assert native.build_name() == name
    flags = native.CXXFLAGS
    monkeypatch.setattr(native, "CXXFLAGS", flags + ("-DNDEBUG",))
    assert native.build_name() != name
    monkeypatch.setattr(native, "CXXFLAGS", tuple(f for f in flags if f != "-march=native"))
    assert native.build_name() != name
    monkeypatch.setattr(native, "CXXFLAGS", flags)
    assert native.build_name() == name
    assert native.CXXFLAGS == ("-O3", "-march=native", "-fPIC", "-std=c++17",
                               "-Wall", "-Werror")
    assert native.LDFLAGS == ("-shared", "-lz", "-lpthread")
    makefile = (REPO / "native" / "Makefile").read_text()
    assert " ".join(native.CXXFLAGS) in makefile and " ".join(native.LDFLAGS) in makefile


BUILD_ONE = (
    "import sys\n"
    "from gpusimilarity_tpu_torch.utils import native\n"
    "path, seconds = native.build(sys.argv[1])\n"
    "print(path, seconds, native.open_library(path).tsn_version())\n"
)


def test_two_processes_building_at_once_both_load_one_file(toolchain, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = [out.split() for out, _ in outs]
    assert lines[0][0] == lines[1][0] and [ln[2] for ln in lines] == ["3", "3"]
    assert sorted(float(ln[1]) > 0 for ln in lines) == [False, True]  # one compiled
    assert sorted(p.name for p in tmp_path.glob("*.so")) == [Path(lines[0][0]).name]
    assert not list(tmp_path.glob("*.tmp.*"))


def test_tpusim_no_native_disables_it(fresh_loader, monkeypatch):
    monkeypatch.setenv("TPUSIM_NO_NATIVE", "1")
    assert native._load() is None and not native.available()
    assert "TPUSIM_NO_NATIVE" in native.origin()


def test_no_compiler_falls_back_to_numpy_with_one_warning(
        fresh_loader, monkeypatch, tmp_path, caplog):
    monkeypatch.setenv("CXX", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("TPUSIM_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_candidate_paths", lambda: iter(()))
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path)
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(2000, 32), dtype=np.uint32)
    idx = np.arange(0, 2000, 7)
    with caplog.at_level(logging.WARNING, logger="tpusimilarity"):
        assert not native.available()
        assert not native.available()
        got = rescore_rows(words, idx, words[3])
        folded = fold_ops.fold_words(words, 4)
    np.testing.assert_array_equal(got, scores_np(words[idx], words[3][None, :])[0])
    grouped = words.reshape(2000, 4, 8)
    np.testing.assert_array_equal(folded, np.bitwise_or.reduce(grouped, axis=1))
    warnings = [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert len(warnings) == 1, [r.getMessage() for r in warnings]
    assert "/nonexistent" in warnings[0].getMessage()
    assert "numpy fallback" in native.origin()
    assert list(tmp_path.iterdir()) == []  # nothing was written
