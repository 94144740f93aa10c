"""PyTorch port: the measurement tools under ``gpusimilarity_tpu_torch/
tools/`` through their ``main`` (``--cpu_only``, miniature sizes):
``fold_accuracy`` and ``fold_scale`` against the root tools of the JAX
package on the same inputs (JAX on the CPU, as ``tests/test_tools.py`` runs
them), the load test and the flagship server bench (each serving through a
``cli.server`` subprocess) exact end to end."""

import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here and in every subprocess (the servers, the root
    tools): the suite runs several workers at once, and torch's default of
    a thread per core, oversubscribed, slows these small host runs by 10x or
    more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)


def _run(args, timeout=300, expect_rc=0):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, *map(str, args)], cwd=REPO, env=env, timeout=timeout,
        capture_output=True, text=True,
    )
    if expect_rc is not None:
        assert out.returncode == expect_rc, out.stderr[-3000:]
    return out


def _line(out) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _port(capsys, name, *args) -> dict:
    """The port tool's ``main`` in this process; its JSON line, parsed."""
    import importlib

    main = importlib.import_module(f"gpusimilarity_tpu_torch.tools.{name}").main
    capsys.readouterr()
    assert main([str(a) for a in args]) == 0
    return _line(capsys.readouterr().out)


def _root_tool(capsys, monkeypatch, script, *args) -> dict:
    """A root tool run in this process (JAX already on the CPU here)."""
    monkeypatch.setattr(sys, "argv", [script, *map(str, args)])
    capsys.readouterr()
    runpy.run_path(os.path.join(REPO, script), run_name="__main__")
    return _line(capsys.readouterr().out)


@pytest.mark.parametrize("data", ["clustered", "random"])
def test_fold_accuracy_matches_the_root_tool(data, capsys, monkeypatch):
    """Every field equal but ``wall_s``; the random data (the adversarial
    case) misses rows at every fold, so the counts are compared where they
    are not zero."""
    args = ("--rows", 20000, "--queries", 10, "--data", data)
    want = _root_tool(capsys, monkeypatch, "tools/fold_accuracy.py", *args)
    got = _port(capsys, "fold_accuracy", *args, "--cpu_only")
    want.pop("wall_s")
    got.pop("wall_s")
    assert got == want
    if data == "random":
        assert all(got[f"fold{f}_mismatch_pct"] > 0 for f in (2, 4, 8))


@pytest.mark.parametrize("mode,and_slabs", [("dense", 1), ("bitplane", 4)])
def test_fold_scale_matches_the_root_tool(mode, and_slabs, tmp_path, capsys):
    """The generated library is byte-equal to the root tool's, and the
    searches are exact in both."""
    args = ("--rows", 65536, "--queries", 2, "--fold", 2, "--mode", mode,
            "--and_slabs", and_slabs)
    want = _line(_run(["tools/fold_scale.py", "--cpu", *args,
                       "--dir", tmp_path / "jax"]).stdout)
    got = _port(capsys, "fold_scale", "--cpu_only", *args, "--dir", tmp_path / "port")
    name = f"rows65536{'' if and_slabs == 1 else f'_d{and_slabs}'}.tfsim"
    for f in ("fingerprints.npy", "ids.blob", "smiles.blob", "meta.json"):
        assert (tmp_path / "port" / name / f).read_bytes() == \
            (tmp_path / "jax" / name / f).read_bytes(), f
    for field in ("exact_self_match", "rows", "fold", "mode", "k"):
        assert got[field] == want[field], field
    assert got["exact_self_match"] == "2/2"


@pytest.mark.parametrize("preset", ["loadtest", "loadtest104"])
def test_loadtest_miniature_is_exact(preset, tmp_path, capsys):
    p = _port(capsys, "loadtest", "--preset", preset, "--rows", 20000,
              "--clients", 4, "--dir", tmp_path, "--cpu_only")
    warmup = 15 if preset == "loadtest" else 63
    assert p["failures"] == 0 and p["requests"] == 512 + warmup == p["searches"]
    assert p["cold_samples"] == p["warm_samples"] == 256
    assert p["warm_qps"] > 0 and p["warm_p99_ms"] >= p["warm_p50_ms"]
    assert p["rows"] == 20000 and p["card"] == "cpu"
    assert p["kernel_launches"] == {"bitplane_phase1": 0, "bitplane_rescore": 0,
                                    "dense_phase1": 0}


def _virtual_library(path: Path, n: int):
    """A synthetic ``.tfsim`` (rows a function of their index) with
    ``SYN%010d`` ids and smiles."""
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
    from gpusimilarity_tpu_torch.utils.strings import StridedStringTable
    from gpusimilarity_tpu_torch.utils.synth import VirtualFingerprints
    from gpusimilarity_tpu_torch.utils.tfsim import save_native

    ids = StridedStringTable.from_strings(f"SYN{i:010d}".encode() for i in range(n))
    save_native(path, FingerprintData(
        dbkey="virt", fingerprints=VirtualFingerprints(n, 1024, 3),
        smiles=ids, ids=ids,
    ))
    return path


@pytest.mark.parametrize("library", ["fold_scale", "virtual"])
def test_flagship_server_bench_miniature_is_exact(library, tmp_path, capsys):
    if library == "virtual":
        lib = _virtual_library(tmp_path / "virt.tfsim", 20000)
    else:
        from gpusimilarity_tpu_torch.tools.fold_scale import generate_tfsim, library_path

        lib = library_path(tmp_path, 20000, 4)
        generate_tfsim(lib, 20000, and_slabs=4)
    p = _port(capsys, "flagship_server_bench", "--lib", lib, "--queries", 4,
              "--fold", 4, "--cpu_only")
    assert p["exactness_checks_passed"] == "4/4"
    assert p["fold"] == 4 and p["scan_mode"] == "dense" and p["rows"] == 20000
    assert p["samples"] == 4 and p["card"] == "cpu"


def test_tools_raise_without_a_card(tmp_path):
    """No fallback to the host: without ``--cpu_only`` a tool run on a
    machine without a card exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run(["-m", "gpusimilarity_tpu_torch.tools.fold_accuracy", "--rows", 2000,
                "--queries", 2], expect_rc=None)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device available" in out.stderr
    from gpusimilarity_tpu_torch.tools import fold_scale

    with pytest.raises(RuntimeError, match="no CUDA device available"):
        fold_scale.main(["--rows", "4096", "--queries", "1", "--dir", str(tmp_path)])


def test_fold_scale_library_reads_back_through_the_port_loader(tmp_path):
    """What the load tests and the flagship bench serve: the generated rows
    read back through the port's loader, ids naming their rows."""
    from gpusimilarity_tpu_torch.tools.fold_scale import generate_tfsim, library_path
    from gpusimilarity_tpu_torch.utils.tfsim import load_native

    path = library_path(tmp_path, 5000, 4)
    generate_tfsim(path, 5000, and_slabs=4)
    data = load_native(path)
    assert data.count == 5000 and data.dbkey == "scale"
    assert data.ids[4321] == b"SYN0000004321" == data.smiles[4321]
    # 4 slabs ANDed: about 1/16 of the bits
    density = np.unpackbits(np.asarray(data.fingerprints)).mean()
    assert 0.05 < density < 0.075
