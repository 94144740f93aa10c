"""PyTorch port: the streamed ``.tfsim`` writer's synthetic and strided
layouts, ``VirtualWords.rescore``, and the scale tools ``northstar`` and
``chem_scale`` against the JAX package's (the root ``tools/``, JAX on the
CPU) at miniature sizes: the same files, oracles and checked fields."""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gpusimilarity_tpu.utils.synth as jsynth
import gpusimilarity_tpu.utils.tfsim as jtfsim
from gpusimilarity_tpu_torch.models.fingerprint_db import rescore_rows
from gpusimilarity_tpu_torch.utils import native as pnative
from gpusimilarity_tpu_torch.utils import synth as psynth
from gpusimilarity_tpu_torch.utils import tfsim as ptfsim

REPO = Path(__file__).resolve().parent.parent
WRITERS = {"jax": jtfsim.TfsimStreamWriter, "port": ptfsim.TfsimStreamWriter}
LOADERS = {"jax": jtfsim.load_native, "port": ptfsim.load_native}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One torch thread here and in every subprocess (the tools and their
    servers): the suite runs several workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _files(path: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


# ------------------------------------------------------------------ writer


def _strided_batches(layout):
    """Three batches of 1000 rows: SMILES-like 8-byte records as a uint8
    array, raw bytes and a list; ids as ``SYN%010d`` lists, or offsets."""
    for b in range(3):
        lo = 1000 * b
        smiles = [b"C%07d" % i for i in range(lo, lo + 1000)]
        ids = [b"SYN%010d" % i for i in range(lo, lo + 1000)]
        if b == 0:
            smiles = np.frombuffer(b"".join(smiles), np.uint8).reshape(-1, 8)
        elif b == 1:
            smiles = b"".join(smiles)
        if layout == "offsets_ids":
            ids = [f"ID{i}".encode() for i in range(lo, lo + 1000)]
        yield smiles, ids


@pytest.mark.parametrize("layout", ["strided_both", "offsets_ids"])
@pytest.mark.parametrize("synthetic", [True, False])
def test_writer_writes_what_the_jax_writer_writes(tmp_path, layout, synthetic):
    """Synthetic fingerprints (v3) and fixed-width string fields (v2): the
    two writers' directories are equal file by file, and each package
    loads the other's."""
    strided = {"smiles": 8, "ids": 13} if layout == "strided_both" else {"smiles": 8}
    rng = np.random.default_rng(2)
    fps = [np.packbits(rng.random((1000, 1024)) < 0.1, axis=1, bitorder="little")
           for _ in range(3)]
    for side, cls in WRITERS.items():
        kw = {"synthetic_seed": 9} if synthetic else {}
        with cls(tmp_path / f"{side}.tfsim", dbkey="w", generator="g",
                 strided=strided, **kw) as w:
            for b, (smiles, ids) in enumerate(_strided_batches(layout)):
                w.append_batch(None if synthetic else fps[b], smiles, ids)
    assert _files(tmp_path / "port.tfsim") == _files(tmp_path / "jax.tfsim")
    meta = json.loads((tmp_path / "port.tfsim" / "meta.json").read_text())
    assert meta["format_version"] == (3 if synthetic else 2)
    for writer in WRITERS:
        for reader, load in LOADERS.items():
            data = load(tmp_path / f"{writer}.tfsim")
            assert data.count == 3000
            assert bytes(data.smiles[2999]) == b"C0002999"
            assert bytes(data.ids[1234]) in (b"SYN0000001234", b"ID1234")
            rows = np.asarray(data.packed_words()[[0, 2999]])
            want = (jsynth.virtual_rows_np(np.array([0, 2999]), 32, 9) if synthetic
                    else np.concatenate(fps).view(np.uint32)[[0, 2999]])
            np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("bad", ["fps_to_synthetic", "short_record", "ragged_bytes",
                                 "count_mismatch"])
def test_writer_refuses_what_the_jax_writer_refuses(tmp_path, bad):
    errors = {}
    for side, cls in WRITERS.items():
        path = tmp_path / f"{side}.tfsim"
        try:
            with cls(path, synthetic_seed=1, strided={"ids": 4}) as w:
                fps = np.zeros((2, 128), np.uint8) if bad == "fps_to_synthetic" else None
                ids = {"short_record": [b"abcd", b"abc"], "ragged_bytes": b"abcdefg",
                       "count_mismatch": [b"abcd"] * 3}.get(bad, [b"abcd"] * 2)
                w.append_batch(fps, [b"C", b"CC"], ids)
        except ValueError as e:
            errors[side] = str(e)
        assert not path.exists()
        assert [p.name for p in tmp_path.iterdir() if ".tmp." in p.name] == []
    assert errors["port"] == errors["jax"]


# -------------------------------------------------------- VirtualWords.rescore


@pytest.mark.parametrize("similarity", ["tanimoto", "tversky"])
@pytest.mark.parametrize("path", ["default", "numpy"])
def test_virtual_rescore_equals_the_jax_method(monkeypatch, path, similarity):
    """On the native library where it loads (``default``) and with it
    forced away (``numpy``: both packages fall back to the mixer's rows
    and ``scores_np``), the port's scores equal the JAX method's bit for
    bit, rows past 2**31 included; the engine's rescore goes through it."""
    if path == "numpy":
        monkeypatch.setattr(pnative, "_load", lambda: None)
        import gpusimilarity_tpu.utils.native as jnative

        def no_native(*a, **k):
            raise ImportError("native library not available")

        monkeypatch.setattr(jnative, "synth_rescore", no_native)
    n = 3_000_000_000
    idx = np.sort(np.random.default_rng(4).choice(n, 300, replace=False))
    query = jsynth.virtual_rows_np(np.array([2_500_000_123]), 32, 5)[0]
    ab = (0.7, 0.3) if similarity == "tversky" else (1.0, 1.0)
    want = jsynth.VirtualWords(n, 32, 5).rescore(idx, query, similarity, *ab)
    got = psynth.VirtualWords(n, 32, 5).rescore(idx, query, similarity, *ab)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        rescore_rows(psynth.VirtualWords(n, 32, 5), idx, query, similarity, *ab), got)


# ---------------------------------------------------- the tools against JAX


def _run(args, timeout=300) -> dict:
    out = subprocess.run(
        [sys.executable, *map(str, args)], cwd=REPO, timeout=timeout,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_northstar_matches_the_jax_tool(tmp_path):
    """Both at 65,536 rows, fold 8, 4 queries, k 16, on the CPU: equal
    library files, equal full-width oracles, and equal exactness and
    recall fields."""
    args = ("--rows", 65536, "--fold", 8, "--queries", 4, "--k", 16, "--cpu")
    want = _run(["tools/northstar.py", *args, "--dir", tmp_path / "jax"])
    got = _run(["-m", "gpusimilarity_tpu_torch.tools.northstar", *args,
                "--dir", tmp_path / "port"])
    lib = "rows65536.tfsim"
    assert _files(tmp_path / "port" / lib) == _files(tmp_path / "jax" / lib)
    oracle = "oracle_rows65536_q4_k16.json"
    jo, po = (json.loads((tmp_path / side / oracle).read_text()) for side in ("jax", "port"))
    for field in ("vals", "idx", "count_03", "count_05"):
        assert po[field] == jo[field], field
    for field in ("rows", "fold", "popless", "k", "exactness_checks_passed", "oracle",
                  "recall_at_k", "recall_at_k_min", "recall_strong_ge_0.5",
                  "metric", "unit", "path"):
        assert got[field] == want[field], field
    assert got["exactness_checks_passed"] == "4/4"
    assert got["prewarm"].startswith("prewarm")
    assert got["card"] == "cpu" and set(got["kernel_launches"]) == {
        "bitplane_phase1", "dense_phase1"}


def test_chem_scale_matches_the_jax_tool(tmp_path):
    """Both at 2,000 compounds, 4 sampled: the same corpus lines, the same
    library bytes (each tool's ``createdb`` as a subprocess), the same
    self-match fields; ``--reuse`` then prints a verification-only record."""
    args = ("--rows", 2000, "--sample", 4, "--keep")
    want = _run(["tools/chem_scale.py", *args, "--dir", tmp_path / "jax"])
    got = _run(["-m", "gpusimilarity_tpu_torch.tools.chem_scale", *args, "--cpu_only",
                "--dir", tmp_path / "port"])
    corpus = [gzip.open(tmp_path / side / "corpus_2000.smi.gz").read()
              for side in ("jax", "port")]
    assert corpus[0] == corpus[1]
    assert _files(tmp_path / "port" / "lib_2000.tfsim") == _files(
        tmp_path / "jax" / "lib_2000.tfsim")
    for field in ("metric", "unit", "rows", "library_mib", "self_match",
                  "exact_id_in_top5"):
        assert got[field] == want[field], field
    assert got["self_match"] == "4/4" and got["value"] > 0
    reused = _run(["-m", "gpusimilarity_tpu_torch.tools.chem_scale", *args,
                   "--cpu_only", "--reuse", "--dir", tmp_path / "port"])
    assert reused["value"] is None and reused["reused"] is True
    assert "build_s" not in reused and reused["self_match"] == "4/4"
