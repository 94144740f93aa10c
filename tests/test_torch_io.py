"""PyTorch port: its own copies of the host I/O modules against the JAX
package's, and its entry points' device default, on the CPU.

Files written by one package are read by the other, both ways, and the two
writers give byte-identical ``.fsim`` files and ``.tfsim`` directories. The
SMILES front end and the virtual library's host half agree on both sides.
Every entry point runs on the card unless given ``device="cpu"``, and
raises where there is none.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import torch

import gpusimilarity_tpu.utils.fingerprints as jfp
import gpusimilarity_tpu.utils.fsim as jfsim
import gpusimilarity_tpu.utils.strings as jstrings
import gpusimilarity_tpu.utils.synth as jsynth
import gpusimilarity_tpu.utils.tfsim as jtfsim
from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.parallel import mesh, sharded
from gpusimilarity_tpu_torch.tools import probe_mxu
from gpusimilarity_tpu_torch.utils import convert
from gpusimilarity_tpu_torch.utils import fingerprints as pfp
from gpusimilarity_tpu_torch.utils import fsim as pfsim
from gpusimilarity_tpu_torch.utils import strings as pstrings
from gpusimilarity_tpu_torch.utils import synth as psynth
from gpusimilarity_tpu_torch.utils import tfsim as ptfsim

REPO = Path(__file__).resolve().parent.parent

JAX = SimpleNamespace(fsim=jfsim, strings=jstrings, synth=jsynth, tfsim=jtfsim)
PORT = SimpleNamespace(fsim=pfsim, strings=pstrings, synth=psynth, tfsim=ptfsim)
SIDES = {"jax": JAX, "port": PORT}


def _data(side, layout, n=300):
    """One library built with ``side``'s classes: random rows and plain
    string lists (``offsets``), fixed-width ids (``strided``), one constant
    SMILES (``constant``) or a virtual library of 3e9 rows
    (``synthetic``)."""
    rng = np.random.default_rng(17)
    fps = np.packbits(rng.random((n, 1024)) < 0.05, axis=1, bitorder="little")
    smiles = [f"C{'C' * (i % 5)}O{i}".encode() for i in range(n)]
    ids = [f"ID{i:06d}".encode() for i in range(n)]
    if layout == "strided":
        ids = side.strings.StridedStringTable.from_strings(ids)
    if layout == "constant":
        smiles = side.strings.ConstantStringTable(b"\xffC", n)
    if layout == "synthetic":
        n = 3_000_000_000
        fps = side.synth.VirtualFingerprints(n, 1024, seed=5)
        smiles = side.strings.ConstantStringTable(b"C", n)
        ids = side.strings.ConstantStringTable(b"V", n)
    return side.fsim.FingerprintData(
        dbkey="key", bitcount=1024, fingerprints=fps, smiles=smiles, ids=ids,
        generator="rdkit-compat-morgan-r2-1024",
    )


def _assert_same(got, want, side):
    assert (got.dbkey, got.bitcount, got.count, got.generator) == (
        want.dbkey, want.bitcount, want.count, want.generator)
    if got.count > 10**6:  # virtual: the reader's own class, same rows
        assert isinstance(got.fingerprints, side.synth.VirtualFingerprints)
        assert got.fingerprints.seed == want.fingerprints.seed
        idx = np.array([0, 255, 256, (1 << 31) + 3, got.count - 1])
        np.testing.assert_array_equal(
            got.packed_words()[idx], want.packed_words()[idx]
        )
        for i in (0, got.count - 1):
            assert (got.smiles[i], got.ids[i]) == (want.smiles[i], want.ids[i])
        return
    np.testing.assert_array_equal(np.asarray(got.fingerprints),
                                  np.asarray(want.fingerprints))
    np.testing.assert_array_equal(got.packed_words(), want.packed_words())
    assert list(got.smiles) == list(want.smiles)
    assert list(got.ids) == list(want.ids)


def _tree_bytes(path: Path) -> dict:
    if path.is_file():
        return {path.name: path.read_bytes()}
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("string_tables", [True, False])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_fsim_written_by_one_package_reads_in_the_other(tmp_path, writer, reader,
                                                        string_tables):
    data = _data(SIDES[writer], "offsets")
    path = tmp_path / "x.fsim"
    SIDES[writer].fsim.write_fsim(path, data, chunk_limit=4096)
    got = SIDES[reader].fsim.read_fsim(path, string_tables=string_tables)
    _assert_same(got, data, SIDES[reader])
    assert isinstance(got, SIDES[reader].fsim.FingerprintData)


def test_fsim_writers_are_byte_identical(tmp_path):
    for name, side in SIDES.items():
        side.fsim.write_fsim(tmp_path / f"{name}.fsim", _data(side, "offsets"),
                             chunk_limit=4096)
    assert (tmp_path / "jax.fsim").read_bytes() == (tmp_path / "port.fsim").read_bytes()
    assert (tmp_path / "jax.fsim.meta.json").read_bytes() == (
        tmp_path / "port.fsim.meta.json").read_bytes()


@pytest.mark.parametrize("layout", ["offsets", "strided", "constant", "synthetic"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_tfsim_written_by_one_package_reads_in_the_other(tmp_path, writer, reader,
                                                         layout):
    data = _data(SIDES[writer], layout)
    path = tmp_path / "x.tfsim"
    SIDES[writer].tfsim.save_native(path, data)
    assert SIDES[reader].tfsim.is_native(path)
    got = SIDES[reader].tfsim.load_any(path)
    _assert_same(got, data, SIDES[reader])


@pytest.mark.parametrize("layout", ["offsets", "strided", "constant", "synthetic"])
def test_tfsim_writers_are_byte_identical(tmp_path, layout):
    trees = {}
    for name, side in SIDES.items():
        path = tmp_path / f"{name}.tfsim"
        side.tfsim.save_native(path, _data(side, layout))
        trees[name] = _tree_bytes(path)
    assert trees["jax"] == trees["port"]
    assert ("fingerprints.npy" in trees["port"]) == (layout != "synthetic")


def test_load_any_reads_fsim_too(tmp_path):
    pfsim.write_fsim(tmp_path / "a.fsim", _data(PORT, "offsets"))
    got = ptfsim.load_any(tmp_path / "a.fsim")
    _assert_same(got, jtfsim.load_any(tmp_path / "a.fsim"), PORT)


SMILES = [
    "CCO", "CCCO", "c1ccccc1", "c1ccccc1O", "c1ccncc1", "Cc1ccccc1", "CC(=O)O",
    "CC(=O)N", "CCN(CC)CC", "OCC(O)CO", "Clc1ccccc1", "Brc1ccccc1", "CC(C)CC",
    "C1CCCCC1", "C1CCNCC1", "N#Cc1ccccc1", "[NH4+]", "CC(=O)[O-]", "C/C=C/C",
    "F/C=C\\F", "C[C@H](N)C(=O)O", "c1ccc2ccccc2c1", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
    "CC(=O)Oc1ccccc1C(=O)O", "[2H]C", "C%10CCCCC%10", "c1cc[nH]c1",
    "O=S(=O)(O)O", "[Na+].[Cl-]", "C#C", "  CCO  ",
]
BAD_SMILES = ["", "C(", "C)", "C1CC", "[C", "Xx", "1CC", "not a smiles(("]


@pytest.mark.parametrize("smiles", SMILES)
def test_smiles_to_query_words_matches_jax(smiles):
    words, canon = pfp.smiles_to_query_words(smiles)
    jwords, jcanon = jfp.smiles_to_query_words(smiles)
    assert words.dtype == np.uint32 and words.shape == (32,)
    np.testing.assert_array_equal(words, jwords)
    assert canon == jcanon


@pytest.mark.parametrize("smiles", BAD_SMILES)
def test_bad_smiles_raise_on_both_sides(smiles):
    with pytest.raises(pfp.FingerprintError):
        pfp.smiles_to_query_words(smiles)
    with pytest.raises(jfp.FingerprintError):
        jfp.smiles_to_query_words(smiles)


def test_generator_tags_match_jax():
    assert pfp.generator_tag() == jfp.generator_tag()
    for tag in ("rdkit-morgan-r2-1024", "rdkit-compat-morgan-r2-1024",
                "builtin-morgan-r2-1024"):
        assert pfp.compatible_generators(tag) == jfp.compatible_generators(tag)


@pytest.mark.parametrize(
    "rows,seed,word_count",
    [(np.arange(600), 0, 32), (np.arange(255, 1300), 7, 32),
     ((1 << 31) + np.arange(-300, 300), 3, 32),
     ((1 << 32) - 1 - np.arange(500), 1, 32), (np.arange(100, 400), 5, 64)],
    ids=["start", "clusters", "across_2^31", "top_of_uint32", "2048_bits"],
)
def test_virtual_rows_np_and_virtual_words_match_jax(rows, seed, word_count):
    np.testing.assert_array_equal(
        psynth.virtual_rows_np(rows, word_count, seed),
        jsynth.virtual_rows_np(rows, word_count, seed),
    )
    n = 1 << 32
    pv = psynth.VirtualWords(n, word_count, seed)
    jv = jsynth.VirtualWords(n, word_count, seed)
    np.testing.assert_array_equal(pv[rows], jv[rows])
    np.testing.assert_array_equal(pv[int(rows[-1])], jv[int(rows[-1])])
    lo = int(rows[0])
    np.testing.assert_array_equal(pv[lo:lo + 40], jv[lo:lo + 40])
    np.testing.assert_array_equal(pv[-3:], jv[-3:])
    pf = psynth.VirtualFingerprints(n, 32 * word_count, seed)
    assert pf.shape == (n, 4 * word_count) and pf.nbytes == n * 4 * word_count
    np.testing.assert_array_equal(pf[rows[:5]], jsynth.VirtualFingerprints(
        n, 32 * word_count, seed)[rows[:5]])


@pytest.mark.parametrize("layout", ["offsets", "synthetic"])
def test_fingerprint_data_from_jax(layout):
    """The converter carries a JAX library across by its fields, a virtual
    one as the port's own ``VirtualFingerprints``."""
    jdata = _data(JAX, layout)
    got = convert.fingerprint_data_from_jax(jdata)
    assert isinstance(got, pfsim.FingerprintData)
    got.validate()
    _assert_same(got, jdata, PORT)


# ------------------------------------------------------------ device default


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _fsim_path(tmp_path):
    path = tmp_path / "db.fsim"
    pfsim.write_fsim(path, _data(PORT, "offsets"))
    return str(path)


ENTRY_POINTS = {
    "DatabaseRegistry": lambda p: DatabaseRegistry(),
    "from_fsim_files": lambda p: DatabaseRegistry.from_fsim_files([p]),
    "FingerprintDB": lambda p: FingerprintDB(_data(PORT, "offsets")),
    "build_store": lambda p: sharded.build_store(np.zeros((8, 32), np.uint32)),
    "build_bitplane_store": lambda p: sharded.build_bitplane_store(
        np.zeros((8, 32), np.uint32)),
    "virtual_rows": lambda p: psynth.virtual_rows(0, 8),
    "virtual_folded_rows": lambda p: psynth.virtual_folded_rows(8, 4),
    "build_virtual_dense_store": lambda p: psynth.build_virtual_dense_store(8, 4),
    "dense_store_from_jax": lambda p: convert.dense_store_from_jax(
        np.zeros((8, 256), np.uint32), None, 10),
    "bitplane_store_from_jax": lambda p: convert.bitplane_store_from_jax(
        np.zeros((8 * 1025, 256), np.uint32), np.zeros(2048, np.int16), 10, 1),
    "store_from_fingerprint_data": lambda p: convert.store_from_fingerprint_data(
        _data(PORT, "offsets")),
    "probe_mxu": lambda p: probe_mxu.main(["--rows", "256"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(name, no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](_fsim_path(tmp_path))


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """With a card the default device is ``cuda:0``; ``device="cpu"`` runs
    the plain path on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh.resolve_device(None) == torch.device("cuda", 0)
    assert DatabaseRegistry().device == torch.device("cuda", 0)
    reg = DatabaseRegistry.from_fsim_files([_fsim_path(tmp_path)], device="cpu")
    assert reg.device == torch.device("cpu")
    db = FingerprintDB(_data(PORT, "offsets"), device="cpu")
    assert db.store.planes.device == torch.device("cpu")


# ------------------------------------------------------------- import guard


PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "gpusimilarity_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_file_of_the_port_imports_the_jax_package(path):
    """Not at module level and not inside a function: no ``jax`` and nothing
    of ``gpusimilarity_tpu``."""
    tree = ast.parse((REPO / path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "gpusimilarity_tpu"}, roots


def test_native_library_path_is_the_repositorys():
    """The port's bindings load the repository's own C++ library."""
    from gpusimilarity_tpu_torch.utils import native

    paths = list(native._candidate_paths())
    assert str(REPO / "native" / "libtpusim_native.so") in paths


def test_probe_is_a_module_of_the_port():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.tools.probe_mxu", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    for flag in ("--rows", "--batches", "--bw", "--qpop", "--repeats",
                 "--skip_bitplane", "--int8", "--cpu_only"):
        assert flag in proc.stdout
