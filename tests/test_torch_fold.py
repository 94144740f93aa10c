"""PyTorch port: folding, the scan-mode and fold decisions, and the engine
on dense, popless and folded stores, against the JAX package on the CPU.

The JAX engine runs its dense search with the Pallas phase-1 kernel in
interpret mode (``use_pallas=True``); the port runs the plain versions of
its kernels. At fold > 1 both rescore candidates with the same numpy (or
native) full-width scores, so every result must be identical: scores,
indices and approximate counts.
"""

import numpy as np
import pytest

import torch

from gpusimilarity_tpu.models import FingerprintDB as JaxDB
from gpusimilarity_tpu.utils.fsim import FingerprintData
from gpusimilarity_tpu.utils.strings import ConstantStringTable
from gpusimilarity_tpu.utils.synth import VirtualFingerprints, virtual_rows_np
from gpusimilarity_tpu_torch.models import registry
from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB, rescore_rows
from gpusimilarity_tpu_torch.ops import fold as fold_ops
from gpusimilarity_tpu_torch.ops.scan import scores_np
from gpusimilarity_tpu_torch.parallel import mesh, sharded
from gpusimilarity_tpu_torch.utils.convert import fingerprint_data_from_jax

from conftest import random_fingerprint_data


def _native_off(monkeypatch):
    """Force the numpy paths: the native library may or may not be built."""
    from gpusimilarity_tpu_torch.utils import native

    monkeypatch.setattr(native, "_load", lambda: None)


@pytest.mark.parametrize("host_path", ["numpy", "default"])
@pytest.mark.parametrize("fold", [1, 2, 4, 8])
def test_fold_words_matches_jax(fold, host_path, monkeypatch):
    import jax.numpy as jnp

    from gpusimilarity_tpu.ops import fold as jfold

    if host_path == "numpy":
        _native_off(monkeypatch)
    rng = np.random.default_rng(fold)
    w = rng.integers(0, 2**32, size=(2000, 32), dtype=np.uint32)
    want = np.asarray(jfold.fold_words(w, fold))
    np.testing.assert_array_equal(fold_ops.fold_words(w, fold), want)
    np.testing.assert_array_equal(fold_ops.fold_words(w[:5], fold), want[:5])
    got_t = fold_ops.fold_words(torch.from_numpy(w.view(np.int32)), fold)
    np.testing.assert_array_equal(got_t.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        np.asarray(jfold.fold_words(jnp.asarray(w[:7]), fold)), want[:7]
    )


def test_round_fold_and_overfetch_match_jax():
    from gpusimilarity_tpu.ops import fold as jfold

    for w in (8, 32, 64):
        for f in range(1, 9):
            assert fold_ops.round_fold_factor(w, f) == jfold.round_fold_factor(w, f)
    for k in (1, 20, 128):
        for f in (1, 2, 4, 8):
            assert fold_ops.overfetch_count(k, f) == jfold.overfetch_count(k, f)
    with pytest.raises(ValueError):
        fold_ops.fold_words(np.zeros((2, 32), np.uint32), 3)


def test_scores_np_matches_jax():
    from gpusimilarity_tpu.ops import scan as jscan

    rng = np.random.default_rng(4)
    w = rng.integers(0, 2**32, size=(500, 32), dtype=np.uint32) & rng.integers(
        0, 2**32, size=(500, 32), dtype=np.uint32)
    q = w[[1, 2]]
    for sim, a, b in (("tanimoto", 1.0, 1.0), ("tversky", 0.7, 0.3)):
        np.testing.assert_array_equal(
            scores_np(w, q, sim, a, b), jscan.scores_np(w, q, sim, a, b)
        )


@pytest.mark.parametrize("scan_mode", ["auto", "dense", "bitplane"])
@pytest.mark.parametrize("fold", [1, 3, 4])
@pytest.mark.parametrize("popless", [False, True])
def test_resolve_scan_mode_matches_jax_on_an_accelerator(scan_mode, fold, popless):
    """The JAX rule on an accelerator backend, then its popless override."""
    from gpusimilarity_tpu.models.registry import resolve_scan_mode as jresolve

    want, _pallas = jresolve(scan_mode, False, fold, "tpu")
    if popless:
        want = "dense"
    assert registry.resolve_scan_mode(scan_mode, fold, popless) == want
    with pytest.raises(ValueError):
        registry.resolve_scan_mode("mxu", fold)


def _datas(count, bitcount=1024):
    data = FingerprintData(
        bitcount=bitcount,
        fingerprints=VirtualFingerprints(count, bitcount, seed=1),
        smiles=ConstantStringTable(b"C", count),
        ids=ConstantStringTable(b"X", count),
    )
    return [("a", data)]


@pytest.mark.parametrize(
    "free,device_bitcount,want",
    [(None, 0, 1), (79_000_000_000, 0, 3), (60_000_000_000, 256, 4),
     (79_000_000_000, 512, "MemoryError"), (200_000_000_000, 0, 1)],
)
def test_global_fold_matches_jax(monkeypatch, free, device_bitcount, want):
    """The 1,020,017,472-row x 1024-bit library against free device memory
    and ``--gpu_bitcount``: the same fold (or MemoryError) as the JAX
    registry's, and fold 3 rounds up to 4 in the engine."""
    from gpusimilarity_tpu.models import registry as jregistry
    from gpusimilarity_tpu.parallel import mesh as jmesh

    datas = _datas(1_020_017_472)
    monkeypatch.setattr(mesh, "available_device_memory", lambda device: free)
    monkeypatch.setattr(jmesh, "available_device_memory", lambda devices=None: free)
    monkeypatch.setattr(
        jregistry, "auto_fold_factor", lambda b: jmesh.auto_fold_factor(b)
    )
    dev = mesh.Mesh(["cpu"])
    if want == "MemoryError":
        with pytest.raises(MemoryError, match="device_bitcount"):
            jregistry.DatabaseRegistry._global_fold(datas, device_bitcount)
        with pytest.raises(MemoryError, match="device_bitcount"):
            registry.DatabaseRegistry._global_fold(datas, device_bitcount, dev)
        return
    got = registry.DatabaseRegistry._global_fold(datas, device_bitcount, dev)
    assert got == jregistry.DatabaseRegistry._global_fold(datas, device_bitcount) == want
    if want == 3:
        assert fold_ops.round_fold_factor(32, got) == 4
        assert registry.resolve_scan_mode("auto", got) == "dense"


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(0xF01D)
    return random_fingerprint_data(rng, count=16384, density=0.04, dbkey="f")


def _queries(data):
    words = data.packed_words()
    perturbed = words[40].copy()
    perturbed[5] ^= np.uint32(0x00F0000F)
    return np.stack([words[0], words[1234], words[16383], perturbed])


ENGINE_CASES = {
    # name: (port kwargs, JAX kwargs)
    "dense_fold1": (dict(scan_mode="dense"), dict(scan_mode="dense")),
    "dense_fold2": (dict(scan_mode="dense", fold_factor=2),
                    dict(scan_mode="dense", fold_factor=2)),
    "dense_fold4": (dict(scan_mode="dense", fold_factor=4),
                    dict(scan_mode="dense", fold_factor=4)),
    "popless_fold4": (dict(scan_mode="dense", fold_factor=4, popless=True),
                      dict(scan_mode="dense", fold_factor=4, popless=True)),
    "bitplane_fold4": (dict(scan_mode="bitplane", fold_factor=4),
                       dict(scan_mode="bitplane", fold_factor=4)),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
@pytest.mark.parametrize(
    "similarity,alpha,beta", [("tanimoto", 1.0, 1.0), ("tversky", 0.7, 0.3)]
)
def test_engine_matches_jax_engine(library, name, similarity, alpha, beta):
    port_kw, jax_kw = ENGINE_CASES[name]
    data = library
    q = _queries(data)
    ks, cuts = [5, 20, 1, 50], [0.0, 0.3, 0.2, 0.1]
    db = FingerprintDB(data, device="cpu", **port_kw)
    jdb = JaxDB(data, use_pallas=jax_kw["scan_mode"] == "dense", chunk_cols=512,
                **jax_kw)
    got = db.search_batch(q, ks, cuts, "f", similarity, alpha, beta,
                          return_indices=True)
    want = jdb.search_batch(q, ks, cuts, "f", similarity, alpha, beta,
                            return_indices=True)
    for g, w in zip(got, want):
        assert g.approximate_count == w.approximate_count
        if similarity == "tversky" and db.fold_factor == 1:
            # unfolded Tversky scores come from the device, where XLA on
            # the CPU contracts an FMA; folded ones from the same rescore
            np.testing.assert_allclose(g.scores, w.scores, rtol=1e-6)
        else:
            assert g.scores == w.scores
            assert g.indices == w.indices
        assert g.ids == w.ids
    assert got[0].scores[0] == 1.0 and got[0].indices[0] == 0
    assert db.scan_mode == port_kw["scan_mode"]
    if db.scan_mode == "dense":
        assert db.store.shards[0].word_count == 32 // db.fold_factor
        assert (db.store.shards[0].popcounts is None) == port_kw.get("popless", False)


def test_virtual_dense_fold4_matches_jax_engine():
    """A synthetic library: the port generates its folded dense store on
    the device and rescores from the mixer; the JAX engine does the same
    on its mesh. Rows are never materialised on the host beyond the
    candidates."""
    from gpusimilarity_tpu_torch.utils.synth import pick_query_rows

    n = 30000
    data = FingerprintData(
        dbkey="v", bitcount=1024,
        fingerprints=VirtualFingerprints(n, 1024, seed=11),
        smiles=ConstantStringTable(b"C", n), ids=ConstantStringTable(b"V", n),
    )
    rows = pick_query_rows(3, n, 4, seed=11)
    q = virtual_rows_np(rows, seed=11)
    for popless in (False, True):
        db = FingerprintDB(fingerprint_data_from_jax(data), device="cpu",
                           fold_factor=4, scan_mode="dense", popless=popless)
        assert isinstance(db.store.shards[0], sharded.DenseStore)
        assert (db.store.shards[0].popcounts is None) == popless
        jdb = JaxDB(data, fold_factor=4, scan_mode="dense", use_pallas=True,
                    chunk_cols=512, popless=popless)
        got = db.search_batch(q, [20, 5, 128], [0.0, 0.2, 0.1], "v",
                              return_indices=True)
        want = jdb.search_batch(q, [20, 5, 128], [0.0, 0.2, 0.1], "v",
                                return_indices=True)
        for r, g, w in zip(rows, got, want):
            assert (g.scores, g.indices, g.approximate_count) == (
                w.scores, w.indices, w.approximate_count)
            assert g.indices[0] == r and g.scores[0] == 1.0
            full = scores_np(virtual_rows_np(np.array(g.indices), seed=11),
                             virtual_rows_np(np.array([r]), seed=11))[0]
            assert g.scores == [float(v) for v in full]


def test_virtual_bitplane_fold4_is_exact():
    """A synthetic library served bitplane at fold 4: every returned score
    is its row's full-width score, order is (-score, index), and the
    count is the plain folded count."""
    n = 20000
    data = FingerprintData(
        dbkey="", bitcount=1024,
        fingerprints=VirtualFingerprints(n, 1024, seed=3),
        smiles=ConstantStringTable(b"C", n), ids=ConstantStringTable(b"V", n),
    )
    db = FingerprintDB(fingerprint_data_from_jax(data), device="cpu",
                       fold_factor=4, scan_mode="bitplane")
    shard = db.store.shards[0]
    assert isinstance(shard, sharded.BitplaneStore) and shard.bitcount == 256
    full = virtual_rows_np(np.arange(n), seed=3)
    q = full[[17, 19000]]
    folded = fold_ops.fold_words(full, 4)
    for qi, r in enumerate(db.search_batch(q, k=30, cutoff=0.1, return_indices=True)):
        s = scores_np(full[r.indices], q[qi])
        assert r.scores == [float(v) for v in s]
        assert r.indices[0] == [17, 19000][qi] and r.scores[0] == 1.0
        assert all(
            (a > b) or (a == b and i < j) for a, b, i, j in
            zip(r.scores, r.scores[1:], r.indices, r.indices[1:])
        )
        fs = scores_np(folded, fold_ops.fold_words(q[qi][None], 4)[0])
        assert r.approximate_count == int((fs >= np.float32(0.1)).sum())


@pytest.mark.parametrize("host_path", ["numpy", "default"])
def test_rescore_rows_numpy_matches_jax_rescore(host_path, monkeypatch):
    """The fold path's host rescore over an array and over a virtual
    source equals the JAX engine's numpy rescore, on the numpy path and
    on whichever path this machine has."""
    from gpusimilarity_tpu.ops.scan import scores_np as jscores
    from gpusimilarity_tpu_torch.utils.synth import VirtualWords

    if host_path == "numpy":
        _native_off(monkeypatch)
    vw = VirtualWords(5000, 32, seed=2)
    full = virtual_rows_np(np.arange(5000), seed=2)
    idx = np.array([0, 7, 255, 256, 4999])
    for sim, a, b in (("tanimoto", 1.0, 1.0), ("tversky", 0.7, 0.3)):
        want = jscores(full[idx], full[9][None, :], sim, a, b)[0]
        np.testing.assert_array_equal(rescore_rows(full, idx, full[9], sim, a, b), want)
        np.testing.assert_array_equal(rescore_rows(vw, idx, full[9], sim, a, b), want)


def test_popless_bitplane_rejected():
    rng = np.random.default_rng(1)
    data = random_fingerprint_data(rng, count=50)
    with pytest.raises(ValueError, match="popless"):
        FingerprintDB(data, device="cpu", scan_mode="bitplane", popless=True)
