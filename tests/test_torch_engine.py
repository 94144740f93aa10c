"""PyTorch port: FingerprintDB and DatabaseRegistry against the JAX engine
(``scan_mode="bitplane"``) and the numpy oracle, on the CPU."""

import fractions

import numpy as np
import pytest

import torch

from gpusimilarity_tpu.models import FingerprintDB as JaxDB
from gpusimilarity_tpu.ops.scan import scores_np
from gpusimilarity_tpu_torch.models.fingerprint_db import (
    FingerprintDB,
    check_kernel_width,
)
from gpusimilarity_tpu_torch.models.registry import (
    DatabaseRegistry,
    merge_results,
    resolve_scan_mode,
)
from gpusimilarity_tpu_torch.models.results import SearchResult
from gpusimilarity_tpu_torch.parallel import sharded

from conftest import random_fingerprint_data


@pytest.fixture(scope="module")
def library():
    rng = np.random.default_rng(0xE6)
    data = random_fingerprint_data(rng, count=3000, density=0.05, dbkey="k")
    return data, FingerprintDB(data, device="cpu"), JaxDB(data, scan_mode="bitplane")


def _queries(data):
    words = data.packed_words()
    perturbed = words[40].copy()
    perturbed[3] ^= np.uint32(0x00F0000F)
    return np.stack([words[0], words[17], words[2999], perturbed])


@pytest.mark.parametrize(
    "similarity,alpha,beta", [("tanimoto", 1.0, 1.0), ("tversky", 0.7, 0.3)]
)
def test_mixed_batch_matches_jax_engine(library, similarity, alpha, beta):
    """Per-query k and cutoff in one batch: scores and approximate counts
    equal the JAX engine's; self-queries score 1.0 at rank 0."""
    data, db, jdb = library
    q = _queries(data)
    ks, cuts = [5, 20, 1, 50], [0.0, 0.3, 0.2, 0.1]
    got = db.search_batch(q, ks, cuts, "k", similarity, alpha, beta)
    want = jdb.search_batch(q, ks, cuts, "k", similarity, alpha, beta)
    for g, w, k in zip(got, want, ks):
        assert g.approximate_count == w.approximate_count
        assert len(g.scores) == min(k, len(w.scores))
        if similarity == "tanimoto":
            np.testing.assert_array_equal(np.float32(g.scores), np.float32(w.scores))
        else:  # XLA may contract the Tversky multiply-add into an FMA
            np.testing.assert_allclose(g.scores, w.scores, rtol=1e-6)
    assert got[0].scores[0] == 1.0 and got[0].ids[0] == "TEST00000000"


def test_scores_match_numpy_oracle(library):
    data, db, _ = library
    q = _queries(data)
    s = scores_np(data.packed_words(), q)
    for qi, r in enumerate(db.search_batch(q, k=30, cutoff=0.15, dbkey="k",
                                           return_indices=True)):
        order = np.lexsort((np.arange(s.shape[1]), -s[qi]))
        order = [i for i in order if s[qi, i] >= 0.15][:30]
        np.testing.assert_array_equal(np.float32(r.scores), s[qi, order])
        assert r.approximate_count == int((s[qi] >= np.float32(0.15)).sum())
        for i, sc in zip(r.indices, r.scores):
            assert np.float32(sc) == s[qi, i]


def test_tie_free_indices_match_jax():
    """On data with distinct planted scores above a lower noise floor, the
    port and the JAX engine return identical (score, index) sequences."""
    rng = np.random.default_rng(11)
    n, k, qpop = 20000, 8, 100
    qbits = np.sort(rng.choice(256, qpop, replace=False))
    notq = np.setdiff1d(np.arange(256), qbits)
    planted, seen = [], set()
    for cf in range(99, 39, -1):
        for extra in range(0, 120, 7):
            pop = qpop + extra
            fr = fractions.Fraction(cf, qpop + pop - cf)
            if pop - cf > 256 - qpop or fr in seen or fr < fractions.Fraction(1, 5):
                continue
            seen.add(fr)
            planted.append((cf, pop, fr))
    planted = sorted(planted, key=lambda t: -t[2])[:40]
    bits = rng.random((n, 1024), dtype=np.float32) < 0.01
    rows = rng.choice(n, len(planted), replace=False)
    for (cf, pop, _), row in zip(planted, rows):
        r = np.zeros(1024, bool)
        r[rng.choice(qbits, cf, replace=False)] = True
        r[rng.choice(notq, pop - cf, replace=False)] = True
        bits[row] = r
    from gpusimilarity_tpu.utils.fsim import FingerprintData

    packed = np.packbits(bits, axis=1, bitorder="little")
    data = FingerprintData(
        fingerprints=packed,
        smiles=[f"C{i}".encode() for i in range(n)],
        ids=[f"ID{i}".encode() for i in range(n)],
    )
    q = np.zeros(1024, bool)
    q[qbits] = True
    qw = np.packbits(q, bitorder="little").view(np.uint32)
    noise = np.ones(n, bool)
    noise[rows] = False
    s = scores_np(data.packed_words(), qw[None])[0]
    assert s[noise].max() < float(planted[-1][2])

    got = FingerprintDB(data, device="cpu").search(qw, k=k, return_indices=True)
    want = JaxDB(data, scan_mode="bitplane").search(qw, k=k, return_indices=True)
    assert got.indices == want.indices
    assert got.scores == want.scores
    assert got.indices == [int(rows[i]) for i in range(k)]


def test_fewer_blocks_than_k():
    """1000 rows pad to a single 2048-column block, fewer blocks than k:
    selection keeps everything and the result is still exact."""
    rng = np.random.default_rng(5)
    data = random_fingerprint_data(rng, count=1000, density=0.1)
    db = FingerprintDB(data, device="cpu")
    assert db.store.n_padded // sharded.SELECT_BLOCK_COLS == 1
    q = data.packed_words()[[9, 500]]
    s = scores_np(data.packed_words(), q)
    for qi, r in enumerate(db.search_batch(q, k=200, return_indices=True)):
        order = np.lexsort((np.arange(1000), -s[qi]))[:200]
        np.testing.assert_array_equal(np.float32(r.scores), s[qi, order])
        assert r.approximate_count == 1000
    jr = JaxDB(data, scan_mode="bitplane").search(q[0], k=200)
    np.testing.assert_array_equal(np.float32(jr.scores), np.float32(
        db.search(q[0], k=200).scores))


def test_dbkey_mismatch_returns_empty(library):
    data, db, _ = library
    q = _queries(data)
    for r in db.search_batch(q, k=5, dbkey="wrong"):
        assert r.scores == [] and r.ids == [] and r.approximate_count == 0
    assert db.search(q[0], k=5, dbkey="").scores == []


@pytest.mark.parametrize(
    "kwargs",
    [{"scan_mode": "dense"}, {"popless": True}, {"fold_factor": 2},
     {"fold_factor": 3}],
)
def test_unported_modes_raise(kwargs):
    """The modes the first slice refused (dense, popless, fold 2 and 3)
    are served now: no ``NotImplementedError``, and a self-query scores
    1.0 at rank 0 with the numpy oracle's scores."""
    rng = np.random.default_rng(1)
    data = random_fingerprint_data(rng, count=50)
    if kwargs.get("popless"):  # dense-only, as in the JAX engine
        kwargs = {**kwargs, "scan_mode": "dense"}
    db = FingerprintDB(data, device="cpu", **kwargs)
    if kwargs.get("fold_factor") == 3:
        assert db.fold_factor == 4  # rounded up to a divisor of 32 words
    words = data.packed_words()
    r = db.search(words[7], k=10, return_indices=True)
    s = scores_np(words, words[7][None])[0]
    order = np.lexsort((np.arange(50), -s))[:10]
    assert r.indices[0] == 7 and r.scores[0] == 1.0
    np.testing.assert_array_equal(np.float32(r.scores), s[r.indices])
    if db.fold_factor == 1:
        assert r.indices == order.tolist()


def test_registry_resolves_auto_and_merges(tmp_path):
    """``auto`` resolves to bitplane unfolded and to dense when folded; two
    databases merge with ID joining like the JAX registry."""
    from gpusimilarity_tpu.models import DatabaseRegistry as JaxRegistry
    from gpusimilarity_tpu.utils.fsim import write_fsim

    assert resolve_scan_mode("auto", 1) == "bitplane"
    assert resolve_scan_mode("auto", 2) == "dense"
    rng = np.random.default_rng(7)
    data = random_fingerprint_data(rng, count=300, density=0.08)
    write_fsim(tmp_path / "a.fsim", data)
    write_fsim(tmp_path / "b.fsim", data)
    paths = [str(tmp_path / "a.fsim"), str(tmp_path / "b.fsim")]
    reg = DatabaseRegistry.from_fsim_files(paths, device="cpu")
    jreg = JaxRegistry.from_fsim_files(paths, scan_mode="bitplane")
    q = data.packed_words()[3]
    [got] = reg.search_databases_batch(["a", "b"], ["", ""], q[None], [6], [0.1])
    want = jreg.search_databases(["a", "b"], ["", ""], q, k=6, cutoff=0.1)
    assert (got.ids, got.smiles, got.approximate_count) == (
        want.ids, want.smiles, want.approximate_count)
    np.testing.assert_array_equal(np.float32(got.scores), np.float32(want.scores))
    assert ";:;" in got.ids[0]
    st = reg.stats()
    assert st["databases"]["a"]["count"] == 300 and st["searches"] == 1
    assert isinstance(st["kernel_launches"]["bitplane_phase1"], int)
    assert isinstance(st["kernel_launches"]["dense_phase1"], int)
    assert st["databases"]["a"]["scan_mode"] == "bitplane"
    reg.add("c", data, fold_factor=2, scan_mode=resolve_scan_mode("auto", 2))
    assert reg.stats()["databases"]["c"]["scan_mode"] == "dense"
    assert reg.stats()["databases"]["c"]["fold_factor"] == 2


def test_merge_results_orders_and_joins():
    a = SearchResult(smiles=["X", "Y"], ids=["a1", "a2"], scores=[0.9, 0.5],
                     approximate_count=2)
    b = SearchResult(smiles=["Y", "Z"], ids=["b1", "b2"], scores=[0.5, 0.7],
                     approximate_count=3)
    m = merge_results([a, b], k=2)
    assert m.smiles == ["X", "Z"] and m.approximate_count == 5
    m = merge_results([a, b], k=3)
    assert m.ids == ["a1", "b2", "a2;:;b1"]


def test_search_runs_through_phase1_wrapper(library, monkeypatch):
    """Every engine search goes through the phase-1 wrapper (the kernel on
    a card), even when the library has fewer blocks than k."""
    from gpusimilarity_tpu_torch.ops import bitplane_phase1

    calls = []
    real = bitplane_phase1.bitplane_phase1_batched

    def spy(*args, **kwargs):
        calls.append(args[2].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(sharded, "bitplane_phase1_batched", spy)
    data, db, _ = library
    db.search_batch(_queries(data), k=20, dbkey="k")
    assert calls == [torch.Size([4, 64])]


# (device type, scan mode, bits a row on the device, the limit its refusal names)
WIDTH_CASES = {
    "cuda_dense_2048": ("cuda", "dense", 2048, None),
    "cuda_dense_2080": ("cuda", "dense", 2080, "2048 bits"),
    "cuda_dense_8192": ("cuda", "dense", 8192, "2048 bits"),
    "cuda_bitplane_4064": ("cuda", "bitplane", 4064, None),
    "cuda_bitplane_4096": ("cuda", "bitplane", 4096, "4095 planes"),
    "cpu_dense_8192": ("cpu", "dense", 8192, None),
    "cpu_bitplane_8192": ("cpu", "bitplane", 8192, None),
}


@pytest.mark.parametrize("name", sorted(WIDTH_CASES))
def test_check_kernel_width_names_the_kernels_limit(name):
    """On a CUDA device a row wider than the scan mode's kernel takes is
    refused with the limit in the message, read from the kernel modules; the
    CPU path keeps every width."""
    from gpusimilarity_tpu_torch.ops import bitplane_phase1, dense_phase1

    assert 32 * dense_phase1.KERNEL_MAX_WORDS == 2048
    assert bitplane_phase1.KERNEL_MAX_PLANES == 4095
    device_type, mode, bits, limit = WIDTH_CASES[name]
    if limit is None:
        check_kernel_width(device_type, mode, bits)
    else:
        with pytest.raises(ValueError, match=limit):
            check_kernel_width(device_type, mode, bits)


@pytest.mark.parametrize("scan_mode", ["dense", "bitplane"])
def test_wide_library_is_refused_at_load_on_cuda_and_served_on_cpu(scan_mode, monkeypatch):
    """A 4096-bit library: on a CUDA device the constructor raises before any
    upload (this machine has no card, so reaching the upload would fail
    otherwise); folded to what the kernel takes it passes the check; on the
    CPU it loads and answers at full width."""
    rng = np.random.default_rng(6)
    data = random_fingerprint_data(rng, count=300, bitcount=4096, density=0.02, dbkey="w")
    uploads = []
    monkeypatch.setattr(FingerprintDB, "upload", lambda self: uploads.append(self.device))
    with pytest.raises(ValueError, match="2048 bits|4095 planes"):
        FingerprintDB(data, device="cuda", scan_mode=scan_mode)
    assert uploads == []
    FingerprintDB(data, device="cuda", scan_mode=scan_mode, fold_factor=2)
    assert [d.type for d in uploads] == ["cuda"]
    monkeypatch.undo()
    db = FingerprintDB(data, device="cpu", scan_mode=scan_mode)
    assert db.device_bitcount == 4096
    r = db.search(data.packed_words()[7], k=3, dbkey="w", return_indices=True)
    assert r.indices[0] == 7 and r.scores[0] == 1.0


@pytest.mark.parametrize("virtual", [False, True], ids=["rows", "virtual"])
def test_folded_bitplane_upload_streams_and_equals_the_folded_rows(virtual, monkeypatch):
    """The engine's bitplane upload at fold 4 hands the store build the
    full-width source (never a folded copy of the whole library) and builds
    the store of the folded rows, slab by slab."""
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.utils import synth as psynth
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
    from gpusimilarity_tpu_torch.utils.strings import ConstantStringTable

    n = 3 * 512 + 77
    monkeypatch.setattr(sharded, "_SLAB_ROWS", 512)
    monkeypatch.setattr(psynth, "_GEN_ROWS", 512)
    fps = psynth.VirtualFingerprints(n, 1024, 3)
    data = FingerprintData(
        dbkey="v", bitcount=1024,
        fingerprints=fps if virtual else fps[:],
        smiles=ConstantStringTable(b"C", n), ids=ConstantStringTable(b"V", n),
    )
    handed = []
    transpose = sharded.planes_from_rows
    monkeypatch.setattr(
        sharded, "planes_from_rows",
        lambda rows, *a, **k: handed.append(rows.shape) or transpose(rows, *a, **k),
    )
    db = FingerprintDB(data, device="cpu", fold_factor=4, scan_mode="bitplane")
    assert handed == [(512, 8)] * 3 + [(77, 8)]
    monkeypatch.setattr(sharded, "planes_from_rows", transpose)
    folded = np.ascontiguousarray(fold_words(fps.words[:], 4))
    want = sharded.build_bitplane_store(torch.from_numpy(folded.view(np.int32)))
    assert torch.equal(db.store.shards[0].planes, want.planes)
    assert torch.equal(db.store.shards[0].popcounts, want.popcounts)
    assert (db.store.shards[0].n_valid, db.store.shards[0].bitcount) == (n, 256)


def test_scale_tool_loads_and_searches_a_virtual_library_on_the_cpu(capsys):
    """The tool behind the near-capacity bitplane run, at a small size on the
    host: a virtual .tfsim through the registry resolves to fold 1, bitplane,
    and its one search is exact against the tool's own full scan."""
    import json

    from gpusimilarity_tpu_torch.tools import scale_bitplane

    rc = scale_bitplane.main(["--cpu_only", "--rows", "70001", "--k", "16"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["exact_against_full_scan"] is True
    assert (record["fold_factor"], record["scan_mode"], record["rows"]) == (1, "bitplane", 70001)
    assert record["card"] == "cpu" and record["max_memory_allocated"] is None
    assert 1 <= record["results"] <= 16 and record["approximate_count"] >= record["results"]
