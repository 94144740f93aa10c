"""PyTorch port: selection stage 3 of the bitplane search, the exact scores
of the 32 columns of each selected plane word (``ops/bitplane_rescore.py``).

On the CPU ``parallel/sharded.rescore_words`` runs the plain chain of
PyTorch ops (carry-save plane sums, per-column counts, scores), held here
against numpy popcounts of each column's row AND the query. The tests
marked ``cuda`` hold the kernel ``csrc/bitplane_rescore.cu`` against that
chain on the card, bit for bit; they skip elsewhere. The module does not import JAX,
so on a machine with a card they run alone with::

    python -m pytest --noconftest -m cuda tests/test_torch_bitplane_rescore.py
"""

import numpy as np
import pytest
import torch

from gpusimilarity_tpu_torch.ops import bitplane_rescore as rescore
from gpusimilarity_tpu_torch.ops.bitplane import query_plane_indices
from gpusimilarity_tpu_torch.ops.bitplane_phase1 import KERNEL_MAX_PLANES
from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np, similarity_from_counts
from gpusimilarity_tpu_torch.parallel import mesh as pmesh
from gpusimilarity_tpu_torch.parallel import sharded
from gpusimilarity_tpu_torch.utils import kernels

N_VALID = 60_001  # word 1875 holds columns 60000-60031: it crosses n_valid
CROSSING_WORD, PADDING_WORD = N_VALID // 32, N_VALID // 32 + 25
SIMILARITIES = {"tanimoto": (1.0, 1.0), "tversky": (0.7, 0.3)}


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0x5E3)
    bits = rng.random((N_VALID, 1024)) < 0.03
    words = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    return words


def _store(rows, device):
    return sharded.build_bitplane_store(
        torch.from_numpy(rows.view(np.int32)).to(device), device)


@pytest.fixture(scope="module")
def cpu_store(rows):
    return _store(rows, "cpu")


def _queries(rows, b, bucket, seed):
    """``b`` library rows cut to at most ``bucket`` set bits (fewer for two
    in three, so the lists end in sentinel padding); the first a query with
    no set bits when ``b > 1``. Returns the source rows, the query words,
    the plane lists and the popcounts."""
    rng = np.random.default_rng(seed)
    src = rng.choice(N_VALID, size=b, replace=False)
    q = np.zeros((b, rows.shape[1]), np.uint32)
    for j, r in enumerate(src):
        if b > 1 and j == 0:
            continue
        bits = np.unpackbits(rows[r].view(np.uint8), bitorder="little")
        keep = np.nonzero(bits)[0][:max(0, bucket - j % 3)]
        bits[:] = 0
        bits[keep] = 1
        q[j] = np.packbits(bits, bitorder="little").view(np.uint32)
    idx, _ = query_plane_indices(q, 1024, bucket)
    return src, q, idx, popcount_rows_np(q).astype(np.int32)


def _words(src, k, m, seed):
    """``k`` selected words a query: random ones, the query's own row's
    word, the word across ``n_valid`` and one of the padded tail."""
    rng = np.random.default_rng(seed)
    w = np.stack([rng.choice(m, size=k, replace=False) for _ in src])
    for j, r in enumerate(src):
        w[j, 0] = (CROSSING_WORD, r // 32)[j % 2]
        if k >= 3:
            w[j, 1], w[j, 2] = r // 32, PADDING_WORD
    return w.astype(np.int64)


def _inputs(rows, store, b, bucket, k, seed=0):
    src, _q, idx, qp = _queries(rows, b, bucket, seed)
    dev = store.planes.device
    w_sel = _words(src, k, store.planes.shape[1], seed + 1)
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(qp).to(dev),
            torch.from_numpy(w_sel).to(dev))


def _from_rows(rows, q, w_sel, similarity, alpha, beta):
    """Each selected word's 32 columns scored from the packed rows: numpy
    popcounts of row AND query, -inf from ``n_valid`` on."""
    cols = w_sel[:, :, None] * 32 + np.arange(32)
    cols = cols.reshape(len(q), -1)
    valid = cols < N_VALID
    held = rows[np.where(valid, cols, 0)]  # (B, kw*32, W)
    common = popcount_rows_np(held & q[:, None, :])
    s = similarity_from_counts(
        torch.from_numpy(common), torch.from_numpy(popcount_rows_np(held)),
        torch.from_numpy(popcount_rows_np(q)), similarity, alpha, beta)
    return torch.where(torch.from_numpy(valid), s, float("-inf")), torch.from_numpy(cols)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("similarity", sorted(SIMILARITIES))
@pytest.mark.parametrize("bucket,b,k", [(16, 1, 1), (64, 8, 20), (256, 3, 5)])
def test_rescore_words_on_cpu_is_the_plain_chain(rows, cpu_store, similarity, bucket,
                                                 b, k):
    """The CPU chain scores every column of the selected words as the
    packed rows do: words across ``n_valid`` and in the padded tail, a query
    with no set bits, lists ending in sentinel padding."""
    store = cpu_store
    src, q, idx, qp = _queries(rows, b, bucket, 0)
    w_sel = torch.from_numpy(_words(src, k, store.planes.shape[1], 1))
    alpha, beta = SIMILARITIES[similarity]
    before = kernels.launches(rescore.KERNEL)
    want_s, want_cols = _from_rows(rows, q, w_sel.numpy(), similarity, alpha, beta)
    idx, qp = torch.from_numpy(idx), torch.from_numpy(qp)
    got_s, got_cols = rescore.bitplane_rescore(
        store.planes, store.popcounts, idx, qp, w_sel, store.n_valid,
        similarity, alpha, beta)
    assert torch.equal(_bits(got_s), _bits(want_s))
    assert torch.equal(got_cols, want_cols)
    vals, ind = sharded.rescore_words(store, idx, qp, w_sel, k, similarity, alpha, beta)
    want_vals, want_ind = sharded._topk_padded(want_s, want_cols, k)
    assert torch.equal(_bits(vals), _bits(want_vals)) and torch.equal(ind, want_ind)
    assert kernels.launches(rescore.KERNEL) == before  # the CPU path never launches


@pytest.mark.parametrize("case", ["dtype", "non_contiguous", "shape"])
def test_wrapper_raises_on_inputs_the_kernel_does_not_take(rows, cpu_store, case):
    store = cpu_store
    idx, qp, w_sel = _inputs(rows, store, 3, 64, 4)
    if case == "dtype":
        idx = idx.to(torch.int64)
    elif case == "non_contiguous":
        w_sel = torch.cat([w_sel, w_sel], dim=1)[:, ::2]
        assert not w_sel.is_contiguous()
    else:
        qp = qp[:-1]
    with pytest.raises(ValueError, match="expected contiguous"):
        rescore.bitplane_rescore(store.planes, store.popcounts, idx, qp, w_sel,
                                 store.n_valid)


def test_wrapper_raises_on_an_unknown_similarity(rows, cpu_store):
    store = cpu_store
    idx, qp, w_sel = _inputs(rows, store, 2, 64, 4)
    with pytest.raises(ValueError, match="unknown similarity"):
        rescore.bitplane_rescore(store.planes, store.popcounts, idx, qp, w_sel,
                                 store.n_valid, "cosine")


def test_kernel_raises_on_a_plane_list_over_its_limit_and_on_host_tensors(rows,
                                                                          cpu_store):
    store = cpu_store
    idx, qp, w_sel = _inputs(rows, store, 2, 64, 4)
    long_idx = torch.full((2, KERNEL_MAX_PLANES + 1), 1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="plane bucket"):
        rescore.bitplane_rescore_kernel(store.planes, store.popcounts, long_idx,
                                        qp, w_sel, store.n_valid)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rescore.bitplane_rescore_kernel(store.planes, store.popcounts, idx, qp,
                                        w_sel, store.n_valid)
    # the plain version takes any plane list
    s, _ = rescore.bitplane_rescore(store.planes, store.popcounts, long_idx, qp,
                                    w_sel, store.n_valid)
    assert torch.equal(s[s > float("-inf")], torch.zeros_like(s[s > float("-inf")]))


def test_the_kernel_is_built_and_served():
    assert "bitplane_rescore" in kernels.KERNELS
    assert "bitplane_rescore" in kernels.SERVED
    files = kernels.source_files(kernels.CSRC / "bitplane_rescore.cu")
    assert [f.name for f in files] == ["bitplane_rescore.cu", "phase1_epilogue.cuh"]


def test_stats_count_the_rescore_launches(rows):
    from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData

    data = FingerprintData(
        dbkey="k", bitcount=1024, fingerprints=rows[:5000].view(np.uint8),
        smiles=[b"C"] * 5000, ids=[f"T{i}".encode() for i in range(5000)])
    reg = DatabaseRegistry(device="cpu")
    reg.add("lib", data, scan_mode="bitplane")
    reg.search_databases(["lib"], ["k"], rows[7], 5)
    launches = reg.stats()["kernel_launches"]
    assert set(launches) == {"bitplane_phase1", "bitplane_rescore", "dense_phase1"}
    assert launches["bitplane_rescore"] == kernels.launches(rescore.KERNEL)


# ------------------------------------------------------------------ the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cuda_store(rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return _store(rows, torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("similarity", sorted(SIMILARITIES))
@pytest.mark.parametrize("bucket", [16, 64, 256, 1024])
@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("k", [1, 20, 128])
def test_kernel_matches_the_chain_on_cuda(rows, cuda_store, similarity, bucket, b, k):
    """Scores and columns of the kernel equal the plain chain's bit for bit:
    sentinel padding, a query with no set bits, words across ``n_valid``
    and in the padded tail."""
    idx, qp, w_sel = _inputs(rows, cuda_store, b, bucket, k, seed=b * k + bucket)
    alpha, beta = SIMILARITIES[similarity]
    args = (cuda_store.planes, cuda_store.popcounts, idx, qp, w_sel,
            cuda_store.n_valid, similarity, alpha, beta)
    before = kernels.launches(rescore.KERNEL)
    s, cols = rescore.bitplane_rescore(*args)
    assert kernels.launches(rescore.KERNEL) == before + 1
    want_s, want_cols = rescore.bitplane_rescore_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(_bits(s), _bits(want_s))
    assert torch.equal(cols, want_cols)


def _with_chain(monkeypatch):
    monkeypatch.setattr(sharded, "bitplane_rescore",
                        lambda *a: rescore.bitplane_rescore_plain(*a))


@pytest.mark.cuda
@pytest.mark.parametrize("similarity", sorted(SIMILARITIES))
@pytest.mark.parametrize("b,k", [(1, 20), (8, 20), (8, 128)])
def test_local_topk_with_the_kernel_is_the_chains(rows, cuda_store, similarity, b, k,
                                                  monkeypatch):
    """``bitplane_local_topk`` serves the same values and rows with the
    kernel as with the chain."""
    _, _q, idx, qp = _queries(rows, b, 64, seed=b + k)
    dev = cuda_store.planes.device
    idx, qp = torch.from_numpy(idx).to(dev), torch.from_numpy(qp).to(dev)
    cut = torch.zeros(b, device=dev)
    alpha, beta = SIMILARITIES[similarity]
    before = kernels.launches(rescore.KERNEL)
    got = sharded.bitplane_local_topk(cuda_store, idx, qp, cut, k, similarity, alpha, beta)
    assert kernels.launches(rescore.KERNEL) == before + 1
    _with_chain(monkeypatch)
    want = sharded.bitplane_local_topk(cuda_store, idx, qp, cut, k, similarity, alpha,
                                       beta)
    assert kernels.launches(rescore.KERNEL) == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [1, 2])
def test_shards_at_a_row_offset_match_the_chain(rows, cards, cuda_device, monkeypatch):
    """Two shards, the second at ``row0 != 0``: on one card, and on a second
    card where one exists (its launches made on that card's device)."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA cards")
    devices = [torch.device("cuda", i % cards) for i in range(2)]
    store = sharded.build_sharded_store(rows, pmesh.make_mesh(devices))
    assert store.row0s[1] > 0
    assert [s.planes.device for s in store.shards] == devices
    _, _q, idx, qp = _queries(rows, 8, 64, seed=cards)
    cut = np.zeros(8, np.float32)
    before = kernels.launches(rescore.KERNEL)
    got = sharded.sharded_local_topk(store, idx, qp, cut, 20)
    assert kernels.launches(rescore.KERNEL) == before + 2  # one a shard
    _with_chain(monkeypatch)
    want = sharded.sharded_local_topk(store, idx, qp, cut, 20)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
