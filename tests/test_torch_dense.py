"""PyTorch port: phase 1 of the dense scan and the dense store's search,
against the JAX Pallas kernel and the JAX search program.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as ``tests/test_pallas.py`` runs it,
in that file's cases. Block maxima and counts must match bit for bit
(Tversky: rtol 1e-6 against JAX, whose CPU compiler contracts the
multiply-add into an FMA, and bit for bit against a numpy f32 oracle that
rounds each op).

``test_kernel_matches_plain_on_cuda`` holds the CUDA kernel against the
plain version; it needs a card and skips elsewhere. On a machine with a
card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_dense.py
"""

import re
from pathlib import Path

import numpy as np
import pytest

import torch

from gpusimilarity_tpu_torch.ops import dense_phase1 as ph1
from gpusimilarity_tpu_torch.ops.fold import fold_words
from gpusimilarity_tpu_torch.ops.scan import full_scan_topk, popcount_rows, popcount_rows_np
from gpusimilarity_tpu_torch.parallel import sharded
from gpusimilarity_tpu_torch.utils import kernels

# name -> (rows, n_valid, queries, cutoffs, similarity, alpha/beta, chunk,
#          block, shard offset, popless); test_pallas.py's cases
CASES = {
    "reference_b1": (4096, 4096, 1, None, "tanimoto", (1.0, 1.0), 4096, 32, 0, False),
    "reference_b4": (4096, 4096, 4, None, "tanimoto", (1.0, 1.0), 4096, 32, 0, False),
    "padding_masked": (1024, 700, 1, (0.0,), "tanimoto", (1.0, 1.0), 512, 4, 0, False),
    "shard_offset": (512, 600, 1, (0.0,), "tanimoto", (1.0, 1.0), 512, 4, 400, False),
    "tversky": (1024, 1024, 2, (0.0, 0.3), "tversky", (0.3, 0.7), 512, 4, 0, False),
    "popless_mixed": (4096, 3000, 4, (0.0, 0.35, 0.2, 0.0), "tanimoto", (1.0, 1.0), 4096, 32, 0, True),
}


def _words(rng, n, density=0.1):
    bits = rng.random((n, 1024)) < density
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _case(name):
    n, n_valid, b, cut, sim, ab, chunk, block, offset, popless = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    words = _words(rng, n)
    if n_valid < n:
        words[n_valid:] = 0
    queries = words[:b].copy()
    if name == "popless_mixed":
        queries[3] = 0  # a zero query scores 0 everywhere
    if cut is None:
        cut = np.linspace(0.0, 0.3, b, dtype=np.float32)
    return dict(words=words, queries=queries, cutoffs=np.float32(cut), sim=sim,
                ab=np.float32(ab), chunk=chunk, block=block, offset=offset,
                popless=popless, n_valid=n_valid)


def _port_args(c, device="cpu"):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    planar = np.ascontiguousarray(c["words"].T).view(np.int32)
    pops = None if c["popless"] else t(popcount_rows_np(c["words"]).astype(np.int16))
    # the port has no shard offset: columns valid in the JAX shard's frame
    # [offset, n_valid) are [0, n_valid - offset) here
    return (
        t(planar), pops, t(c["queries"].view(np.int32)),
        t(popcount_rows_np(c["queries"])), t(c["cutoffs"]), t(c["ab"]),
        c["n_valid"] - c["offset"], c["block"], c["sim"],
    )


def _tversky_np(words, q, ab, n_valid):
    """Tversky scores with every f32 op rounded on its own."""
    c = np.stack([
        np.unpackbits((words & qi).view(np.uint8), axis=1).sum(axis=1) for qi in q
    ]).astype(np.float32)
    qp = popcount_rows_np(q).astype(np.float32)[:, None]
    dp = popcount_rows_np(words).astype(np.float32)[None, :]
    denom = ab[0] * (qp - c) + ab[1] * (dp - c) + c
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(denom > 0, c / np.maximum(denom, np.float32(1e-30)), 0)
    s = np.where((c == denom) & (denom > 0), 1, s).astype(np.float32)
    s[:, n_valid:] = -np.inf
    return s


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_phase1_matches_pallas_interpret(name):
    import jax.numpy as jnp

    from gpusimilarity_tpu.ops.pallas_scan import pallas_phase1

    c = _case(name)
    planar = np.ascontiguousarray(c["words"].T)
    pops = popcount_rows_np(c["words"])
    jbmax, jcnt = pallas_phase1(
        jnp.asarray(planar),
        jnp.zeros((1,), jnp.int16) if c["popless"] else jnp.asarray(pops),
        jnp.asarray(c["queries"]), jnp.asarray(popcount_rows_np(c["queries"])),
        jnp.asarray(c["cutoffs"]), jnp.float32(c["ab"][0]),
        jnp.float32(c["ab"][1]), jnp.int32(c["offset"]),
        chunk=c["chunk"], block=c["block"], n_valid=c["n_valid"],
        similarity=c["sim"], popless=c["popless"], interpret=True,
    )
    jbmax, jcnt = np.asarray(jbmax), np.asarray(jcnt)

    launches = kernels.launches(ph1.KERNEL)
    bmax, cnt = ph1.dense_phase1(*_port_args(c))
    assert kernels.launches(ph1.KERNEL) == launches  # the CPU path never launches
    assert bmax.dtype == torch.float32 and cnt.dtype == torch.int64
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    if c["sim"] == "tanimoto":
        np.testing.assert_array_equal(bmax.numpy().view(np.int32), jbmax.view(np.int32))
    else:
        np.testing.assert_allclose(bmax.numpy(), jbmax, rtol=1e-6)
        ref = _tversky_np(c["words"], c["queries"], c["ab"], c["n_valid"])
        ref = ref.reshape(len(ref), -1, c["block"]).max(axis=-1)
        np.testing.assert_array_equal(bmax.numpy().view(np.int32), ref.view(np.int32))
    if name == "padding_masked":
        assert np.isneginf(bmax.numpy()[0, -2:]).all() and int(cnt[0]) == 700
    if name == "shard_offset":
        assert int(cnt[0]) == 200 and np.isneginf(bmax.numpy()[0, 50:]).all()
    if name == "popless_mixed":
        assert bmax[3].max().item() == 0.0 and int(cnt[0]) == 3000


def test_wrapper_validates_inputs():
    c = _case("tversky")
    args = list(_port_args(c))
    bad = list(args)
    bad[1] = bad[1].to(torch.int32)  # pops must be int16
    with pytest.raises(ValueError, match="int16"):
        ph1.dense_phase1(*bad)
    bad = list(args)
    bad[7] = 3  # block must be a power of two
    with pytest.raises(ValueError, match="power of two"):
        ph1.dense_phase1(*bad)
    with pytest.raises(ValueError, match="similarity"):
        ph1.dense_phase1(*args[:8], "cosine")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ph1.dense_phase1_kernel(*args)


@pytest.fixture(scope="module")
def jax_store():
    """A JAX dense store on the 8-device CPU mesh and the rows it holds."""
    from gpusimilarity_tpu.parallel import sharded as jsharded

    rng = np.random.default_rng(0xD5)
    words = _words(rng, 20000, density=0.05)
    return words, jsharded.build_store(words, chunk_cols=512)


@pytest.mark.parametrize("popless", [False, True], ids=["pops", "popless"])
def test_dense_store_from_jax_round_trip(jax_store, popless):
    from gpusimilarity_tpu_torch.utils.convert import dense_store_from_jax

    words, jstore = jax_store
    st = dense_store_from_jax(
        np.asarray(jstore.words),
        None if popless else np.asarray(jstore.popcounts), len(words), "cpu",
    )
    own = sharded.build_store(words, "cpu", popless=popless)
    assert st.n_padded == own.n_padded == sharded.plan_store_layout(20000)
    assert torch.equal(st.words, own.words)
    if popless:
        assert st.popcounts is None and own.popcounts is None
    else:
        assert torch.equal(st.popcounts, own.popcounts)
    assert torch.equal(
        st.words[:, :20000].T.contiguous(),
        torch.from_numpy(words.view(np.int32)),
    )


@pytest.mark.parametrize("fold,popless", [(1, False), (4, False), (1, True)],
                         ids=["fold1", "fold4", "popless"])
def test_build_store_from_rows_on_their_device(jax_store, fold, popless):
    """Packed rows already in an int32 tensor build the store the numpy
    rows build, on the tensor's device; other dtypes raise."""
    words = jax_store[0]
    rows = torch.from_numpy(words.view(np.int32))
    got = sharded.build_store(rows, fold_factor=fold, popless=popless)
    want = sharded.build_store(words, "cpu", fold_factor=fold, popless=popless)
    assert got.words.device == rows.device and got.n_valid == want.n_valid
    assert torch.equal(got.words, want.words)
    if popless:
        assert got.popcounts is None
    else:
        assert torch.equal(got.popcounts, want.popcounts)
    with pytest.raises(ValueError, match="int32"):
        sharded.build_store(rows.to(torch.int64))


@pytest.mark.parametrize(
    "similarity,ab,block", [("tanimoto", (1.0, 1.0), 4), ("tanimoto", (1.0, 1.0), 256),
                            ("tversky", (0.7, 0.3), 32)],
)
def test_dense_local_topk_matches_jax_search_and_full_scan(jax_store, similarity, ab, block):
    """Top-k values, indices (lowest index among ties) and counts equal the
    JAX search program's (Pallas phase 1) and the port's plain full scan."""
    from gpusimilarity_tpu.parallel import sharded as jsharded
    from gpusimilarity_tpu_torch.utils.convert import dense_store_from_jax

    words, jstore = jax_store
    q = np.concatenate([words[[3, 777, 19999]], words[[50]] ^ np.uint32(1 << 9)])
    qp = popcount_rows_np(q)
    cut = np.float32([0.0, 0.2, 0.1, 0.3])
    k = 128
    fn = jsharded.build_search_fn(jstore, k, similarity, 4, use_pallas=True)
    jv, ji, japprox = (np.asarray(x) for x in fn(q, qp, cut, np.float32(ab[0]),
                                                 np.float32(ab[1])))
    st = dense_store_from_jax(np.asarray(jstore.words), np.asarray(jstore.popcounts),
                              20000, "cpu")
    qt = torch.from_numpy(q.view(np.int32))
    vals, idx, cnt = sharded.dense_local_topk(
        st, qt, torch.from_numpy(qp), torch.from_numpy(cut), k, similarity, *ab,
        block=block,
    )
    np.testing.assert_array_equal(cnt.numpy(), japprox.astype(np.int64).sum(axis=0))
    np.testing.assert_array_equal(idx.numpy(), ji)
    if similarity == "tanimoto":
        np.testing.assert_array_equal(vals.numpy(), jv)
    else:
        np.testing.assert_allclose(vals.numpy(), jv, rtol=1e-6)
    fv, fi, fc = full_scan_topk(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(popcount_rows_np(words)), qt, k,
        torch.from_numpy(cut), similarity, *ab,
    )
    assert torch.equal(vals, fv) and torch.equal(idx, fi) and torch.equal(cnt, fc)
    ov, oi, oc = sharded.dense_full_scan_topk(
        st, qt, torch.from_numpy(qp), torch.from_numpy(cut), k, similarity, *ab,
        chunk_cols=3000,
    )
    assert torch.equal(vals, ov) and torch.equal(idx, oi) and torch.equal(cnt, oc)


@pytest.mark.parametrize(
    "similarity,ab,popless",
    [("tanimoto", (1.0, 1.0), False), ("tversky", (0.7, 0.3), False),
     ("tanimoto", (1.0, 1.0), True)],
    ids=["tanimoto", "tversky", "popless"],
)
@pytest.mark.parametrize("blocks_per_chunk", [1, 7, 300])
def test_phase2_chunks_equal_the_unchunked_path(
    jax_store, similarity, ab, popless, blocks_per_chunk, monkeypatch
):
    """Phase 2 walked in (query, block-group) chunks of one block, of a few
    and of more than one query's blocks returns the values, indices and
    counts of one chunk over the whole batch, bit for bit."""
    words = jax_store[0]
    st = sharded.build_store(words, "cpu", fold_factor=4, popless=popless)
    q = np.concatenate([words[[3, 777, 19999]], words[[50]] ^ np.uint32(1 << 9),
                        np.zeros((1, 32), np.uint32)])
    qf = np.ascontiguousarray(fold_words(q, 4))
    args = (st, torch.from_numpy(qf.view(np.int32)), torch.from_numpy(popcount_rows_np(qf)),
            torch.from_numpy(np.float32([0.0, 0.2, 0.1, 0.3, 0.0])), 128, similarity, *ab)
    block = 32
    monkeypatch.setattr(sharded, "_PHASE2_CHUNK_BYTES", 1 << 40)
    want = sharded.dense_local_topk(*args, block=block)
    monkeypatch.setattr(sharded, "_PHASE2_CHUNK_BYTES",
                        blocks_per_chunk * st.word_count * block * 4)
    got = sharded.dense_local_topk(*args, block=block)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    full = sharded.dense_full_scan_topk(*args)
    for g, w in zip(got, full):
        assert torch.equal(g, w)


def test_phase2_memory_stays_under_the_cap_at_the_largest_request(monkeypatch):
    """The largest search the server admits (batch 64, return_count 10,000:
    131,072 blocks fetched at fold 4) on a store of as many 8-column blocks:
    no candidate tensor phase 2 asks for exceeds the cap, where one gather of
    the whole batch would be 64 times 131,072 blocks; results stay exact."""
    from gpusimilarity_tpu_torch.models.fingerprint_db import _k_bucket
    from gpusimilarity_tpu_torch.ops.fold import overfetch_count

    k_fetch, b, block, wf = 131_072, 64, 8, 1
    n = k_fetch * block
    assert _k_bucket(overfetch_count(10_000, 4), 1 << 30) == k_fetch
    rng = np.random.default_rng(55)
    words = torch.from_numpy(
        rng.integers(0, 1 << 32, (wf, n), dtype=np.uint64).astype(np.uint32).view(np.int32))
    st = sharded.DenseStore(words=words, popcounts=sharded.dense_popcounts(words),
                            n_valid=n - 5)
    q = words[:, :b].T.contiguous()
    qp = popcount_rows_np(q.numpy().view(np.uint32))
    cap = 1 << 22
    monkeypatch.setattr(sharded, "_PHASE2_CHUNK_BYTES", cap)
    # phase 1 in narrow column chunks: the plain version's temporaries are
    # not what this test measures
    monkeypatch.setattr(
        sharded, "dense_phase1",
        lambda *a: ph1.dense_phase1_plain(*a, chunk_cols=1 << 16),
    )
    asked = []
    score = sharded.score_columns

    def measuring(cand, cand_pops, *rest):
        asked.append(cand.numel() * cand.element_size())
        return score(cand, cand_pops, *rest)

    monkeypatch.setattr(sharded, "score_columns", measuring)
    vals, idx, cnt = sharded.dense_local_topk(
        st, q, torch.from_numpy(qp), torch.zeros(b), k_fetch, block=block)
    assert max(asked) <= cap and len(asked) == b * (k_fetch * wf * block * 4 // cap)
    assert b * k_fetch * wf * block * 4 == 64 * cap  # what one gather would have taken
    assert vals.shape == idx.shape == (b, k_fetch) and cnt.tolist() == [n - 5] * b
    monkeypatch.setattr(sharded, "score_columns", score)
    fv, fi, fc = sharded.dense_full_scan_topk(
        st, q[:1], torch.from_numpy(qp[:1]), torch.zeros(1), k_fetch)
    assert torch.equal(vals[:1], fv) and torch.equal(idx[:1], fi) and torch.equal(cnt[:1], fc)


def test_fewer_blocks_than_k_keeps_every_block():
    """300 rows, two 256-column blocks, k 600: selection keeps both blocks
    and stays exact; padding columns and the entries past them come back
    as -inf (the engine drops them)."""
    rng = np.random.default_rng(9)
    words = _words(rng, 300)
    st = sharded.build_store(words, "cpu")
    q = words[[0, 299]]
    vals, idx, cnt = sharded.dense_local_topk(
        st, torch.from_numpy(q.view(np.int32)),
        torch.from_numpy(popcount_rows_np(q)), torch.zeros(2), 600,
    )
    fv, fi, fc = full_scan_topk(
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(popcount_rows_np(words)),
        torch.from_numpy(q.view(np.int32)), 300, torch.zeros(2),
    )
    assert torch.equal(vals[:, :300], fv) and torch.equal(idx[:, :300], fi)
    assert torch.isneginf(vals[:, 300:]).all()
    assert idx[:, 300:512].tolist() == [list(range(300, 512))] * 2
    assert (idx[:, 512:] == -1).all()
    assert cnt.tolist() == [300, 300]


@pytest.mark.parametrize("b,wf,launches", [
    (1, 8, 1), (32, 8, 1), (33, 8, 2), (48, 4, 2), (64, 8, 2), (128, 32, 4),
    (16, 64, 1), (17, 64, 2), (20, 64, 2), (64, 64, 4),
])
def test_kernel_launches_counts_one_per_slice_of_the_batch(b, wf, launches):
    """The C entry walks a batch in slices of 32 queries, 16 at rows over 32
    words; the launch count counts each slice."""
    assert ph1.kernel_launches(b, wf) == launches


def test_slice_sizes_are_the_c_entrys():
    """``KERNEL_MAX_QUERIES`` and ``KERNEL_MAX_QUERIES_WIDE`` are the numbers
    the C entry slices by (``max_queries`` in ``csrc/dense_phase1.cu``)."""
    src = (Path(ph1.__file__).parent.parent / "csrc" / "dense_phase1.cu").read_text()
    m = re.search(r"int max_queries\(int wf\) \{ return wf <= (\d+) \? (\d+) : (\d+); \}", src)
    assert m, "max_queries not found"
    assert tuple(map(int, m.groups())) == (
        ph1.KERNEL_MAX_WORDS // 2, ph1.KERNEL_MAX_QUERIES, ph1.KERNEL_MAX_QUERIES_WIDE)
    assert src.count("max_queries(a.wf)") == 1  # every slice walk uses it


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_cuda(name, cuda_device):
    """The CUDA kernel and the plain version agree bit for bit on the card
    (blocks of 4 widened to the kernel's narrowest, 8)."""
    args = list(_port_args(_case(name), cuda_device))
    args[7] = max(args[7], ph1.KERNEL_MIN_BLOCK)
    before = kernels.launches(ph1.KERNEL)
    bmax, cnt = ph1.dense_phase1(*args)
    assert kernels.launches(ph1.KERNEL) == before + 1
    pbmax, pcnt = ph1.dense_phase1_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bmax.view(torch.int32), pbmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)


# name -> (fold, rows, n_valid, B, cutoffs cycled over the batch, similarity,
#          alpha/beta, popless); where the kernel's code forks
FORK_CASES = {
    "mixed_cutoffs_b32": (4, 20000, 19777, 32, (0.0, 0.1, 1.0, -0.5, 0.35), "tanimoto", (1.0, 1.0), False),
    "tversky_b32": (4, 20000, 19777, 32, (0.15, 0.0), "tversky", (0.7, 0.3), False),
    "popless_b32": (4, 20000, 19777, 32, (0.0, 0.1), "tanimoto", (1.0, 1.0), True),
    "b1": (4, 20000, 19777, 1, (0.1,), "tanimoto", (1.0, 1.0), False),
    "b5_not_multiple_of_16": (4, 20000, 19777, 5, (0.12, 1.0), "tanimoto", (1.0, 1.0), False),
    "b48_two_slices": (4, 20000, 19777, 48, (0.0, 0.1, 1.0), "tanimoto", (1.0, 1.0), False),
    "fold8_wf4": (8, 9000, 9000, 32, (0.0, 0.2), "tanimoto", (1.0, 1.0), False),
    "fold2_wf16": (2, 9000, 8999, 32, (0.0, 0.05), "tanimoto", (1.0, 1.0), False),
    "unfolded_wf32_b128": (1, 9000, 8191, 128, (0.0, 0.03), "tanimoto", (1.0, 1.0), False),
    "unfolded_tversky_popless": (1, 5000, 4097, 17, (0.03,), "tversky", (0.3, 0.7), True),
}


def _fork_args(name, device):
    from gpusimilarity_tpu_torch.ops.fold import fold_words

    fold, n, n_valid, b, cuts, sim, ab, popless = FORK_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    rows = _words(rng, n, density=0.045)
    rows[n_valid:] = 0
    q = rows[rng.integers(0, n_valid, b)].copy()
    q[-1] = 0 if b > 1 else q[-1]  # a zero query in every batch over 1
    store = sharded.build_store(rows, device, fold_factor=fold, popless=popless)
    qf = np.ascontiguousarray(fold_words(q, fold))
    cut = np.resize(np.float32(cuts), b)
    return (
        store.words, store.popcounts, torch.from_numpy(qf.view(np.int32)).to(device),
        torch.from_numpy(popcount_rows_np(qf)).to(device),
        torch.from_numpy(cut).to(device),
        torch.tensor(ab, dtype=torch.float32, device=device), n_valid, 256, sim,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FORK_CASES))
def test_kernel_forks_match_plain_on_cuda(name, cuda_device):
    """The CUDA kernel agrees with the plain version bit for bit where its
    code forks: cutoffs 0, 0.35, 1.0 and a negative one mixed in one launch,
    Tversky, popless, batches of 1, 5, 32, 48 and 128, rows of 4, 8, 16 and
    32 words, ``n_valid`` off a block boundary."""
    args = _fork_args(name, cuda_device)
    before = kernels.launches(ph1.KERNEL)
    bmax, cnt = ph1.dense_phase1(*args)
    assert kernels.launches(ph1.KERNEL) - before == ph1.kernel_launches(*args[2].shape)
    pbmax, pcnt = ph1.dense_phase1_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bmax.view(torch.int32), pbmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)
    if args[2].shape[0] > 1:
        assert bmax[-1].max().item() == 0.0  # the zero query


@pytest.mark.cuda
@pytest.mark.parametrize("wf", [4, 8, 16, 32, 64])
def test_launch_count_is_the_kernels_slices_on_cuda(wf, cuda_device):
    """The built C entry reports the slice size the launch count assumes,
    and a batch of 40 counts as that many launches."""
    import ctypes

    fn = kernels.bind(ph1.KERNEL, "gpusim_dense_phase1_max_queries", [ctypes.c_int])
    assert fn(wf) == (ph1.KERNEL_MAX_QUERIES if wf <= 32 else ph1.KERNEL_MAX_QUERIES_WIDE)
    rng = np.random.default_rng(wf)
    words = torch.from_numpy(rng.integers(0, 2**31, (wf, 2048), dtype=np.int32)).to(cuda_device)
    q = words[:, :40].T.contiguous()
    before = kernels.launches(ph1.KERNEL)
    _bmax, cnt = ph1.dense_phase1(
        words, None, q, popcount_rows(q), torch.zeros(40, device=cuda_device),
        torch.ones(2, device=cuda_device), 2048, 256)
    torch.cuda.synchronize()
    assert kernels.launches(ph1.KERNEL) - before == -(-40 // fn(wf)) == ph1.kernel_launches(40, wf)
    assert cnt.tolist() == [2048] * 40


@pytest.mark.cuda
@pytest.mark.parametrize("block", [8, 64])
def test_kernel_small_blocks_and_unaligned_prefix_on_cuda(block, cuda_device):
    """The kernel on blocks narrower than a staged sub-tile, and on
    a column prefix whose width is no multiple of the sub-tile (the plain-load
    staging path)."""
    args = list(_fork_args("mixed_cutoffs_b32", cuda_device))
    cols = 20000 // 64 * 64 - 64  # a prefix: same row stride, ragged last sub-tile
    args[0], args[1], args[7] = args[0][:, :cols], args[1][:cols], block
    bmax, cnt = ph1.dense_phase1_kernel(*args)
    pbmax, pcnt = ph1.dense_phase1_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bmax.view(torch.int32), pbmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)


@pytest.mark.cuda
@pytest.mark.parametrize("similarity", ["tanimoto", "tversky"])
def test_kernel_2048_bit_rows_on_cuda(similarity, cuda_device):
    """Rows of 64 words (eight k steps; 16 queries per kernel launch, so a
    batch of 20 runs as two slices) against the plain version."""
    rng = np.random.default_rng(64)
    bits = rng.random((3000, 2048)) < 0.04
    rows = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    q = rows[rng.integers(0, 2900, 20)].copy()
    q[-1] = 0
    store = sharded.build_store(rows, cuda_device)
    args = (
        store.words, store.popcounts, torch.from_numpy(q.view(np.int32)).to(cuda_device),
        torch.from_numpy(popcount_rows_np(q)).to(cuda_device),
        torch.from_numpy(np.resize(np.float32([0.0, 0.03, 1.0]), 20)).to(cuda_device),
        torch.tensor([0.7, 0.3], dtype=torch.float32, device=cuda_device), 2900, 64,
        similarity,
    )
    bmax, cnt = ph1.dense_phase1(*args)
    pbmax, pcnt = ph1.dense_phase1_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bmax.view(torch.int32), pbmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)


@pytest.mark.cuda
@pytest.mark.parametrize("popless", [False, True], ids=["pops", "popless"])
def test_kernel_on_a_view_off_16_byte_alignment_on_cuda(popless, cuda_device):
    """A column window that starts 3 columns into the store: no address is
    16-byte aligned, so every sub-tile is staged with plain loads."""
    args = list(_fork_args("popless_b32" if popless else "mixed_cutoffs_b32", cuda_device))
    cols = 19 * 1024
    args[0] = args[0][:, 3:3 + cols]
    args[1] = None if popless else args[1][3:3 + cols].clone()  # contiguous, as the wrapper asks
    args[6] = cols - 100
    bmax, cnt = ph1.dense_phase1(*args)
    pbmax, pcnt = ph1.dense_phase1_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bmax.view(torch.int32), pbmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)
