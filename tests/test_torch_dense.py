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

import numpy as np
import pytest

import torch

from gpusimilarity_tpu_torch.ops import dense_phase1 as ph1
from gpusimilarity_tpu_torch.ops.scan import full_scan_topk, popcount_rows_np
from gpusimilarity_tpu_torch.parallel import sharded

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

    launches = ph1.launch_count()
    bmax, cnt = ph1.dense_phase1(*_port_args(c))
    assert ph1.launch_count() == launches  # the CPU path never launches
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


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_cuda(name, cuda_device):
    """The CUDA kernel and the plain version agree bit for bit on the card."""
    args = _port_args(_case(name), cuda_device)
    before = ph1.launch_count()
    bmax, cnt = ph1.dense_phase1(*args)
    assert ph1.launch_count() == before + 1
    pbmax, pcnt = ph1.dense_phase1_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bmax.view(torch.int32), pbmax.view(torch.int32))
    assert torch.equal(cnt, pcnt)
