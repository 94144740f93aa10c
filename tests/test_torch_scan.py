"""PyTorch port: popcount, scoring and tie-order top-k against the JAX
package and numpy, on the CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gpusimilarity_tpu.ops import scan as jscan
from gpusimilarity_tpu_torch.ops import scan as tscan
from gpusimilarity_tpu_torch.ops.topk import topk_lowest_index


def _packed(rng, n, density=0.1):
    bits = rng.random((n, 1024)) < density
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def test_popcount_rows_matches_numpy(rng):
    words = _packed(rng, 257, density=0.5)
    words[0] = 0xFFFFFFFF
    words[1] = 0x80000000
    words[2] = 0
    got = tscan.popcount_rows(_t(words)).numpy()
    np.testing.assert_array_equal(got, jscan.popcount_rows_np(words))
    np.testing.assert_array_equal(tscan.popcount_rows_np(words), got)


def test_popcount_words_edge_values():
    vals = np.array(
        [0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555, 0xAAAAAAAA,
         0x80000001, 0xFFFF0000],
        np.uint32,
    )
    want = [bin(int(v)).count("1") for v in vals]
    assert tscan.popcount_words(_t(vals)).tolist() == want


def _counts(seed, b=4, n=4096):
    rng = np.random.default_rng(seed)
    qpop = rng.integers(0, 1025, b).astype(np.int32)
    dpop = rng.integers(0, 1025, n).astype(np.int32)
    lim = np.minimum(qpop[:, None], dpop[None, :])
    common = (rng.random((b, n)) * (lim + 1)).astype(np.int32)
    # zero denominators and exact self-matches
    qpop[0] = 0
    common[0] = 0
    dpop[:8] = 0
    common[:, :8] = 0
    dpop[8] = qpop[1]
    common[1, 8] = qpop[1]
    return common, dpop, qpop


@pytest.mark.parametrize(
    "similarity,alpha,beta",
    [("tanimoto", 1.0, 1.0), ("tversky", 0.7, 0.3), ("tversky", 1.0, 0.25)],
)
def test_similarity_from_counts_matches_jax(similarity, alpha, beta):
    """Tanimoto is bit-exact; Tversky holds rtol 1e-6 because XLA may
    contract its multiply-add into an FMA where the port rounds each op."""
    common, dpop, qpop = _counts(3)
    want = np.asarray(
        jscan.similarity_from_counts(
            jnp.asarray(common), jnp.asarray(dpop), jnp.asarray(qpop),
            similarity, alpha, beta,
        )
    )
    got = tscan.similarity_from_counts(
        torch.from_numpy(common), torch.from_numpy(dpop),
        torch.from_numpy(qpop), similarity, alpha, beta,
    ).numpy()
    if similarity == "tanimoto":
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0].max() == 0.0 or similarity == "tversky"
    assert got[1, 8] == 1.0  # self-match pin
    assert not np.isnan(got).any()


def test_f32_division_exact_on_full_grid():
    """IEEE f32 ``/`` in torch equals numpy's correctly rounded quotient on
    every (num <= 2048, 1 <= den <= 4096) pair — why ``exact_div`` (a TPU
    divide repair) has no twin in the port."""
    num = np.arange(0, 2049, dtype=np.float32)
    den = np.arange(1, 4097, dtype=np.float32)
    c, d = np.repeat(num, len(den)), np.tile(den, len(num))
    got = (torch.from_numpy(c) / torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), (c / d).view(np.int32))


@pytest.mark.parametrize(
    "common,dpop,qpop,cutoff",
    [(11, 56, 10, 0.2), (15, 35, 30, 0.3), (15, 50, 15, 0.3)],
)
def test_boundary_counts_match_numpy(common, dpop, qpop, cutoff):
    s = tscan.similarity_from_counts(
        torch.tensor([[common]], dtype=torch.int32),
        torch.tensor([dpop], dtype=torch.int32),
        torch.tensor([qpop], dtype=torch.int32),
    ).item()
    s_np = np.float32(common) / (np.float32(qpop) + np.float32(dpop) - np.float32(common))
    assert np.float32(s) == s_np
    assert (np.float32(s) >= np.float32(cutoff)) == (s_np >= np.float32(cutoff))


@pytest.mark.parametrize("similarity", ["tanimoto", "tversky"])
def test_score_batch_matches_scores_np(rng, similarity):
    words = _packed(rng, 600, density=0.08)
    q = np.concatenate([words[[5, 77]], np.zeros((1, 32), np.uint32)])
    alpha, beta = (0.7, 0.3) if similarity == "tversky" else (1.0, 1.0)
    got = tscan.score_batch(
        _t(words), tscan.popcount_rows(_t(words)), _t(q),
        tscan.popcount_rows(_t(q)), similarity, alpha, beta,
    ).numpy()
    want = jscan.scores_np(words, q, similarity, alpha, beta)
    if similarity == "tanimoto":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 5] == 1.0 and got[1, 77] == 1.0
    assert (got[2] == 0.0).all()


@pytest.mark.parametrize("k", [1, 7, 100, 1000])
def test_topk_lowest_index_matches_lax_top_k(k):
    rng = np.random.default_rng(k)
    s = (rng.integers(-2, 5, (4, 1000)) / 4).astype(np.float32)
    s[rng.random(s.shape) < 0.1] = -np.inf
    vj, ij = jax.lax.top_k(jnp.asarray(s), k)
    vt, it = topk_lowest_index(torch.from_numpy(s), k)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_topk_tiebreak_orders_equal_scores():
    s = torch.tensor([[0.5, 0.5, 0.5, 0.9]])
    order = torch.tensor([[30, 10, 20, 99]])
    v, pos = topk_lowest_index(s, 4, tiebreak=order)
    assert pos.tolist() == [[3, 1, 2, 0]]
    assert v.tolist() == [[pytest.approx(0.9), 0.5, 0.5, 0.5]]


def test_full_scan_topk_matches_numpy_oracle(rng):
    """Chunked oracle on a tie-heavy library (every row appears 3 times):
    values, lowest-index tie order and >=cutoff counts."""
    base = _packed(rng, 200, density=0.05)
    words = np.concatenate([base, base, base])
    q = words[[3, 150]]
    cut = np.array([0.0, 0.15], np.float32)
    v, i, c = tscan.full_scan_topk(
        _t(words), tscan.popcount_rows(_t(words)), _t(q), 25,
        torch.from_numpy(cut), chunk_rows=128,
    )
    s = jscan.scores_np(words, q)
    for b in range(2):
        order = np.lexsort((np.arange(len(words)), -s[b]))[:25]
        np.testing.assert_array_equal(i[b].numpy(), order)
        np.testing.assert_array_equal(v[b].numpy(), s[b][order])
        assert int(c[b]) == int((s[b] >= cut[b]).sum())
