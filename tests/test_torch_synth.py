"""PyTorch port: the device half of the virtual library against the host
mixer (``virtual_rows_np``) and the JAX device generator, on the CPU."""

import numpy as np
import pytest

import torch

from gpusimilarity_tpu.utils.synth import virtual_rows_np
from gpusimilarity_tpu_torch.ops.fold import fold_words
from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
from gpusimilarity_tpu_torch.utils import synth


@pytest.mark.parametrize(
    "row0,n,seed,word_count",
    [(0, 1000, 0, 32), (255, 513, 7, 32), ((1 << 31) - 300, 700, 3, 32),
     ((1 << 32) - 600, 600, 1, 32), (1_020_017_472 - 257, 257, 2026, 32),
     (12345, 300, 5, 64)],
    ids=["start", "cluster_edges", "near_2^31", "top_of_uint32", "enamine_end",
         "2048_bits"],
)
def test_virtual_rows_match_numpy(row0, n, seed, word_count):
    got = synth.virtual_rows(row0, n, word_count, seed)
    assert got.dtype == torch.int32 and got.shape == (n, word_count)
    want = virtual_rows_np(np.arange(row0, row0 + n), word_count, seed)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_virtual_rows_reject_rows_past_uint32():
    with pytest.raises(ValueError):
        synth.virtual_rows((1 << 32) - 10, 20)


@pytest.mark.parametrize("fold", [1, 4])
def test_virtual_folded_rows_match_numpy(fold, monkeypatch):
    monkeypatch.setattr(synth, "_GEN_ROWS", 1024)  # several generation steps
    got = synth.virtual_folded_rows(3000, fold, seed=9)
    want = fold_words(virtual_rows_np(np.arange(3000), seed=9), fold)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("popless", [False, True], ids=["pops", "popless"])
@pytest.mark.parametrize("fold", [2, 4])
def test_virtual_dense_store_matches_jax(fold, popless, monkeypatch):
    """Words and popcounts of the valid columns equal the JAX generator's
    (its padding columns hold mixer rows, the port's zeros; both are
    masked by ``n_valid``)."""
    from gpusimilarity_tpu.utils import synth as jsynth

    monkeypatch.setattr(synth, "_GEN_ROWS", 2048)
    n = 10_000
    st = synth.build_virtual_dense_store(n, fold, seed=4, popless=popless)
    jst = jsynth.build_virtual_dense_store(n, fold, seed=4, popless=popless,
                                           chunk_cols=512)
    assert st.n_valid == n and st.word_count == 32 // fold
    words = st.words.numpy().view(np.uint32)
    np.testing.assert_array_equal(words[:, :n], np.asarray(jst.words)[:, :n])
    assert not words[:, n:].any()
    want = fold_words(virtual_rows_np(np.arange(n), seed=4), fold)
    np.testing.assert_array_equal(words[:, :n].T, want)
    if popless:
        assert st.popcounts is None and jst.popcounts is None
    else:
        np.testing.assert_array_equal(
            st.popcounts.numpy()[:n], np.asarray(jst.popcounts)[:n]
        )
        np.testing.assert_array_equal(st.popcounts.numpy()[:n], popcount_rows_np(want))


@pytest.mark.parametrize("fold", [1, 4])
def test_pick_query_rows_matches_jax(fold):
    from gpusimilarity_tpu.utils import synth as jsynth

    got = synth.pick_query_rows(12, 1_000_000, fold, seed=3, max_planes=48)
    want = jsynth.pick_query_rows(12, 1_000_000, fold, seed=3, max_planes=48)
    np.testing.assert_array_equal(got, want)
    rows = fold_words(virtual_rows_np(got, seed=3), fold)
    assert (popcount_rows_np(rows) <= 48).all()
