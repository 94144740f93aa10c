"""The frozen row generator, the reference's answers and the judge."""

import zlib

import numpy as np
import pytest
import torch

from reference.compare import LIMITS, judge, passes
from reference.rows import fold_np, popcount_np, rows_np, rows_torch
from reference.search import k_fetch, reference_answers, tanimoto_np

IDX = np.array([0, 1, 255, 256, 113_335_290, 1_020_017_471, 2**31 + 5, 2**32 - 1])
# crc32 of the little-endian words of rows IDX, and their popcounts: fixed
# values of the synthetic library's generator, which the server's loader
# also follows (a change to either shows here or as wrong answers)
PINNED = {
    0: (0x6B6DDAD4, [42, 55, 49, 30, 49, 51, 43, 28]),
    7: (0xF6F991D7, [38, 43, 46, 41, 45, 34, 31, 27]),
    3_000_000_019: (0xFF2B5661, [36, 48, 45, 37, 28, 38, 38, 38]),
    2**40 + 3: (0x06950E08, [39, 46, 31, 31, 38, 30, 43, 35]),
}


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_rows_pinned(seed):
    rows = rows_np(IDX, 32, seed)
    crc, pops = PINNED[seed]
    assert zlib.crc32(rows.astype("<u4").tobytes()) == crc
    assert popcount_np(rows).tolist() == pops


@pytest.mark.parametrize("row0,n", [(0, 1000), (2**31 - 300, 700), (1_020_017_000, 472)])
def test_rows_torch_equal_numpy(row0, n):
    seed = 3_000_000_019
    got = rows_torch(row0, n, 32, seed, "cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got, rows_np(np.arange(row0, row0 + n), 32, seed))


@pytest.mark.cuda
def test_rows_on_card_equal_numpy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = rows_torch(2**31 - 5000, 1 << 16, 32, 7, "cuda").cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(got, rows_np(np.arange(2**31 - 5000, 2**31 - 5000 + (1 << 16)), 32, 7))


def test_k_fetch():
    assert k_fetch(20, 1, 10**9) == 128
    assert k_fetch(20, 4, 10**9) == 256      # ceil(20 * 4 * 3) = 240
    assert k_fetch(128, 4, 10**9) == 2048    # 1536
    assert k_fetch(20, 4, 100) == 100


def brute_force(n, fold, seed, q, k):
    rows = rows_np(np.arange(n), 32, seed)
    qf = rows_np(np.array([q]), 32, seed)[0]
    full = tanimoto_np(popcount_np(rows & qf), popcount_np(qf[None])[0], popcount_np(rows))
    idx = np.arange(n)
    if fold > 1:
        fr, fq = fold_np(rows, fold), fold_np(qf[None], fold)[0]
        fs = tanimoto_np(popcount_np(fr & fq), popcount_np(fq[None])[0], popcount_np(fr))
        idx = np.lexsort((idx, -fs))[:k_fetch(k, fold, n)]
    order = np.lexsort((idx, -full[idx]))[:k]
    return idx[order], full[idx][order]


@pytest.mark.parametrize("fold", [1, 4])
def test_reference_equals_brute_force(fold):
    n, seed = 6000, 2**33 + 1
    queries = np.array([5, 700, 4095])
    ans, _ = reference_answers(n, 32, fold, seed, queries, [20] * 3, [0.0] * 3, "cpu",
                               block_rows=1000)
    for q, a in zip(queries, ans):
        idx, scores = brute_force(n, fold, seed, q, 20)
        np.testing.assert_array_equal(a.idx, idx)
        np.testing.assert_array_equal(a.scores, scores)
        assert a.count == n
        assert a.idx[0] == q and a.scores[0] == 1.0


def as_served(answers, text=str):
    return [{"approximate_count": a.count,
             "results": [[text(int(i)), text(int(i)), float(s)]
                         for i, s in zip(a.idx, a.scores)]} for a in answers]


def judge_answers(answers, ref, queries, seed):
    return judge(as_served(answers), ref, queries, 32, seed,
                 lambda t: int(t) if t.isdigit() else None, str, 0)


@pytest.mark.parametrize("fold,controls", [(1, ("half_scores",)),
                                           (4, ("half_scores", "no_rescore"))])
def test_controls_fail_and_reference_passes(fold, controls):
    """The check's control, kept at a size a test run holds: the reference
    with one guarantee broken must read over a limit on every seed, the
    reference itself at 0."""
    n = 20000
    for seed in (1, 2, 3_000_000_019):
        queries = np.random.default_rng(seed).choice(n, 16, replace=False)
        ref, ctl = reference_answers(n, 32, fold, seed, queries, [20] * 16,
                                     [0.0] * 16, "cpu", controls)
        numbers, faulty = judge_answers(ref, ref, queries, seed)
        assert passes(numbers) and not any(faulty)
        for name in controls:
            numbers, _ = judge_answers(ctl[name], ref, queries, seed)
            assert not passes(numbers), (name, seed, numbers)
            assert numbers["wrong_rows"] >= 16


def test_judge_counts_each_fault():
    n, seed = 5000, 9
    queries = np.array([10, 20])
    ref, _ = reference_answers(n, 32, 1, seed, queries, [10, 10], [0.0, 0.0], "cpu")
    served = as_served(ref)
    served[0]["results"][3][2] += 1e-3                    # an altered score
    served[1]["results"][1], served[1]["results"][2] = (  # two rows swapped
        served[1]["results"][2], served[1]["results"][1])
    served[1]["approximate_count"] -= 1
    numbers, faulty = judge(served, ref, queries, 32, seed,
                            lambda t: int(t), str, 2)
    assert numbers["unanswered"] == 2
    assert numbers["wrong_rows"] == 1
    assert numbers["misordered"] >= 1 and numbers["wrong_counts"] == 1
    assert faulty == [True, True]
    numbers, faulty = judge([None, served[0]], ref, queries, 32, seed,
                            lambda t: int(t), str, 0)
    assert numbers["short_ranks"] >= 10 and faulty[0]
    assert set(numbers) == set(LIMITS)
