"""PyTorch port: the integer epilogue the CUDA kernels rely on, against the
per-column divide.

The phase-1 kernels count ``score >= cutoff`` as ``c >= cmin[pop]`` and take
a block's maximum by integer cross-multiplication with one divide per block
(``gpusimilarity_tpu_torch/ops/epilogue.py`` states both in plain PyTorch;
``csrc/phase1_epilogue.cuh`` is the CUDA form). Both must give the bits of
``ops/scan.similarity_from_counts``, which divides per column. Here that is
held exhaustively for folded rows: every ``(c, pop, qpop)`` with ``qpop, pop
<= 256``, and a seeded sample of wider rows up to 2048 bits, at cutoffs on
and next to representable quotients, 0, negative and 1.0. The same counts go
through the JAX package's ``similarity_from_counts`` on the CPU: tolerance 0.
Both facts need ``c <= min(qpop, pop)``; the last test holds the store
builders and the engine to the popcounts that guarantee it.
"""

import numpy as np
import pytest

import torch

from gpusimilarity_tpu_torch.ops.epilogue import (
    NEVER,
    cutoff_threshold_table,
    rational_block_max,
    tanimoto_threshold,
)
from gpusimilarity_tpu_torch.ops.scan import similarity_from_counts

FOLD4_BITS = 256

# quotients c / d that some (c, pop, qpop) reaches exactly; each is tested
# with its two float32 neighbours
QUOTIENTS = [(1, 3), (7, 20), (1, 10), (35, 100), (2, 3), (5, 7), (113, 355),
             (1, 256), (255, 257)]


def _cutoffs():
    out = {"zero": 0.0, "negative": -0.25, "negative_zero": -0.0, "one": 1.0,
           "above_one": float(np.nextafter(np.float32(1.0), np.float32(2.0))),
           "below_one": float(np.nextafter(np.float32(1.0), np.float32(0.0))),
           "tiny": float(np.float32(1e-30)), "nan": float("nan")}
    for c, d in QUOTIENTS:
        q = np.float32(c) / np.float32(d)
        out[f"{c}_{d}"] = float(q)
        out[f"{c}_{d}_up"] = float(np.nextafter(q, np.float32(2.0)))
        out[f"{c}_{d}_down"] = float(np.nextafter(q, np.float32(-1.0)))
    return out


CUTOFFS = _cutoffs()


def _grid_scores(qpop, bits):
    """Scores of every (pop, c) with c <= min(qpop, pop): f32 (bits+1, C) and
    the mask of reachable pairs."""
    pop = torch.arange(bits + 1, dtype=torch.int32)
    c = torch.arange(min(qpop, bits) + 1, dtype=torch.int32)
    grid = c[None, :].expand(bits + 1, -1)
    scores = similarity_from_counts(grid, pop[:, None], torch.tensor(qpop))
    return scores, grid, grid <= pop[:, None]


@pytest.mark.parametrize("name", sorted(CUTOFFS))
def test_threshold_table_is_the_divide_exhaustively_at_fold4(name):
    """For every qpop, pop <= 256 and every reachable c:
    ``(c / (qpop + pop - c) >= cutoff) == (c >= cmin[pop])``."""
    cutoff = CUTOFFS[name]
    cut = torch.tensor(cutoff, dtype=torch.float32)
    for qpop in range(FOLD4_BITS + 1):
        scores, grid, reachable = _grid_scores(qpop, FOLD4_BITS)
        cmin = cutoff_threshold_table(qpop, cutoff, FOLD4_BITS)
        assert cmin.shape == (FOLD4_BITS + 1,)
        by_divide = scores >= cut
        by_table = grid >= cmin[:, None]
        assert torch.equal(by_divide[reachable], by_table[reachable]), (name, qpop)
        if cutoff <= 0:
            assert (cmin == 0).all()  # every score is >= 0: nothing to look up
        if cutoff != cutoff or cutoff > 1:
            assert (cmin == NEVER).all()


@pytest.mark.parametrize("bits", [512, 1024, 2048])
def test_threshold_table_is_the_divide_on_a_sample_of_wide_rows(bits):
    rng = np.random.default_rng(bits)
    names = sorted(CUTOFFS)
    for qpop in [0, 1, bits] + rng.integers(2, bits, 9).tolist():
        scores, grid, reachable = _grid_scores(qpop, bits)
        for name in rng.choice(names, 6, replace=False):
            cutoff = CUTOFFS[name]
            cmin = cutoff_threshold_table(qpop, cutoff, bits)
            by_divide = scores >= torch.tensor(cutoff, dtype=torch.float32)
            assert torch.equal(by_divide[reachable],
                               (grid >= cmin[:, None])[reachable]), (name, qpop)


def _by_threshold(grid, pop, qpop, cutoff, bits):
    """``score >= cutoff`` as the matrix-product kernel tests it: one
    fraction P / Q per query, ``c * (P + Q) >= P * pop + P * max(qpop, 1)``
    in float32, every value below 2**24."""
    qden = max(qpop, 1)
    p, q = tanimoto_threshold(cutoff, qden + bits)
    assert 0 <= p <= max(q, 1) and q <= qden + bits and (p + q) * bits < 1 << 24
    lhs = grid.to(torch.float32) * float(p + q)
    rhs = float(p) * pop.to(torch.float32)[:, None] + float(p * qden)
    assert rhs.max() < 1 << 24
    return lhs >= rhs


@pytest.mark.parametrize("name", sorted(CUTOFFS))
def test_rational_threshold_is_the_divide_exhaustively_at_fold4(name):
    """For every qpop, pop <= 256 and every reachable c the single fraction
    of a query decides ``score >= cutoff`` as the per-column divide does."""
    cutoff = CUTOFFS[name]
    cut = torch.tensor(cutoff, dtype=torch.float32)
    pop = torch.arange(FOLD4_BITS + 1, dtype=torch.int32)
    for qpop in range(FOLD4_BITS + 1):
        scores, grid, reachable = _grid_scores(qpop, FOLD4_BITS)
        by_threshold = _by_threshold(grid, pop, qpop, cutoff, FOLD4_BITS)
        assert torch.equal((scores >= cut)[reachable], by_threshold[reachable]), (name, qpop)


@pytest.mark.parametrize("name", sorted(CUTOFFS))
def test_rational_threshold_is_the_divide_at_1024_bits(name):
    """The same at the matrix-product kernel's own width, for queries of 0,
    1, 1024 and a seeded sample of popcounts."""
    cutoff = CUTOFFS[name]
    cut = torch.tensor(cutoff, dtype=torch.float32)
    rng = np.random.default_rng(sum(map(ord, name)))
    pop = torch.arange(1025, dtype=torch.int32)
    for qpop in [0, 1, 1024] + rng.integers(2, 1024, 4).tolist():
        scores, grid, reachable = _grid_scores(qpop, 1024)
        by_threshold = _by_threshold(grid, pop, qpop, cutoff, 1024)
        assert torch.equal((scores >= cut)[reachable], by_threshold[reachable]), (name, qpop)


def test_rational_threshold_edges():
    assert tanimoto_threshold(0.0, 2048) == (0, 1)
    assert tanimoto_threshold(-1.0, 2048) == (0, 1)
    assert tanimoto_threshold(float("nan"), 2048) == (1, 0)
    assert tanimoto_threshold(1.5, 2048) == (1, 0)
    assert tanimoto_threshold(1.0, 2048) == (1, 1)
    assert tanimoto_threshold(0.5, 2048) == (1, 2)
    # the smallest positive score there is: 1 / max_den
    assert tanimoto_threshold(1e-30, 2048) == (1, 2048)


def test_scores_are_monotone_in_the_count_and_equal_jax():
    """What the table rests on: for fixed qpop and pop the rounded score
    never decreases with c; and the grid equals the JAX package's, bit for
    bit, on the CPU."""
    import jax.numpy as jnp

    from gpusimilarity_tpu.ops.scan import similarity_from_counts as jax_scores

    for qpop in (0, 1, 37, 128, 255, 256):
        scores, grid, reachable = _grid_scores(qpop, FOLD4_BITS)
        step = scores[:, 1:] - scores[:, :-1]
        assert (step[reachable[:, 1:]] >= 0).all()
        pop = np.arange(FOLD4_BITS + 1, dtype=np.int32)
        jax_grid = np.asarray(jax_scores(
            jnp.asarray(grid.numpy()), jnp.asarray(pop[:, None]),
            jnp.asarray(np.int32(qpop)),
        ))
        np.testing.assert_array_equal(
            scores.numpy().view(np.int32)[reachable.numpy()],
            jax_grid.view(np.int32)[reachable.numpy()],
        )


def _random_columns(rng, n, qpop, bits, ties):
    pop = rng.integers(0, bits + 1, n).astype(np.int32)
    if ties:  # few distinct (c, pop) pairs: many equal scores and equal ratios
        pop = rng.choice([qpop, max(qpop // 2, 1), 2 * qpop % (bits + 1)], n).astype(np.int32)
    c = (rng.random(n) * (np.minimum(pop, qpop) + 1)).astype(np.int32)
    if ties:
        c = np.minimum(c // 4 * 4, np.minimum(pop, qpop)).astype(np.int32)
    return torch.from_numpy(c), torch.from_numpy(pop)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("bits,block", [(256, 256), (256, 8), (1024, 32), (2048, 64)])
def test_rational_block_max_is_the_amax_of_the_divides(bits, block, ties):
    """Seeded blocks, a zero query, a self match, blocks that straddle
    ``n_valid`` and blocks past it: the integer running maximum with one
    divide per block has the bits of ``amax`` over per-column divides, here
    and through the JAX package's scores."""
    import jax.numpy as jnp

    from gpusimilarity_tpu.ops.scan import similarity_from_counts as jax_scores

    rng = np.random.default_rng(bits * 1000 + block + ties)
    n = 40 * block
    n_valid = n - 2 * block - block // 2  # one straddling block, two all-invalid
    for qpop in [0, 1, bits // 4, bits] + rng.integers(1, bits, 4).tolist():
        c, pop = _random_columns(rng, n, qpop, bits, ties)
        if qpop:  # a self match in the first block
            c[3], pop[3] = qpop, qpop
        got = rational_block_max(c, pop, qpop, block, n_valid)
        s = similarity_from_counts(c, pop, torch.tensor(qpop))
        s = torch.where(torch.arange(n) < n_valid, s, float("-inf"))
        want = s.view(-1, block).amax(dim=-1)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), qpop
        assert torch.isneginf(got[-2:]).all() and torch.isfinite(got[:-2]).all()
        if qpop:
            assert got[0].item() == 1.0
        js = np.array(jax_scores(jnp.asarray(c.numpy()), jnp.asarray(pop.numpy()),
                                   jnp.asarray(np.int32(qpop))))
        js[n_valid:] = -np.inf
        np.testing.assert_array_equal(
            got.numpy().view(np.int32),
            js.reshape(-1, block).max(axis=-1).view(np.int32),
        )


def test_counts_from_the_table_equal_counts_from_the_divide():
    """A scan's worth of columns: the count of ``c >= cmin[pop]`` over valid
    columns is the count of ``score >= cutoff``, per cutoff."""
    rng = np.random.default_rng(5)
    n, n_valid, qpop = 50_000, 49_321, 43
    c, pop = _random_columns(rng, n, qpop, FOLD4_BITS, ties=False)
    s = similarity_from_counts(c, pop, torch.tensor(qpop))[:n_valid]
    for name, cutoff in CUTOFFS.items():
        cmin = cutoff_threshold_table(qpop, cutoff, FOLD4_BITS)
        by_table = (c >= cmin[pop.long()])[:n_valid].sum()
        by_divide = (s >= torch.tensor(cutoff, dtype=torch.float32)).sum()
        assert int(by_table) == int(by_divide), name


@pytest.mark.parametrize(
    "scan_mode,fold,popless",
    [("dense", 1, False), ("dense", 4, False), ("dense", 4, True),
     ("bitplane", 1, False), ("bitplane", 4, False)],
)
def test_engine_hands_phase1_true_popcounts(scan_mode, fold, popless, monkeypatch):
    """What both facts rest on, ``c <= min(qpop, pop)``: the popcounts the
    store builders keep and the query popcounts the engine passes to phase 1
    are those of the very words (or planes and plane lists) it scans."""
    from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.parallel import sharded
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
    from gpusimilarity_tpu_torch.utils.strings import ConstantStringTable
    from gpusimilarity_tpu_torch.utils.synth import VirtualFingerprints, virtual_rows_np

    n = 3000
    data = FingerprintData(
        dbkey="", bitcount=1024, fingerprints=VirtualFingerprints(n, 1024, seed=7),
        smiles=ConstantStringTable(b"C", n), ids=ConstantStringTable(b"V", n),
    )
    full = virtual_rows_np(np.arange(n), seed=7)
    folded = np.ascontiguousarray(fold_words(full, fold))
    row_pops = popcount_rows_np(folded)
    q = np.concatenate([full[[5, 2999]], np.zeros((1, 32), np.uint32)])
    qf = np.ascontiguousarray(fold_words(q, fold))

    seen = []
    name = "dense_phase1" if scan_mode == "dense" else "bitplane_phase1_batched"
    kernel = getattr(sharded, name)
    monkeypatch.setattr(sharded, name, lambda *a: seen.append(a) or kernel(*a))
    db = FingerprintDB(data, device="cpu", fold_factor=fold, scan_mode=scan_mode,
                       popless=popless)
    db.search_batch(q, 5, 0.2)
    (args,) = seen
    store_words, pops, queries, query_pops = args[:4]
    assert query_pops.tolist() == popcount_rows_np(qf).tolist()
    if popless:
        assert pops is None
    else:
        assert pops[:n].tolist() == row_pops.tolist() and not pops[n:].any()
    if scan_mode == "dense":
        assert np.array_equal(store_words[:, :n].numpy().view(np.uint32).T, folded)
        assert np.array_equal(queries.numpy().view(np.uint32), qf)
    else:
        bitcount = 1024 // fold
        assert ((queries != bitcount).sum(dim=1) == query_pops).all()
        bits = np.unpackbits(folded.view(np.uint8), axis=1, bitorder="little")
        planes = np.unpackbits(store_words[:bitcount].numpy().view(np.uint8), axis=1,
                               bitorder="little")[:, :n]
        assert np.array_equal(planes.T, bits) and not store_words[bitcount].any()
