"""Benchmark of the port: brute-force Tanimoto top-k scan rate on the local
card(s), the twin of the repository's root ``bench.py``::

    python -m gpusimilarity_tpu_torch.tools.bench [--cpu_only]

Prints ONE JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline", ...}``, with every field the root bench prints under the same
names, plus ``card`` (the card's name and power limit as ``nvidia-smi``
gives them, or ``cpu``), ``host_rescore`` (``native`` when
``native/libtpusim_native.so`` is built, else ``numpy``: a fold-4 search
rescores its candidates on the host, so its latency means nothing without
it) and ``kernel_launches`` (each phase-1 kernel's and the bitplane
rescore kernel's launches over the run).
Everything else goes to stderr. The headline is fingerprints scanned per
second per card for one top-128 query, against the reference's 1.25e9
fingerprints/s per V100 (1e9 compounds / 0.2 s / 4 GPUs, BASELINE.md).

Configuration, read from the environment as the root bench reads it:
``TPUSIM_BENCH_FOLD`` (4), ``_ROWS``, ``_K`` (128), ``_BATCH`` (1),
``_REPEATS`` (10), ``_SEED`` (11), ``_VERIFY_ROWS`` (2Mi), ``_ALSO_BATCH``
(32), ``_MODE`` (``bitplane`` or ``dense``), ``_QPOP`` (50) and
``_FULL_ORACLE`` (1). The root bench's ``TPUSIM_BENCH_PALLAS`` has no twin:
on the card the port always runs its kernels.

* Fold > 1 (the default): a virtual library (``utils/synth.py``: rows are a
  function of their index) of 1,020,017,472 rows, Enamine 18/12, the
  reference's folded configuration (451.72 ms on 4x V100, slide 13), built
  folded as a bitplane store on the card (37 GB at fold 4). The timed call is
  the search, the copy of its candidates to the host and their exact
  full-width rescore per query (``utils/synth.rescore_candidates_np``). Then
  a sampled inclusion oracle: every row of a random sample and of the
  query's 256-row cluster that outranks the returned k-th score must be
  among the results. ``TPUSIM_BENCH_MODE=dense`` with a fold raises, as in
  the root bench (``tools/fold_scale.py`` measures dense folds).
* Fold 1: 113,335,291 random rows, Enamine 2/12, the reference's unfolded
  configuration (70.59 ms on 4x V100, slide 12), made on the card slab by
  slab from a seeded ``torch.Generator``; bitplane queries set ``QPOP``
  random bits, dense queries are random words. Each query is also written
  into one row of the library, so the self match and the sampled inclusion
  oracle (the sample's rows regenerated from the same seeds) check the timed
  store itself.

Unless ``TPUSIM_BENCH_FULL_ORACLE=0``, the timed store is then freed and a
virtual library of 2Mi rows (never more than the timed one) is searched in
the same mode and fold at B=1 and B=32, cutoffs 0, 0.2 and 0.3 in turn, and
every answer is held to the whole full-width matrix (``virtual_matrix`` and
``scores_np``): each returned score is its row's full-width score, scores
descend, each count equals the rows whose device score (folded at fold > 1)
reaches the cutoff, and at fold 1 the whole top-k equals the oracle's. At
fold > 1 the recall against the full-width top-k is measured, not required.

Rows default to the H100's configurations above; when the card runs out of
memory the run retries on the next smaller rung of a ladder of the
reference's own sizes, and ``rows`` says which ran. The card is the default
and the run raises without one; ``--cpu_only`` runs the plain versions on
the host, at a small ``TPUSIM_BENCH_ROWS``, for the tests.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ..models.fingerprint_db import _k_bucket
from ..ops.bitplane import PLANE_BUCKETS, query_plane_indices
from ..ops.fold import fold_words, overfetch_count
from ..ops.scan import popcount_rows, popcount_rows_np, scores_np
from ..parallel.mesh import make_mesh
from ..parallel.sharded import (
    DenseStore,
    ShardedStore,
    build_sharded_store,
    empty_bitplane_store,
    fill_bitplane_slab,
    plan_shard_spans,
    plan_store_layout,
    shard_align,
    shard_rows,
    sharded_local_topk,
)
from ..utils import kernels, native
from ..utils.synth import (
    VirtualWords,
    aligned_virtual_rows,
    pick_query_rows,
    rescore_candidates_np,
    virtual_matrix,
    virtual_rows_np,
)
from .probe_b1 import card_line

REFERENCE_FPS_PER_GPU = 1.25e9  # BASELINE.md: the reference's V100 figure
WORDS = 32  # 1024-bit fingerprints
FOLDED_ROWS = 1_020_017_472  # Enamine 18/12, fold 4 (slide 13)
UNFOLDED_ROWS = 113_335_291  # Enamine 2/12, fold 1 (slides 12-13)
# out-of-memory rungs, the reference's smaller configurations (BASELINE.md):
# Enamine 16/12 and 9/12 folded; ZINC12 and ChEMBL unfolded
FOLDED_LADDER = (906_682_211, 510_008_695)
UNFOLDED_LADDER = (16_403_849, 1_618_358)
ORACLE_ROWS = 2 * 1024 * 1024  # the full-width oracle's library
_SLAB_ROWS = 1 << 21  # rows of one random slab of the unfolded library


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(f"TPUSIM_BENCH_{name}", default))


def _env_str(name: str, default: str) -> str:
    return os.environ.get(f"TPUSIM_BENCH_{name}", default)


def _sync(mesh) -> None:
    for dev in mesh.distinct_devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _dispatch_floor_ms(device: torch.device, repeats: int) -> float:
    """Same-run floor: the median of one trivial launch on 8 floats and its
    copy to the host, the fixed cost every timed search pays besides its
    work (twin of the root bench's ``_dispatch_floor_ms``)."""
    x = torch.zeros(8, device=device)
    (x + 1).cpu()
    ts = []
    for _ in range(max(5, repeats)):
        t0 = time.perf_counter()
        (x + 1).cpu()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _measure(run_once, reps: int):
    """``(p50 s, min s, first-call s, last result)`` of ``run_once``; the
    first call is untimed in the median (on the card it builds the kernel)."""
    t0 = time.perf_counter()
    result = run_once()
    first_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        result = run_once()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), first_s, result


def _search(store: ShardedStore, qarg, qpops, cutoffs, k: int):
    """One search of every shard, candidates on the host: numpy ``(vals
    (B, k), idx (B, k), counts int64 (B,))``."""
    vals, idx, counts = sharded_local_topk(
        store, np.ascontiguousarray(qarg), np.asarray(qpops, np.int32),
        np.asarray(cutoffs, np.float32), k,
    )
    return vals.numpy(), idx.numpy(), counts.to(torch.int64).sum(dim=0).numpy()


def _topk_order(scores: np.ndarray, k: int) -> np.ndarray:
    """Rows of the ``k`` best ``scores`` by (-score, index): the lexsort of
    every row, taken only over the rows at or above the k-th score."""
    n = len(scores)
    if k >= n:
        return np.lexsort((np.arange(n), -scores))
    kth = np.partition(scores, n - k)[n - k]
    cand = np.nonzero(scores >= kth)[0]
    return cand[np.lexsort((cand, -scores[cand]))][:k]


def _self_matches(results, rows) -> int:
    return sum(
        1 for bq, (sc, ix) in enumerate(results)
        if len(ix) and ix[0] == rows[bq] and sc[0] == 1.0
    )


def _inclusion(results, k, sample_scores):
    """The sampled inclusion oracle: ``(rows outranking the k-th, of them
    missing from the results)``. ``sample_scores(bq)`` gives query ``bq``'s
    oracle ``(scores, rows)`` of its sample."""
    checked = violations = 0
    for bq, (sc, ix) in enumerate(results):
        if len(sc) < k:
            continue
        s_scores, s_rows = sample_scores(bq)
        beat = s_rows[s_scores > sc[-1]]
        checked += len(beat)
        violations += len(np.setdiff1d(beat, ix))
    return checked, violations


def _full_oracle_extras(mode: str, fold: int, k: int, seed: int, mesh,
                        timed_rows: int) -> dict:
    """Exactness over a whole library (twin of the root bench's
    ``_full_oracle_extras``): a virtual library of ``ORACLE_ROWS`` rows (or
    the timed run's rows, if fewer), searched in the timed run's mode and
    fold at B=1 and B=32 with cutoffs 0/0.2/0.3, every answer held to the
    full-width matrix in host RAM. Hard (0 at any fold): scores, order,
    counts, and at fold 1 the whole top-k sequence. Measured: recall."""
    oseed = seed + 5
    n = aligned_virtual_rows(min(ORACLE_ROWS, timed_rows), mesh.n_shards)
    full = virtual_matrix(n, seed=oseed)
    folded_lib = np.ascontiguousarray(fold_words(full, fold))
    store = build_sharded_store(VirtualWords(n, WORDS, oseed), mesh, mode, fold)
    q_rows = pick_query_rows(32, n, fold, seed=oseed, rng_seed=321)
    full_q = virtual_rows_np(q_rows, seed=oseed)
    folded_q = np.ascontiguousarray(fold_words(full_q, fold))
    folded_pops = popcount_rows_np(folded_q)
    cutoffs = np.array([(0.0, 0.2, 0.3)[i % 3] for i in range(32)], np.float32)
    k_fetch = _k_bucket(overfetch_count(k, fold), n)

    oracle = {}  # query -> (full-width scores, device scores)

    def scores_of(bq):
        if bq not in oracle:
            s = scores_np(full, full_q[bq][None, :])[0]
            dev = s if fold == 1 else scores_np(folded_lib, folded_q[bq][None, :])[0]
            oracle[bq] = (s, dev)
        return oracle[bq]

    score_errors = order_errors = count_mismatches = fold1_mismatches = 0
    recalls = []
    for b in (1, 32):
        if mode == "bitplane":
            qarg, _ = query_plane_indices(
                folded_q[:b], store.shards[0].bitcount, bucket=64)
        else:
            qarg = folded_q[:b].view(np.int32)
        vals, idx, approx = _search(store, qarg, folded_pops[:b], cutoffs[:b], k_fetch)
        for bq in range(b):
            keep = (vals[bq] > -np.inf) & (idx[bq] >= 0) & (idx[bq] < n)
            if fold > 1:
                got_s, got_i = rescore_candidates_np(
                    idx[bq][keep], full_q[bq], k, n, seed=oseed)
            else:
                got_s, got_i = vals[bq][keep][:k], idx[bq][keep][:k]
            oracle_s, dev_s = scores_of(bq)
            order = _topk_order(oracle_s, k)
            got_s = np.asarray(got_s, np.float32)
            got_i = np.asarray(got_i, np.int64)
            score_errors += int((got_s != oracle_s[got_i]).sum())
            if np.any(np.diff(got_s) > 0):
                order_errors += 1
            if fold == 1:
                want_s = oracle_s[order]
                fold1_mismatches += sum(
                    1 for pos in range(min(len(got_i), k)) if got_s[pos] != want_s[pos]
                )
            recalls.append(len(np.intersect1d(got_i, order)) / max(1, len(order)))
            if int(approx[bq]) != int((dev_s >= cutoffs[bq]).sum()):
                count_mismatches += 1
    out = {
        "oracle": "full",
        "oracle_full_rows": int(n),
        "oracle_full_queries": f"{len(recalls)} (B=1 + B=32), cutoffs 0/0.2/0.3",
        "oracle_score_errors": int(score_errors),
        "oracle_order_errors": int(order_errors),
        "oracle_count_mismatches": int(count_mismatches),
        "oracle_recall_at_k": round(float(np.mean(recalls)), 5),
        "oracle_exact_topk_queries": int(sum(r == 1.0 for r in recalls)),
    }
    if fold == 1:
        out["oracle_fold1_seq_mismatches"] = int(fold1_mismatches)
    return out


def _free_timed_store() -> None:
    """Return the freed timed store's memory to the card before the oracle
    pass or a smaller rung allocates."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _common_fields(mesh, n_rows, batch, k, p50, tmin, first_s, gen_s, floor_ms,
                   mode) -> dict:
    chips = len(mesh.distinct_devices)
    fps_per_chip = n_rows * batch / p50 / chips
    on_card = mesh.devices[0].type == "cuda"
    return {
        "metric": "fingerprints_scanned_per_sec_per_chip",
        "value": round(fps_per_chip, 1),
        "unit": "fp/s/chip",
        "vs_baseline": round(fps_per_chip / REFERENCE_FPS_PER_GPU, 4),
        "p50_latency_ms": round(p50 * 1e3, 3),
        "rows": n_rows,
        "batch": batch,
        "k": k,
        "chips": chips,
        "mode": mode + ("+cuda" if on_card else "+plain"),
        "min_latency_ms": round(tmin * 1e3, 3),
        "dispatch_floor_ms": round(floor_ms, 3),
        # clamped: the floor can exceed a p50 in the same run; a negative
        # on-card estimate is noise, not information
        "onchip_est_ms": round(max(0.0, p50 * 1e3 - floor_ms), 3),
        "compile_plus_first_run_s": round(first_s, 2),
        "library_gen_s": round(gen_s, 2),
        "platform": "cuda" if on_card else "cpu",
        "card": card_line() if on_card else "cpu",
        "host_rescore": "native" if native.available() else "numpy",
    }


def _throughput_pass(measure, extras, n_rows, chips, reps, rows, b) -> None:
    """The batched pass beside the B=1 headline; an out-of-memory at B keeps
    the headline (``batch{B}_fps_per_chip: null``)."""
    try:
        bp50, _, _, bres = measure(b, reps)
    except torch.cuda.OutOfMemoryError:
        _log(f"# batch-{b} pass ran out of device memory; keeping B=1 result")
        extras[f"batch{b}_fps_per_chip"] = None
        return
    extras[f"batch{b}_fps_per_chip"] = round(n_rows * b / bp50 / chips, 1)
    extras[f"batch{b}_p50_ms"] = round(bp50 * 1e3, 3)
    extras[f"batch{b}_self_match"] = f"{_self_matches(bres, rows)}/{b}"


def _run_fold(n_rows: int, fold: int, mesh) -> dict:
    """The folded virtual library: bitplane scan on the card, exact
    full-width host rescore of the candidates (the engine's fold path)."""
    k = _env_int("K", 128)
    batch = _env_int("BATCH", 1)
    repeats = _env_int("REPEATS", 10)
    seed = _env_int("SEED", 11)
    sample_rows = _env_int("VERIFY_ROWS", 2 * 1024 * 1024)
    throughput_batch = _env_int("ALSO_BATCH", 32)
    if _env_str("MODE", "bitplane") != "bitplane":
        raise ValueError("TPUSIM_BENCH_FOLD>1 supports bitplane mode only "
                         "(dense folds: gpusimilarity_tpu_torch.tools.fold_scale)")
    chips = len(mesh.distinct_devices)

    t0 = time.perf_counter()
    store = build_sharded_store(VirtualWords(n_rows, WORDS, seed), mesh,
                                "bitplane", fold)
    _sync(mesh)
    gen_s = time.perf_counter() - t0
    _log(f"# {n_rows:,} virtual rows at fold {fold}: {store.nbytes / 2**30:.2f} "
         f"GiB of planes built in {gen_s:.2f}s")

    n_q = max(batch, throughput_batch if batch == 1 else batch)
    q_rows = pick_query_rows(n_q, n_rows, fold, seed=seed)
    full_q = virtual_rows_np(q_rows, seed=seed)
    folded_q = np.ascontiguousarray(fold_words(full_q, fold))
    plane_idx, bucket = query_plane_indices(
        folded_q, store.shards[0].bitcount, bucket=64)
    folded_pops = popcount_rows_np(folded_q)
    k_fetch = _k_bucket(overfetch_count(k, fold), n_rows)

    def measure(b, reps):
        def run_once():
            vals, idx, _ = _search(store, plane_idx[:b], folded_pops[:b],
                                   np.zeros(b, np.float32), k_fetch)
            return [
                rescore_candidates_np(idx[bq][vals[bq] > -np.inf], full_q[bq],
                                      k, n_rows, seed=seed)
                for bq in range(b)
            ]
        return _measure(run_once, reps)

    floor_ms = _dispatch_floor_ms(mesh.devices[0], repeats)
    p50, tmin, first_s, results = measure(batch, repeats)

    # the oracle sample of each query: random rows plus the query's whole
    # 256-row cluster, where its true top-k lives in clustered data
    rng = np.random.default_rng(seed + 1)
    rand_sample = np.unique(rng.integers(0, n_rows, size=sample_rows))

    def sample_scores(bq):
        c0 = int(q_rows[bq]) & ~255
        sample = np.union1d(rand_sample, np.arange(c0, min(c0 + 256, n_rows)))
        return rescore_candidates_np(sample, full_q[bq], len(sample), n_rows,
                                     seed=seed)

    checked, violations = _inclusion(results, k, sample_scores)
    extras = {
        "fold": fold,
        "k_fetch": k_fetch,
        "plane_bucket": bucket,
        "library_gib": round(n_rows * 128 / 2**30, 1),
        "device_gib": round(store.nbytes / 2**30, 1),
        "exact_self_match": f"{_self_matches(results, q_rows)}/{batch}",
        "oracle_sample_rows": int(len(rand_sample) + 256),
        "oracle_rows_outranking_kth": int(checked),
        "oracle_inclusion_violations": int(violations),
    }
    if batch == 1 and throughput_batch > 1:
        _throughput_pass(measure, extras, n_rows, chips, max(3, repeats // 2),
                         q_rows, throughput_batch)
    payload = _common_fields(mesh, n_rows, batch, k, p50, tmin, first_s, gen_s,
                             floor_ms, f"bitplane+fold{fold}")
    if _env_str("FULL_ORACLE", "1") == "1":
        del store, measure
        _free_timed_store()
        extras.update(_full_oracle_extras("bitplane", fold, k, seed, mesh, n_rows))
    return {**payload, **extras}


def _random_slab(j: int, seed: int, device, planted, queries) -> torch.Tensor:
    """Slab ``j`` of the unfolded library: rows ``[j * S, (j + 1) * S)`` as
    random int32 words ``(S, 32)`` from a generator seeded by ``(seed, j)``
    on ``device``, with each planted query written over its row. The same
    call remakes the same rows, so the oracle needs no host copy."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + j)
    rows = torch.randint(-2**31, 2**31, (_SLAB_ROWS, WORDS), dtype=torch.int32,
                         generator=gen, device=device)
    lo = j * _SLAB_ROWS
    for row, q in zip(planted, queries):
        if lo <= row < lo + _SLAB_ROWS:
            rows[row - lo] = torch.from_numpy(q.view(np.int32)).to(device)
    return rows


def _random_store(n_rows, mesh, mode, seed, planted, queries) -> ShardedStore:
    """The unfolded random library over the mesh's shards, slab by slab:
    each slab made on the mesh's first device and written into the shards
    whose spans it meets (bitplane: as plane words; dense: as columns and
    popcounts)."""
    align = shard_align(mode)
    spans = plan_shard_spans(n_rows, mesh.n_shards, align)
    local = spans[mesh.first_shard:mesh.first_shard + len(mesh.devices)]
    gen_dev = mesh.devices[0]
    shards = []
    for dev, (lo, hi) in zip(mesh.devices, local):
        m = hi - lo
        if mode == "bitplane":
            shard = empty_bitplane_store(m, 32 * WORDS, dev)
        else:
            n_padded = plan_store_layout(m)
            shard = DenseStore(
                words=torch.zeros((WORDS, n_padded), dtype=torch.int32, device=dev),
                popcounts=torch.zeros(n_padded, dtype=torch.int16, device=dev),
                n_valid=m,
            )
        for j in range(lo // _SLAB_ROWS, -(-hi // _SLAB_ROWS)):
            s, e = max(lo, j * _SLAB_ROWS), min(hi, (j + 1) * _SLAB_ROWS)
            slab = _random_slab(j, seed, gen_dev, planted, queries)
            rows = slab[s - j * _SLAB_ROWS:e - j * _SLAB_ROWS].to(dev)
            if mode == "bitplane":
                fill_bitplane_slab(shard, s - lo, rows)
            else:
                shard.words[:, s - lo:e - lo] = rows.T
                shard.popcounts[s - lo:e - lo] = popcount_rows(rows).to(torch.int16)
        shards.append(shard)
    return ShardedStore(
        shards=tuple(shards), row0s=tuple(lo for lo, _ in local), n_valid=n_rows,
        n_shards=mesh.n_shards, per_shard=shard_rows(n_rows, mesh.n_shards, align),
        mesh=mesh,
    )


def _random_rows_np(rows: np.ndarray, seed, device, planted, queries) -> np.ndarray:
    """Host copies ``uint32 (len(rows), 32)`` of sorted library ``rows``,
    each slab remade by :func:`_random_slab`."""
    out = np.empty((len(rows), WORDS), np.uint32)
    slabs = rows // _SLAB_ROWS
    for j in np.unique(slabs):
        at = np.nonzero(slabs == j)[0]
        slab = _random_slab(int(j), seed, device, planted, queries)
        local = torch.from_numpy(rows[at] - int(j) * _SLAB_ROWS).to(device)
        out[at] = slab[local].cpu().numpy().view(np.uint32)
    return out


def _run(n_rows: int, mesh) -> dict:
    """The unfolded random library, bitplane (kernel 1) or dense
    (kernel 2)."""
    k = _env_int("K", 128)
    batch = _env_int("BATCH", 1)
    repeats = _env_int("REPEATS", 10)
    seed = _env_int("SEED", 11)
    sample_rows = _env_int("VERIFY_ROWS", 2 * 1024 * 1024)
    throughput_batch = _env_int("ALSO_BATCH", 32)
    mode = _env_str("MODE", "bitplane")
    if mode not in ("dense", "bitplane"):
        raise ValueError(f"TPUSIM_BENCH_MODE must be dense|bitplane, not {mode!r}")
    qpop = _env_int("QPOP", 50)  # typical Morgan density
    chips = len(mesh.distinct_devices)

    n_q = max(batch, throughput_batch if batch == 1 else batch)
    rng = np.random.default_rng(1)
    if mode == "bitplane":
        bits = np.zeros((n_q, 32 * WORDS), np.uint8)
        for bq in range(n_q):
            bits[bq, rng.choice(32 * WORDS, size=qpop, replace=False)] = 1
        queries = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
        bucket = next(p for p in PLANE_BUCKETS if p >= qpop)
        qarg, _ = query_plane_indices(queries, 32 * WORDS, bucket=bucket)
    else:
        queries = rng.integers(0, 2**32, (n_q, WORDS), dtype=np.uint32)
        bucket = None
        qarg = queries.view(np.int32)
    qpops = popcount_rows_np(queries)
    planted = rng.choice(n_rows, size=n_q, replace=False)

    t0 = time.perf_counter()
    store = _random_store(n_rows, mesh, mode, seed, planted, queries)
    _sync(mesh)
    gen_s = time.perf_counter() - t0
    _log(f"# {n_rows:,} random rows, {mode}: {store.nbytes / 2**30:.2f} GiB built "
         f"in {gen_s:.2f}s")

    def measure(b, reps):
        def run_once():
            vals, idx, _ = _search(store, qarg[:b], qpops[:b],
                                   np.zeros(b, np.float32), k)
            keep = vals > -np.inf
            return [(vals[bq][keep[bq]], idx[bq][keep[bq]]) for bq in range(b)]
        return _measure(run_once, reps)

    floor_ms = _dispatch_floor_ms(mesh.devices[0], repeats)
    p50, tmin, first_s, results = measure(batch, repeats)

    rng_s = np.random.default_rng(seed + 1)
    rand_sample = np.unique(rng_s.integers(0, n_rows, size=sample_rows))
    sample = np.union1d(rand_sample, planted[:batch])
    sample_words = _random_rows_np(sample, seed, mesh.devices[0], planted, queries)
    checked, violations = _inclusion(
        results, k, lambda bq: (scores_np(sample_words, queries[bq][None, :])[0],
                                sample))
    extras = {
        "fold": 1,
        "k_fetch": k,
        "plane_bucket": bucket,
        "library_gib": round(n_rows * 128 / 2**30, 1),
        "device_gib": round(store.nbytes / 2**30, 1),
        "exact_self_match": f"{_self_matches(results, planted)}/{batch}",
        "oracle_sample_rows": int(len(sample)),
        "oracle_rows_outranking_kth": int(checked),
        "oracle_inclusion_violations": int(violations),
    }
    if batch == 1 and throughput_batch > 1:
        _throughput_pass(measure, extras, n_rows, chips, max(3, repeats // 2),
                         planted, throughput_batch)
    payload = _common_fields(mesh, n_rows, batch, k, p50, tmin, first_s, gen_s,
                             floor_ms, mode)
    if _env_str("FULL_ORACLE", "1") == "1":
        del store, measure
        _free_timed_store()
        extras.update(_full_oracle_extras(mode, 1, k, seed, mesh, n_rows))
    return {**payload, **extras}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu_only", action="store_true",
                    help="run the plain versions on the host (tests only)")
    args = ap.parse_args(argv)
    mesh = make_mesh(["cpu"] if args.cpu_only else None)
    fold = _env_int("FOLD", 4)
    rows_env = _env_int("ROWS", FOLDED_ROWS if fold > 1 else UNFOLDED_ROWS)
    ladder = [aligned_virtual_rows(r, mesh.n_shards)
              for r in (FOLDED_LADDER if fold > 1 else UNFOLDED_LADDER)]
    fallbacks = [r for r in ladder if r < rows_env] or [
        aligned_virtual_rows(rows_env * 2 // 3, mesh.n_shards),
        aligned_virtual_rows(rows_env // 2, mesh.n_shards),
    ]
    last_err = None
    for rows in (rows_env, *fallbacks):
        kernels.reset_launches()
        try:
            payload = _run_fold(rows, fold, mesh) if fold > 1 else _run(rows, mesh)
        except torch.cuda.OutOfMemoryError as e:
            # keep only the message: the traceback would pin the run's
            # frames, and with them the store, through the smaller rungs
            last_err = RuntimeError(str(e)[:2000])
            _log(f"# out of device memory at {rows:,} rows; retrying with fewer")
        else:
            payload["kernel_launches"] = kernels.launch_counts()
            print(json.dumps(payload), flush=True)
            return 0
        _free_timed_store()
    raise last_err


if __name__ == "__main__":
    sys.exit(main())
