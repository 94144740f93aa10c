"""PyTorch port: the served path over a mesh of several cards, on the CPU.

A mesh of ``cpu:0 .. cpu:S-1`` is S distinct devices, so each shard gets a
worker of its own in ``sharded_local_topk``, as each card does on a machine
with S cards (PyTorch keeps every tensor on the one CPU device). The
registry is built on it and served in-process over HTTP, through the
batcher, as the server's other tests serve it.

Pinned here:

* the served answers of a synthetic bitplane library over 1, 2 and 4
  shards equal the benchmark's plain reference (``benchmark/reference``):
  ids, float32 scores, order and counts, at k 20 and 128 and cutoffs 0 and
  0.3, for queries taken from the two 256-row clusters that meet at each
  shard boundary (a shard's span is whole 2048-row selection blocks, so no
  cluster crosses one);
* the fan-out's spans and counters (``serve/spans.py``): ``/stats`` holds
  ``card_launch_seconds``, ``card_lag_seconds`` and the stage
  ``tpusim.pass.shard_merge``, the stages still add up to the passes, the
  lag is 0 on one card, and with a listener the ring holds one
  ``tpusim.card.launch`` and one ``tpusim.card.wait`` per card and pass, on
  the cards' own worker threads.
"""

import json
import sys
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.parallel import mesh as pmesh
from gpusimilarity_tpu_torch.parallel import sharded
from gpusimilarity_tpu_torch.serve import profiler, spans
from gpusimilarity_tpu_torch.serve.server import SimilarityServer
from gpusimilarity_tpu_torch.utils import synth
from gpusimilarity_tpu_torch.utils.fsim import FingerprintData

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference.rows import rows_np  # noqa: E402
from reference.search import reference_answers  # noqa: E402

N_ROWS = 40_000
SEED = 2_147_483_659  # past 32 bits, as the benchmark's seeds are
WORDS = 32
CLUSTER = 256
PASS_STAGES = (spans.PREPARE, spans.LAUNCH, spans.PASS_WAIT, spans.SHARD_MERGE,
               spans.ASSEMBLE, spans.STRINGS, spans.MERGE, spans.OTHER)


def _library():
    ids = [f"SYN{i:010d}".encode() for i in range(N_ROWS)]
    return FingerprintData(
        dbkey="", bitcount=32 * WORDS,
        fingerprints=synth.VirtualFingerprints(N_ROWS, 32 * WORDS, seed=SEED),
        smiles=ids, ids=ids,
    )


def _boundary_rows():
    """Rows of the clusters on both sides of every boundary of the 2- and
    4-shard layouts: each cluster's first and last row."""
    spans_ = sharded.plan_shard_spans(N_ROWS, 4, sharded.shard_align("bitplane"))
    rows = []
    for _, b in spans_[:-1]:
        rows += [b - CLUSTER, b - 1, b, b + CLUSTER - 1]
    return np.array(rows, np.int64)


def _served(n_shards, **server_kw):
    reg = DatabaseRegistry(mesh=pmesh.make_mesh([f"cpu:{i}" for i in range(n_shards)]))
    reg.add("lib", _library(), scan_mode="bitplane")
    server = SimilarityServer(reg, port=0, **server_kw)
    server.start_background()
    return server


def _search(port, words, k, cutoff):
    body = urllib.parse.urlencode({
        "fp_hex": words.astype("<u4").tobytes().hex(), "return_count": k,
        "similarity_cutoff": cutoff, "similarity": "tanimoto",
        "dbnames": "lib"}).encode()
    with urllib.request.urlopen(
            f"http://localhost:{port}/similarity_search_json", data=body,
            timeout=120) as r:
        return json.loads(r.read())


def _stats(port):
    with urllib.request.urlopen(f"http://localhost:{port}/stats", timeout=60) as r:
        return json.loads(r.read())


def _ask_at_once(port, queries, k, cutoff):
    """Every query at once from threads of their own, so the batcher
    groups them into passes of several."""
    with ThreadPoolExecutor(len(queries)) as pool:
        return list(pool.map(lambda q: _search(port, q, k, cutoff), queries))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_served_path_over_a_cpu_mesh_equals_the_reference(n_shards):
    rows = _boundary_rows()
    queries = rows_np(rows, WORDS, SEED)
    server = _served(n_shards)
    try:
        db = server.service.registry.get("lib")
        assert db.store.n_shards == n_shards
        assert db.store.row0s == tuple(
            lo for lo, _ in sharded.plan_shard_spans(N_ROWS, n_shards,
                                                     sharded.shard_align("bitplane")))
        for k, cutoff in ((20, 0.0), (128, 0.0), (20, 0.3), (128, 0.3)):
            got = _ask_at_once(server.port, queries, k, cutoff)
            want, _ = reference_answers(N_ROWS, WORDS, 1, SEED, rows,
                                        [k] * len(rows), [cutoff] * len(rows), "cpu")
            for payload, ref in zip(got, want):
                ids = [r[0] for r in payload["results"]]
                assert ids == [f"SYN{i:010d}" for i in ref.idx.tolist()]
                assert [r[1] for r in payload["results"]] == ids
                scores = np.array([r[2] for r in payload["results"]], np.float64)
                assert np.array_equal(scores.astype(np.float32), ref.scores)
                assert payload["approximate_count"] == ref.count
            if cutoff > 0:
                assert any(len(p["results"]) < k for p in got)
        stats = _stats(server.port)
        assert stats["databases"]["lib"]["shards"] == n_shards
        assert stats["batches"] < stats["requests"] == 4 * len(rows)
    finally:
        server.close()


@pytest.mark.parametrize("n_shards", [1, 4])
def test_each_card_gives_its_spans_and_the_pass_its_lag(n_shards, tmp_path):
    server = _served(n_shards, window_ms=1.0)
    listener = profiler.ProfilerListener("localhost", 0, tmp_path, cuda=False)
    try:
        since = spans.TRACE.last_seq()
        queries = rows_np(_boundary_rows(), WORDS, SEED)
        for _ in range(3):
            _ask_at_once(server.port, queries, 20, 0.0)
        stats = _stats(server.port)
        records = spans.TRACE.records(since)
    finally:
        listener.close()
        server.close()
    stages = stats["stages"]
    assert sum(stages[s] for s in PASS_STAGES) == pytest.approx(
        stats["total_search_seconds"], rel=0.01)
    assert stages[spans.SHARD_MERGE] > 0
    assert stats["card_launch_seconds"] > 0
    if n_shards == 1:
        assert stats["card_lag_seconds"] == 0
    else:
        assert stats["card_lag_seconds"] >= 0
    # one launch and one wait a card and pass; a pass's card spans lie
    # inside it, each card's pair on one thread, the cards' on their own
    passes = {r[6]: r for r in records if r[1] == spans.LAUNCH}
    assert len(passes) == stats["batches"]
    for name in spans.CARD_SPANS:
        mine = [r for r in records if r[1] == name]
        assert len(mine) == n_shards * stats["batches"]
        by_pass = {}
        for r in mine:
            by_pass.setdefault(r[6], []).append(r)
        for pass_id, cards in by_pass.items():
            assert len({r[4] for r in cards}) == n_shards
            launch = passes[pass_id]
            assert launch[2] <= min(r[2] for r in cards)
    launches = {(r[6], r[4]): r for r in records if r[1] == spans.CARD_LAUNCH}
    for r in records:
        if r[1] == spans.CARD_WAIT:
            assert launches[(r[6], r[4])][3] == r[2]
    assert stats["card_launch_seconds"] == pytest.approx(
        sum(r[3] - r[2] for r in launches.values()) / 1e9, abs=1e-5)
