"""PyTorch port: the probes ``probe_fold_batch``, ``probe_wordsel``,
``probe_phase1`` and the divide check ``verify_exactdiv``, each run as a
module under ``--cpu_only`` (the plain versions; host times) at a tiny
size: their JSON lines and keys, and 0 mismatches over the grid of
``tests/test_exactdiv.py``. Without a card and without ``--cpu_only`` they
raise."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpusimilarity_tpu_torch.ops import bitplane_phase1 as ph1
from gpusimilarity_tpu_torch.parallel import sharded
from gpusimilarity_tpu_torch.tools import probe_wordsel

REPO = Path(__file__).resolve().parent.parent
STAGE_KEYS = {"stage", "rows", "fold", "batch", "k", "k_fetch", "bucket", "ms",
              "floor_ms", "bound_ms", "bound_by", "share", "device", "card"}
SMALL = ("--cpu_only", "--rows", 65536, "--batch", 4, "--k", 16, "--repeats", 1)


def _lines(name, *args) -> list[dict]:
    out = subprocess.run(
        [sys.executable, "-m", f"gpusimilarity_tpu_torch.tools.{name}", *map(str, args)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=300,
        capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


def test_probe_fold_batch_splits_the_search():
    *stages, split = _lines("probe_fold_batch", *SMALL)
    assert [s["stage"] for s in stages] == ["phase1", "bitplane_local_topk",
                                            "search_batch"]
    for s in stages:
        assert set(s) == STAGE_KEYS and s["device"] == "cpu" and s["card"] == "cpu"
        assert s["rows"] == 65536 and s["fold"] == 4 and s["k_fetch"] == 256
        assert s["ms"] > 0 and s["bound_ms"] > 0
    assert split["probe"] == "probe_fold_batch"
    assert split["selection_ms"] == pytest.approx(
        stages[1]["ms"] - stages[0]["ms"], abs=2e-4)
    assert split["kernel_launches"] == {"bitplane_phase1": 0,  # plain versions
                                        "bitplane_rescore": 0}


def test_probe_wordsel_times_each_stage():
    *stages, split = _lines("probe_wordsel", *SMALL)
    assert [s["stage"] for s in stages] == ["s1_select_blocks", "s1_approx_max_k",
                                            "s2_select_words", "s3_rescore_words"]
    absent = stages[1]
    assert absent["absent"] is True and "approx" in absent["reason"]
    timed = [stages[0], *stages[2:]]
    for s in timed:
        assert set(s) == STAGE_KEYS and s["ms"] > 0
    assert timed[0]["bound_ms"] <= timed[1]["bound_ms"] <= timed[2]["bound_ms"]
    assert split["n_blocks"] == 32 and split["k_fetch"] == 256


def test_wordsel_stages_are_the_search():
    """The three stages the probe times, composed, are
    ``bitplane_local_topk`` after its kernel."""
    gen = torch.Generator().manual_seed(3)
    rows = torch.randint(-2**31, 2**31, (5000, 4), dtype=torch.int32, generator=gen)
    rows &= torch.randint(-2**31, 2**31, (5000, 4), dtype=torch.int32, generator=gen)
    store = sharded.build_bitplane_store(rows, device="cpu")
    q = rows[[3, 77, 4000]].numpy().view(np.uint32)
    from gpusimilarity_tpu_torch.ops.bitplane import query_plane_indices
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np

    idx = torch.from_numpy(query_plane_indices(q, store.bitcount)[0])
    qp = torch.from_numpy(popcount_rows_np(q))
    cut = torch.zeros(3)
    vals, ind, _ = sharded.bitplane_local_topk(store, idx, qp, cut, 64)
    bm, _, colmax = ph1.bitplane_phase1_batched(
        store.planes, store.popcounts, idx, qp, cut, torch.ones(2), store.n_valid)
    w = sharded.select_words(colmax, sharded.select_blocks(bm, 64), 64)
    svals, sind = sharded.rescore_words(store, idx, qp, w, 64)
    assert torch.equal(svals, vals) and torch.equal(sind, ind)
    assert probe_wordsel.stage_bytes(3, 3, 64, 50)[2] > probe_wordsel.stage_bytes(
        3, 3, 64, 50)[1]


def test_probe_phase1_sweeps_batch_popcount_and_bucket():
    from gpusimilarity_tpu_torch.tools.probe_phase1 import CONFIGS

    *configs, summary = _lines("probe_phase1", "--cpu_only", "--rows", 4096,
                               "--repeats", 1)
    assert len(configs) == len(CONFIGS)
    for line, (b, qpop, bucket, repeated) in zip(configs, CONFIGS):
        assert (line["batch"], line["qpop"], line["repeated_query"]) == (b, qpop, repeated)
        assert line["bucket"] >= qpop and (bucket is None or line["bucket"] == bucket)
        assert line["ms"] > 0 and line["bound_by"] == "bytes"
    distinct, repeated = configs[3], configs[-1]  # B=128 at 50 planes
    assert repeated["bound_ms"] < distinct["bound_ms"]  # one query's planes, once
    assert summary["configurations"] == len(CONFIGS)


def test_verify_exactdiv_finds_no_mismatch_on_the_host():
    [line] = _lines("verify_exactdiv", "--cpu_only")
    assert line["grid_pairs"] == 2049 * 4096  # tests/test_exactdiv.py's grid
    assert line["mismatches"] == 0 and line["divide_misrounds"] == 0
    assert set(line["predicate_disagreements"]) == {"0.2", "0.3", "0.4", "0.5", "1.0"}
    assert line["result"] == "PASS"


@pytest.mark.parametrize("name", ["probe_fold_batch", "probe_wordsel",
                                  "probe_phase1", "verify_exactdiv"])
def test_probes_raise_without_a_card(name, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"gpusimilarity_tpu_torch.tools.{name}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
