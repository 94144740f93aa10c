"""PyTorch port: the bench's oracles (``utils/synth.{virtual_full_topk,
virtual_matrix, rescore_candidates_np}``) and ``FingerprintDB.
get_fingerprint`` against the JAX package's on the same inputs, bit for bit,
and the port's bench (``python -m gpusimilarity_tpu_torch.tools.bench``)
run on the CPU at a small size."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpusimilarity_tpu.models.fingerprint_db import FingerprintDB as JaxFingerprintDB
from gpusimilarity_tpu.utils import native as jax_native
from gpusimilarity_tpu.utils import synth as jax_synth
from gpusimilarity_tpu.utils.fsim import FingerprintData as JaxFingerprintData
from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB
from gpusimilarity_tpu_torch.utils import native, synth
from gpusimilarity_tpu_torch.utils.fsim import FingerprintData

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every field the root bench.py prints (its payload, extras and oracle)
JAX_BENCH_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "p50_latency_ms", "rows", "batch",
    "k", "chips", "mode", "min_latency_ms", "dispatch_floor_ms", "onchip_est_ms",
    "compile_plus_first_run_s", "library_gen_s", "platform", "fold", "k_fetch",
    "plane_bucket", "library_gib", "device_gib", "exact_self_match",
    "oracle_sample_rows", "oracle_rows_outranking_kth",
    "oracle_inclusion_violations", "batch32_fps_per_chip", "batch32_p50_ms",
    "batch32_self_match", "oracle", "oracle_full_rows", "oracle_full_queries",
    "oracle_score_errors", "oracle_order_errors", "oracle_count_mismatches",
    "oracle_recall_at_k", "oracle_exact_topk_queries",
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread here and in the bench's subprocesses: the suite runs
    several workers at once, and torch's default of a thread per core,
    oversubscribed, slows these small host runs by 10x or more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """Both packages with their native library (where it is built) and
    without it (their numpy paths)."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    return request.param


@pytest.mark.parametrize(
    "n,k,row_chunk",
    [(5000, 20, 512), (70_001, 128, 8192), (100, 128, 512)],
    ids=["chunks_off_boundary", "k128_many_chunks", "k_past_the_rows"],
)
def test_virtual_full_topk_matches_jax(n, k, row_chunk):
    """Scores, indices (lowest index among ties, across chunks) and counts
    equal the JAX oracle's; a repeated query row makes two identical
    queries, and each query's list holds tied scores."""
    q_rows = np.array([10, 10, min(2600, n - 1)])
    queries = jax_synth.virtual_rows_np(q_rows, seed=3)
    want = jax_synth.virtual_full_topk(n, queries, k, seed=3, row_chunk=row_chunk,
                                       cutoffs=(0.0, 0.3))
    got = synth.virtual_full_topk(n, queries, k, seed=3, row_chunk=row_chunk,
                                  cutoffs=(0.0, 0.3), device="cpu")
    for g, w, dtype in zip(got, want, (np.float32, np.int64, np.int64)):
        assert g.dtype == dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    finite = [v[np.isfinite(v)] for v in want[0]]
    assert all(len(np.unique(v)) < len(v) for v in finite)  # ties decided
    assert (got[2][:, 0] == n).all()  # every row scores >= 0


@pytest.mark.parametrize(
    "similarity,alpha,beta",
    [("tanimoto", 1.0, 1.0), ("tversky", 0.3, 0.7)], ids=["tanimoto", "tversky"],
)
def test_rescore_candidates_np_matches_jax(similarity, alpha, beta, host_path):
    n = 1_020_017_472
    rng = np.random.default_rng(8)
    query = jax_synth.virtual_rows_np(np.array([123_456_789]), seed=11)[0]
    cand = np.concatenate([
        rng.integers(0, n, 3000), 123_456_789 + np.arange(-300, 300), [-1, n, n + 5],
    ])
    rng.shuffle(cand)
    for k in (128, 5000):
        got = synth.rescore_candidates_np(cand, query, k, n, seed=11,
                                          similarity=similarity, alpha=alpha,
                                          beta=beta)
        want = jax_synth.rescore_candidates_np(cand, query, k, n, seed=11,
                                               similarity=similarity,
                                               alpha=alpha, beta=beta)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got[1][0] == 123_456_789 and got[0][0] == 1.0


def test_virtual_matrix_matches_jax(host_path, monkeypatch):
    monkeypatch.setattr(synth, "_GEN_ROWS", 1024)  # several numpy slabs
    got = synth.virtual_matrix(5000, seed=4)
    assert got.dtype == np.uint32 and got.shape == (5000, 32)
    np.testing.assert_array_equal(got, jax_synth.virtual_matrix(5000, seed=4))
    np.testing.assert_array_equal(
        synth.virtual_matrix(300, word_count=64, seed=2),
        jax_synth.virtual_matrix(300, word_count=64, seed=2),
    )


def _both_data(n=300, seed=5):
    rng = np.random.default_rng(seed)
    fps = np.packbits(rng.random((n, 1024)) < 0.1, axis=1, bitorder="little")
    ids = [f"id{i}".encode() for i in range(n)]
    return (FingerprintData(fingerprints=fps, smiles=ids, ids=ids),
            JaxFingerprintData(fingerprints=fps, smiles=ids, ids=ids))


@pytest.mark.parametrize("fold", [1, 2])
def test_get_fingerprint_matches_jax(fold):
    data, jdata = _both_data()
    db = FingerprintDB(data, device="cpu", fold_factor=fold)
    jdb = JaxFingerprintDB(jdata, fold_factor=fold)
    for i in (0, 17, 299, -1):
        got = db.get_fingerprint(i)
        assert got.dtype == np.uint32 and got.shape == (32,)
        np.testing.assert_array_equal(got, jdb.get_fingerprint(i))


def test_get_fingerprint_without_the_host_matrix_raises_as_jax():
    data, jdata = _both_data()
    db = FingerprintDB(data, device="cpu", keep_full_on_host=False)
    jdb = JaxFingerprintDB(jdata, keep_full_on_host=False)
    with pytest.raises(ValueError) as got:
        db.get_fingerprint(3)
    with pytest.raises(ValueError) as want:
        jdb.get_fingerprint(3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        FingerprintDB(data, device="cpu", fold_factor=2, keep_full_on_host=False)
    with pytest.raises(ValueError) as want:
        JaxFingerprintDB(jdata, fold_factor=2, keep_full_on_host=False)
    assert str(got.value) == str(want.value)


def _bench(env_extra, *args, timeout=300):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUSIM_BENCH_")}
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.tools.bench", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize(
    "fold,mode", [("4", "bitplane"), ("1", "bitplane"), ("1", "dense")],
    ids=["fold4", "fold1_bitplane", "fold1_dense"],
)
def test_bench_cpu_only_prints_one_exact_line(fold, mode):
    out = _bench({"TPUSIM_BENCH_ROWS": "65536", "TPUSIM_BENCH_FOLD": fold,
                  "TPUSIM_BENCH_MODE": mode, "TPUSIM_BENCH_REPEATS": "3"},
                 "--cpu_only")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    p = json.loads(lines[0])
    missing = [f for f in JAX_BENCH_FIELDS if f not in p]
    assert not missing, missing
    assert p["rows"] == 65536 and p["fold"] == int(fold) and p["chips"] == 1
    assert p["platform"] == "cpu" and p["card"] == "cpu"
    assert p["host_rescore"] == ("native" if native.available() else "numpy")
    assert p["mode"] == (f"bitplane+fold{fold}" if fold != "1" else mode) + "+plain"
    assert p["exact_self_match"] == "1/1" and p["batch32_self_match"] == "32/32"
    for field in ("oracle_inclusion_violations", "oracle_score_errors",
                  "oracle_order_errors", "oracle_count_mismatches"):
        assert p[field] == 0, field
    assert p["oracle_rows_outranking_kth"] > 0
    assert p["oracle_full_rows"] == 65536
    if fold == "1":
        assert p["oracle_exact_topk_queries"] == 33
        assert p["oracle_fold1_seq_mismatches"] == 0
    # the plain versions are not kernels: nothing counts as a launch
    assert p["kernel_launches"] == {"bitplane_phase1": 0, "bitplane_rescore": 0,
                                    "dense_phase1": 0}


def test_bench_dense_fold_raises_as_the_root_bench():
    out = _bench({"TPUSIM_BENCH_ROWS": "4096", "TPUSIM_BENCH_MODE": "dense"},
                 "--cpu_only")
    assert out.returncode != 0 and out.stdout == ""
    assert "bitplane mode only" in out.stderr


def test_bench_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _bench({"TPUSIM_BENCH_ROWS": "4096"})
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device available" in out.stderr
