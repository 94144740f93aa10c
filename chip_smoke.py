"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and no
JAX needed. Phases, in order; any failure raises and the run exits non-zero:

(a) build the three phase-1 kernels from ``gpusimilarity_tpu_torch/csrc``,
    one nvcc per source, started together, and beside them the native host
    runtime from ``native/`` (``utils/native.py``: built at first use where
    no hand-built library loads, as in a ``git archive``), which must load;
    it prints where the library came from;
(b) hold the bitplane kernel against its plain PyTorch version, bit for
    bit, on a synthetic library of 113,335,291 rows x 1024 bits (the size
    of Enamine REAL in the reference's presentation) made on the card from
    a seed, at B 1, 32 and 128 (the batches the probe of (m) times it at),
    where its code forks: cutoffs 0, 0.35, 1.0 and a negative one mixed in
    one launch, Tversky, plane buckets 64 and 256 (8- and 16-bit count
    fields), a query with no set bits;
(c) the engine's bitplane search (k 20 and 128, batches of 1 and 32) at
    that size against a plain dense full scan over the packed rows;
(p) where one search's time goes at that size (B 1 and 32, k 128): wall
    time from CUDA events without the profiler, the device's busy time and
    its top ops from torch.profiler, and the idle share;
(m) the matrix-product kernel (kernel 3) on an unfolded dense store of the
    same rows: bit for bit against its plain version and against the dense
    kernel on the same store, B 1, 32, 64, 100 and 128, Tanimoto cutoffs 0
    and 0.35 mixed in one launch and one Tversky launch, then block 64 with
    ``n_valid`` off a block boundary and a shard offset; its times beside
    the dense kernel's at B 1, 32, 64 and 128, its bound and the
    ``torch._int_mm`` yardstick; the dense kernel against its plain version
    on stores of 4 and 16 words a row (fold 8 and 2) of the first rows; then
    the probe (``gpusimilarity_tpu_torch.tools.probe_mxu``) at its default
    rows, which times kernels 3, 2 and 1 at B 1, 32, 64 and 128;
(d) the HTTP server (``python -m gpusimilarity_tpu_torch.cli.server``) on a
    1,618,358-row ``.fsim`` (the ChEMBL size of the same slide), answering
    fp_hex self-queries (two of them concurrent, one Tversky), a SMILES
    query and a wrong-key query, checked against the plain full scan;
(e) the folded dense library at full size: a synthetic ``.tfsim`` of
    1,020,017,472 rows (Enamine 18/12, the reference's folded
    configuration) loaded through ``DatabaseRegistry.from_fsim_files`` with
    no fold or mode given, which must resolve to fold 4, dense; engine
    searches (B 1 and 32, k 20 and 128) checked for the self row first at
    1.0, full-width scores, (-score, index) order, the plain folded count,
    and candidates equal to a plain folded full scan's; recall@20 against
    the full-width top 20 (printed, not required); one popless search;
(b2) the dense kernel against its plain version, bit for bit, in (e)'s
    store: B 1, 5, 32 and 48 with cutoffs 0, 0.35, 1.0 and a negative one mixed in one
    launch, Tversky, popless, ``n_valid`` off a block boundary (the plain
    side on a column prefix where the full width would take minutes);
(p2) the breakdown of (p) for a dense fold-4 search;
(f) the server with ``--fold 4`` (auto resolves dense) on (d)'s library,
    checked by (e)'s rules, over HTTP and over the reference's socket
    protocol (``--socket_name``);
(g) one bitplane search at fold 4 on 113,335,291 virtual rows, checked by
    (e)'s rules;
(h) the port's own entry points: a gzip ``.smi`` of 100,000 SMILES made by
    string assembly from a seed, plus one bad line, through ``cli.createdb``
    to ``.fsim`` and streamed to ``.tfsim``, ``cli.convertdb`` and
    ``cli.mergedb``, the files checked (bad line dropped, rows, fingerprints
    of a sample against ``smiles_to_fingerprint_bin``, both ``.tfsim`` equal,
    twice the rows merged); then ``cli.server --socket_name
    --http_interface`` on the built library, its merged twin and (d)'s
    library: fingerprint self-queries over the socket, with a client
    encoder written here, to one library and to several (checked against
    the plain full scan and the reference's merge of the plain scans,
    exactly), a wrong key, a corrupt record that must drop the connection;
    the HTML UI, ``cli.search`` and the FDW; the socket round trip p50 and
    the page time.
(w) after (h), a server's start-up up to its first answers: ``cli.server``
    on (d)'s library, bitplane and ``--fold 4`` dense, each started with
    ``--no_warmup`` and then with its default warm-up: seconds to ready and
    of the warm-up, the first B=1 k=20 HTTP round trip, the median of the
    next 20 and the first burst of 8 concurrent requests (and the median of
    the next 5 bursts); every answer
    exact by (d)'s rules, the warmed server's kernel launched before ready
    and the other's not, SIGINT exiting 0.
(x) after (w), the live profiling hook and the overlapped start-up:
    ``cli.server --no_warmup --profiler_port`` on (d)'s library, fold 4
    dense started from a fresh copy of the package (no build directory:
    its kernels build while the library loads, and the load's log line
    must come before ``dense_phase1 kernel ready``; build, load and ready
    seconds printed) and bitplane from the checkout: a 3,000 ms capture
    opened after ``ready`` holds the first B=1 k=20 request, 20 more and a
    burst of 8, every answer exact by (d)'s rules; the trace must hold one
    ``tpusim.search.smoke`` span per batch ``/stats`` counted, none on the
    listener's thread, and one ``dense_phase1_mma_kernel`` or
    ``bitplane_phase1_kernel`` event per launch; a second capture gets
    409; the first request's span and the median of the next 20 split into
    wall, device busy, top 5 host ops by self time and top 5 device ops. A
    SIGINT cutting a capture exits 0 and leaves the trace; a server without
    the flag listens on one port; ``tools.loadtest --profile_ms 2000`` (32
    clients) gives the device's busy share, the search spans' p50 and the
    share of request time outside any search span.

(s) the sharded paths, in three places: after (p), the 113,335,291-row
    bitplane library cut into 4 shards on the card, its answers (B 1 and 32,
    k 128) equal to the unsharded store's and one launch per shard; after
    (p2), the fold-4 library's answers taken, its store freed, and the
    library loaded again over 2 shards (it must resolve fold 4, dense) with
    answers equal to the unsharded ones; after (g), (d)'s library served in
    process over 4 bitplane and 2 fold-4 dense shards (answers by (d)'s
    rules, ``/stats`` counting one launch per shard per request),
    ``tools/dryrun_multichip`` over 4 shards, then ``cli.server`` as one
    process and as two processes sharing the card (``--coordinator``):
    answers by (d)'s rules over HTTP and the socket, each process fed its
    half, both exiting cleanly. It times each sharded search beside one
    shard and each server's B=1 round trip over HTTP and the socket.
(t) the measurement entry points, each run as a user runs it, a subprocess
    of ``python -m gpusimilarity_tpu_torch.tools.<name>`` whose JSON line is
    checked: (t1) the bench at its defaults, fold 4 on 1,020,017,472 virtual
    rows (never cut); (t2) the bench unfolded on 113,335,291 rows, bitplane
    then dense; both with every oracle error field 0 and full self-matches,
    at fold 1 every full-oracle query's whole top-k exact; (t3)
    ``fold_accuracy`` at 50,000 rows on the card and on the host, equal but
    ``wall_s``, then at its default 1,000,000 rows; (t4) ``fold_scale``'s
    synthetic library of 16,777,216 rows at fold 4, dense and bitplane,
    every query exact; (t5) ``loadtest`` in full and ``loadtest104`` on
    (t4)'s library (cut from 104,000,000 rows), every request answered and
    exact; (t6) ``flagship_server_bench`` on a synthetic ``.tfsim`` of
    113,335,291 rows (cut from 1,020,017,472: its ids are stored) at fold
    4, every answer exact.
(u) the port's last tools, run the same way: (u1) ``northstar`` at fold 4
    on 113,335,291 rows (cut from 1,024,000,000: it writes 45 bytes of
    string blobs a row, 4.8 GiB here), 12/12 exact, recall against its
    full-width oracle printed, the server's page-prewarm line seen; (u2)
    ``chem_scale`` on 200,000 compounds (cut from 5,000,000 to keep the
    smoke inside its time), 8/8 self-matches; (u3) ``probe_fold_batch`` and
    ``probe_wordsel`` and (u4) ``probe_phase1`` at their defaults (352Mi
    rows fold 4; 100,663,296 rows), every time at or above its bound;
    (u5) ``verify_exactdiv``, 0 mismatches.

The main path of each kernel is driven with its launch counter reset just
before and read just after: the bitplane kernel in (c), (d), (g), (h), (s),
(w), (x), (t) and (u), the dense kernel in (e), (f), (s), (w), (x), (t) and
(u) (the servers' counts come from ``/stats``, read after ``ready`` and after
the checked requests, so their warm-up counts nowhere; the two-process
server's from process 0's; (x)'s over each capture's window, where the trace
must show the same number of kernel events;
(t)'s bench and (u)'s tools, and (x)'s load test, report their own run's
counts),
the matrix-product kernel in the probe of (m), which is the one entry point
that runs it. (s) reads its counts around each sharded search and server
it checks. Launches made in (b), (b2), (p), (p2) and (m) before the probe,
and in (s)'s unsharded references, timing loops and dry run, to compare or
profile, do not count. It prints the card's name and power limit, one JSON line describing
the kernels, the seconds of each phase, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gzip
import json
import os
import re
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import torch

from gpusimilarity_tpu_torch.serve import profiler
from gpusimilarity_tpu_torch.tools.probe_mxu import time_ms as median_ms
from gpusimilarity_tpu_torch.tools.probe_mxu import timed

ROOT = Path(__file__).resolve().parent
LIB_ROWS = 113_335_291
SERVER_ROWS = 1_618_358
FOLDED_ROWS = 1_020_017_472  # Enamine 18/12 (BASELINE.md, slide 13)
SEED = 2026
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "bitplane_phase1": ("gpusimilarity_tpu_torch/csrc/bitplane_phase1.cu",
                        "gpusimilarity_tpu/ops/pallas_bitplane.py:53"),
    "dense_phase1": ("gpusimilarity_tpu_torch/csrc/dense_phase1.cu",
                     "gpusimilarity_tpu/ops/pallas_scan.py:34"),
    "mxu_phase1": ("gpusimilarity_tpu_torch/csrc/mxu_phase1.cu",
                   "gpusimilarity_tpu/ops/pallas_mxu.py:40"),
}
REFERENCE_FOLD4_MS = 451.72  # 4x V100, 1.02B rows fold 4 (BASELINE.md)
PLAIN_PREFIX_COLS = 1 << 27  # (b2): B=32 plain comparisons past the first
PLAIN_PREFIX_MXU = 1 << 25  # (m): plain comparisons other than B=1 and B=32
PLAIN_PREFIX_FORKS = 1 << 25  # (b2): the cases added where the kernel forks
FOLD_CHECK_ROWS = 4_000_000  # (m): rows of the fold-8 and fold-2 stores
SOCKET_NAME = "gpusim-smoke"  # (f), (h): in a temporary directory of the run

PHASE_SECONDS: dict[str, float] = {}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.monotonic()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.monotonic() - t0


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def random_rows(n: int, gen: torch.Generator, device, chunk: int = 1 << 20):
    """Packed rows ``int32 (n, 32)`` with Morgan-like density: each row
    draws its own bit probability so that it sets about 30-60 of 1024 bits."""
    out = torch.empty((n, 32), dtype=torch.int32, device=device)
    weights = torch.ones(8, dtype=torch.uint8, device=device) << torch.arange(
        8, dtype=torch.uint8, device=device
    )
    for lo in range(0, n, chunk):
        c = min(n, lo + chunk) - lo
        p = torch.empty((c, 1), device=device).uniform_(
            30 / 1024, 60 / 1024, generator=gen
        )
        bits = torch.rand((c, 1024), generator=gen, device=device) < p
        packed = (bits.view(c, 128, 8).to(torch.uint8) * weights).sum(
            dim=-1, dtype=torch.uint8
        )
        out[lo:lo + c] = packed.view(torch.int32)
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pick_queries(rows, pops, n_valid, count, max_bits, seed):
    """``count`` library row indices whose popcount is <= ``max_bits``."""
    rng = np.random.default_rng(seed)
    cand = torch.from_numpy(rng.integers(0, n_valid, 16 * count)).to(rows.device)
    ok = cand[(pops[cand] <= max_bits) & (pops[cand] > 0)]
    check(ok.numel() >= count, "not enough sparse query rows")
    return ok[:count]


def perturb(q: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = q.copy()
    for row in q:
        for _ in range(3):
            w, b = rng.integers(0, 32), rng.integers(0, 32)
            row[w] ^= np.uint32(1 << int(b))
    return q


# ------------------------------------------------------------------ phases


def phase_build():
    """(a) the three kernels, one nvcc each, and beside them the native host
    runtime, which must load: built at first use from ``native/`` in a
    checkout that has no hand-built library (a ``git archive`` has none)."""
    from gpusimilarity_tpu_torch.utils import kernels, native

    t0 = time.monotonic()
    host_runtime = threading.Thread(target=native.available)
    host_runtime.start()
    builds = kernels.load_all()
    for name, build in builds.items():
        log(f"[a] built {build.path.name} in {build.seconds:.2f}s")
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[a] ptxas {name}: {line.strip()}")
    host_runtime.join()
    log(f"[a] native host runtime: {native.origin()}")
    check(native.available(), f"[a] no native host runtime: {native.origin()}")
    log(f"[a] {len(builds)} kernels and the host runtime loaded in "
        f"{time.monotonic() - t0:.2f}s")
    return builds


def phase_library(n_rows, device):
    from gpusimilarity_tpu_torch.parallel.sharded import build_bitplane_store

    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.monotonic()
    rows = random_rows(n_rows, gen, device)
    sync(device)
    t1 = time.monotonic()
    store = build_bitplane_store(rows)
    sync(device)
    t2 = time.monotonic()
    pops = store.popcounts[:n_rows]
    log(f"[b] library {n_rows:,} rows x 1024 bits: generated in "
        f"{t1 - t0:.2f}s, transposed to {store.planes.shape[0]} planes x "
        f"{store.planes.shape[1]:,} words in {t2 - t1:.2f}s; mean bits/row "
        f"{pops.float().mean().item():.2f}")
    return rows, store


def phase_kernel_vs_plain(rows, store, device, reps=20):
    """Kernel against plain version, bit for bit, for cutoffs at, above and
    below 0 and at 1.0 in one launch, Tversky, plane buckets 64 and 256 (8-
    and 16-bit count fields), B 1, 32 and 128 (the probe's batches) and a
    zero query. Times at bucket 64: the kernel's median, the plain
    version's one checked run."""
    from gpusimilarity_tpu_torch.ops.bitplane import query_plane_indices
    from gpusimilarity_tpu_torch.ops.bitplane_phase1 import (
        bitplane_phase1_batched,
        bitplane_phase1_kernel,
        bitplane_phase1_plain,
    )
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.tools.probe_mxu import bitplane_bound

    n = store.n_valid
    pops = store.popcounts[:n]
    idx = pick_queries(rows, pops, n, 127, 64, SEED)
    lib_q = rows[idx].cpu().numpy().view(np.uint32)
    zero = np.zeros((1, 32), np.uint32)
    q128 = np.concatenate([lib_q, zero])  # + a zero query
    q32 = np.concatenate([lib_q[:31], zero])
    q1 = q32[:1]
    mixed = np.where(np.arange(128) % 2 == 0, 0.0, 0.35).astype(np.float32)
    mixed4 = np.tile(np.float32([0.0, 0.35, 1.0, -0.5]), 8)
    cases = [
        ("B32 b64 tanimoto cut0/0.35/1/-0.5", q32, mixed4, "tanimoto", (1, 1), 64),
        ("B1 b64 tanimoto cut0", q1, [0.0], "tanimoto", (1, 1), 64),
        ("B1 b64 tanimoto cut0.35", q1, [0.35], "tanimoto", (1, 1), 64),
        ("B1 b64 tversky cut0.35", q1, [0.35], "tversky", (0.7, 0.3), 64),
        ("B32 b64 tanimoto cut0", q32, [0.0] * 32, "tanimoto", (1, 1), 64),
        ("B32 b64 tanimoto cut0/0.35", q32, mixed[:32], "tanimoto", (1, 1), 64),
        ("B128 b64 tanimoto cut0/0.35", q128, mixed, "tanimoto", (1, 1), 64),
        ("B32 b64 tversky cut0.35", q32, [0.35] * 32, "tversky", (0.7, 0.3), 64),
        ("B1 b256 tanimoto cut0.35", q1, [0.35], "tanimoto", (1, 1), 256),
        ("B32 b256 tanimoto cut0", q32, [0.0] * 32, "tanimoto", (1, 1), 256),
    ]
    max_err = 0.0
    timing = {}
    for name, q, cut, sim, ab, bucket in cases:
        plane_idx, p = query_plane_indices(q, store.bitcount, bucket)
        check(p == bucket, f"{name}: bucket {p} != {bucket}")
        args = (
            store.planes, store.popcounts,
            torch.from_numpy(plane_idx).to(device),
            torch.from_numpy(popcount_rows_np(q)).to(device),
            torch.tensor(cut, dtype=torch.float32, device=device),
            torch.tensor(ab, dtype=torch.float32, device=device),
        )
        _bm, cnt, colmax = bitplane_phase1_batched(*args, n, sim)
        (pcolmax, pcnt), p_ms = timed(lambda: bitplane_phase1_plain(*args, n, sim), device)
        same = torch.equal(colmax.view(torch.int32), pcolmax.view(torch.int32))
        finite = torch.isfinite(colmax) & torch.isfinite(pcolmax)
        err = (colmax[finite] - pcolmax[finite]).abs().max().item()
        max_err = max(max_err, err)
        check(torch.isneginf(colmax).eq(torch.isneginf(pcolmax)).all().item(),
              f"{name}: -inf pattern differs")
        check(same, f"{name}: colmax not bit-identical (max abs err {err})")
        check(torch.equal(cnt, pcnt), f"{name}: counts differ")
        if sim == "tanimoto":
            for i in np.flatnonzero(np.asarray(cut) <= 0.0):
                check(int(cnt[i]) == n, f"{name}: cutoff<=0 count {int(cnt[i])} != {n}")
        if len(q) > 1:
            check(colmax[-1].max().item() == 0.0, f"{name}: zero query not 0")
        log(f"[b] {name}: colmax and counts bit-identical "
            f"(counts[0]={int(cnt[0])}, max abs err {err})")
        if bucket == 64 and sim == "tanimoto" and name.endswith("0.35"):
            b = len(q)
            k_ms = median_ms(lambda: bitplane_phase1_kernel(*args, n, sim), device, reps)
            w_ms = median_ms(lambda: bitplane_phase1_batched(*args, n, sim), device, reps)
            timing[b] = (k_ms, p_ms, bitplane_bound(plane_idx, store.planes.shape[1], b))
            log(f"[b] B={b} bucket 64 at {n:,} rows: kernel median "
                f"{k_ms:.3f} ms (one launch and its zeroed counts), wrapper "
                f"median {w_ms:.3f} ms (kernel, allocation and block max), "
                f"plain {p_ms:.3f} ms (one run)")
    return max_err, timing


def phase_engine(rows, store, device, reps=5):
    """The engine's search at full size against the plain full scan."""
    from gpusimilarity_tpu_torch.ops.bitplane import query_plane_indices
    from gpusimilarity_tpu_torch.ops.scan import (
        full_scan_topk,
        popcount_rows,
        popcount_rows_np,
        similarity_from_counts,
    )
    from gpusimilarity_tpu_torch.parallel.sharded import bitplane_local_topk

    n = store.n_valid
    pops = store.popcounts[:n]
    idx = pick_queries(rows, pops, n, 24, 1024, SEED + 1)
    lib_q = rows[idx].cpu().numpy().view(np.uint32)
    q32 = np.concatenate([lib_q, perturb(lib_q[:8], SEED)])
    cut32 = np.tile(np.float32([0.0, 0.3, 0.5, 0.2]), 8)
    oracle_v, oracle_i, oracle_c = full_scan_topk(
        rows, pops, torch.from_numpy(q32.view(np.int32)).to(device), 128,
        torch.from_numpy(cut32).to(device),
    )
    latency = {}
    for b, k in ((1, 20), (1, 128), (32, 20), (32, 128)):
        q, cut = q32[:b], cut32[:b]
        plane_idx, bucket = query_plane_indices(q, store.bitcount)
        qt = torch.from_numpy(q.view(np.int32)).to(device)
        args = (
            store, torch.from_numpy(plane_idx).to(device),
            torch.from_numpy(popcount_rows_np(q)).to(device),
            torch.from_numpy(cut).to(device), k,
        )
        vals, gi, cnt = bitplane_local_topk(*args)
        sync(device)
        check(torch.equal(vals, oracle_v[:b, :k]),
              f"B={b} k={k}: top-k scores differ from the full scan")
        check(torch.equal(cnt, oracle_c[:b]), f"B={b} k={k}: counts differ")
        common = popcount_rows(rows[gi] & qt[:, None, :])
        rescored = similarity_from_counts(common, pops[gi], popcount_rows(qt))
        check(torch.equal(rescored, vals),
              f"B={b} k={k}: returned indices do not carry their scores")
        check(vals[0, 0].item() == 1.0, f"B={b} k={k}: self-query not 1.0")
        latency[(b, k)] = median_ms(lambda: bitplane_local_topk(*args), device, reps)
        log(f"[c] engine B={b} k={k} bucket {bucket}: exact against the full "
            f"scan (count[0]={int(cnt[0])}); median latency "
            f"{latency[(b, k)]:.3f} ms")
    return latency


def _profile_search(tag, label, fn, device, reps):
    """Wall time of ``fn`` (CUDA events, no profiler), then its device busy
    time and top ops from torch.profiler over ``reps`` more calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    wall = median_ms(fn, device, reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync(device)
    ops = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: -e.self_device_time_total,
    )
    if not ops:
        log(f"[{tag}] {label}: wall {wall:.3f} ms per search; the profiler saw "
            "no device ops, busy time not measured")
        return
    busy = sum(e.self_device_time_total for e in ops) / reps / 1e3
    log(f"[{tag}] {label}: wall {wall:.3f} ms per search (median, CUDA events, "
        f"no profiler); device busy {busy:.3f} ms per search (profiler, {reps} "
        f"searches); idle share {1 - busy / wall:.3f}")
    for e in ops[:8]:
        log(f"[{tag}]   {e.self_device_time_total / reps / 1e3:.3f} ms "
            f"x{e.count / reps:g}  {e.key[:90]}")


def phase_profile(rows, store, device, reps=10):
    """Where a bitplane search's time goes, by device op."""
    from gpusimilarity_tpu_torch.ops.bitplane import query_plane_indices
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.parallel.sharded import bitplane_local_topk

    n = store.n_valid
    idx = pick_queries(rows, store.popcounts[:n], n, 32, 64, SEED + 5)
    q32 = rows[idx].cpu().numpy().view(np.uint32)
    for b in (1, 32):
        q = q32[:b]
        plane_idx, bucket = query_plane_indices(q, store.bitcount)
        args = (
            store, torch.from_numpy(plane_idx).to(device),
            torch.from_numpy(popcount_rows_np(q)).to(device),
            torch.zeros(b, dtype=torch.float32, device=device), 128,
        )
        _profile_search("p", f"B={b} k=128 bucket {bucket}",
                        lambda: bitplane_local_topk(*args), device, reps)


def phase_mxu_vs_plain(rows, store, device, reps=10):
    """(m) Kernel 3 against its plain version and against kernel 2 on one
    unfolded dense store, bit for bit: B 1, 32, 64, 100 (no multiple of 16)
    and 128, Tanimoto cutoffs 0 and 0.35 mixed in one launch and a Tversky
    0.7/0.3 launch, a zero query in every batch over 1. Against kernel 2 at
    full size; against the plain version at full size for B=1 and B=32
    Tanimoto, else on the first PLAIN_PREFIX_MXU columns (a prefix of the
    store: its row stride stays the store's). Then where the kernel forks, on
    that prefix: selection block 64, ``n_valid`` 77 columns off a block
    boundary and a shard offset, at B 100 and 128. Times at full size: kernel
    3 and kernel 2 alone at B 1, 32, 64 and 128, the plain version at B 1 and
    32, and ``torch._int_mm`` on the unpacked bits at B=32 (the product
    alone)."""
    from gpusimilarity_tpu_torch.ops import dense_phase1 as ph2
    from gpusimilarity_tpu_torch.ops import mxu_phase1 as ph3
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.tools.probe_mxu import mxu_bound

    n, n_cols = store.n_valid, store.n_padded
    lib_q = rows[pick_queries(rows, store.popcounts[:n], n, 127, 1024, SEED + 11)]
    q128 = np.concatenate([lib_q.cpu().numpy().view(np.uint32),
                           np.zeros((1, 32), np.uint32)])  # + a zero query
    prefix = min(PLAIN_PREFIX_MXU, n_cols)
    results = {"max_err": 0.0, "ms": {}, "plain_ms": {}, "dense_ms": {}}

    def hold(name, kernel, want, whose):
        """Block maxima and counts of one kernel launch against another
        version's, bit for bit; returns the max abs error of the finite ones."""
        (bm, cnt), (wbm, wcnt) = kernel, want
        finite = torch.isfinite(bm) & torch.isfinite(wbm)
        err = (bm[finite] - wbm[finite]).abs().max().item()
        check(torch.isneginf(bm).eq(torch.isneginf(wbm)).all().item(),
              f"{name}: -inf pattern differs from {whose}")
        check(torch.equal(bm.view(torch.int32), wbm.view(torch.int32)),
              f"{name}: block maxima not bit-identical to {whose} (max abs err {err})")
        check(torch.equal(cnt, wcnt), f"{name}: counts differ from {whose}")
        return err

    for b in (1, 32, 64, 100, 128):
        q = q128[:1] if b == 1 else q128[128 - b:]
        qt = torch.from_numpy(q.view(np.int32)).to(device)
        qbits = ph3.query_bits(qt)
        qp = torch.from_numpy(popcount_rows_np(q)).to(device)
        mixed = np.where(np.arange(b) % 2 == 0, 0.0, 0.35).astype(np.float32)
        for sim, cut, ab in (("tanimoto", mixed, (1.0, 1.0)),
                             ("tversky", np.full(b, 0.35, np.float32), (0.7, 0.3))):
            ct = torch.from_numpy(cut).to(device)
            abt = torch.tensor(ab, dtype=torch.float32, device=device)
            full_plain = b == 1 or (b == 32 and sim == "tanimoto")
            cols = n_cols if full_plain else prefix
            name = f"B{b} {sim}"
            dargs = (store.words, store.popcounts, qt, qp, ct, abt, n, 256, sim)
            pargs = (store.words[:, :cols], store.popcounts[:cols], qbits, qp, ct,
                     abt, 0, 256, n, sim)
            (pbm, pcnt), p_ms = timed(lambda: ph3.mxu_phase1_plain(*pargs), device)
            if full_plain:
                results["plain_ms"].setdefault(b, p_ms)
            where = "all rows" if full_plain else f"the first {cols:,} columns"
            bm, cnt = ph3.mxu_phase1(store.words, store.popcounts, qbits, qp, ct,
                                     abt, 0, 256, n, sim)
            sync(device)
            hold(name, (bm, cnt), ph2.dense_phase1(*dargs), "the dense kernel's")
            err = hold(name, (bm, cnt) if full_plain else ph3.mxu_phase1(*pargs),
                       (pbm, pcnt), "the plain version's")
            results["max_err"] = max(results["max_err"], err)
            if sim == "tanimoto":
                check(int(cnt[0]) == n, f"{name}: cutoff-0 count {int(cnt[0])} != {n}")
            if b > 1:
                check(bm[-1].max().item() == 0.0, f"{name}: zero query not 0")
            log(f"[m] {name}: block maxima and counts bit-identical to the dense "
                f"kernel's over all rows and to the plain version's over {where} "
                f"(counts[0]={int(cnt[0])}, max abs err {err})")
            if sim == "tanimoto" and b != 100:
                args = (store.words, store.popcounts, qbits, qp, ct, abt, 0, 256, n, sim)
                k_ms = median_ms(lambda: ph3.mxu_phase1_kernel(*args), device, reps)
                d_ms = median_ms(lambda: ph2.dense_phase1_kernel(*dargs), device, reps)
                bound = mxu_bound(n_cols, b, 256)
                results["ms"][b] = (k_ms, bound)
                results["dense_ms"][b] = d_ms
                log(f"[m] B={b} at {n:,} rows: kernel median {k_ms:.3f} ms, bound "
                    f"{bound[0]:.3f} ms by {bound[1]} ({bound[0] / k_ms:.3f} of it); "
                    f"dense kernel on the same store {d_ms:.3f} ms "
                    f"({d_ms / k_ms:.2f}x); plain version {p_ms:.3f} ms over {where}")
        if b in (100, 128):
            # where the kernel forks: block 64, n_valid off a block boundary
            # and a shard offset, on the strided prefix
            offset, sim = 4096, "tanimoto"
            ct = torch.from_numpy(np.resize(np.float32([0.0, 0.35, 1.0, -0.5]), b)).to(device)
            abt = torch.ones(2, dtype=torch.float32, device=device)
            fargs = (store.words[:, :prefix], store.popcounts[:prefix], qbits, qp, ct,
                     abt, offset, 64, offset + prefix - 77, sim)
            got = ph3.mxu_phase1(*fargs)
            name = f"B{b} block 64 n_valid -77 offset {offset} cut0/0.35/1/-0.5"
            err = hold(name, got, ph3.mxu_phase1_plain(*fargs), "the plain version's")
            hold(name, got, ph2.dense_phase1(
                store.words[:, :prefix], store.popcounts[:prefix], qt, qp, ct, abt,
                prefix - 77, 64, sim), "the dense kernel's")
            results["max_err"] = max(results["max_err"], err)
            check(int(got[1][0]) == prefix - 77, f"{name}: count {int(got[1][0])}")
            log(f"[m] {name}: bit-identical to the plain version and the dense "
                f"kernel over the first {prefix:,} columns (max abs err {err})")
        if b == 32:
            results["library_ms"] = _int_mm_ms(store, qbits, device)
            log(f"[m] B=32 torch._int_mm of the query bits and the unpacked library "
                f"bits: {results['library_ms']:.3f} ms summed over all rows (the "
                "product alone, without unpacking or scoring)")
    return results


def _int_mm_ms(store, qbits, device, chunk=1 << 20):
    """``torch._int_mm`` of int8 query bits ``(B, 1024)`` and the library's
    unpacked bits, chunk by chunk: the sum of each call's CUDA-event time
    (the unpacking is not timed). The first chunk's product is checked
    against a float32 product."""
    shifts = torch.arange(32, dtype=torch.int32, device=device)
    total = 0.0
    for lo in range(0, store.n_padded, chunk):
        hi = min(store.n_padded, lo + chunk)
        cols = store.words[:, lo:hi].T  # (C, 32)
        bits = ((cols[:, :, None] >> shifts) & 1).to(torch.int8).reshape(hi - lo, 1024)
        common, ms = timed(lambda: torch._int_mm(qbits, bits.t()), device)
        total += ms
        if lo == 0:
            want = (qbits.float() @ bits.t().float()).to(torch.int32)
            check(torch.equal(common, want), "torch._int_mm disagrees with the float product")
    return total


def phase_probe(device):
    """(m) The probe's functions at its default rows: kernel 3 and kernel 2
    on one dense store, kernel 1 on a bitplane store, B 1, 32, 64 and 128; one
    JSON line per configuration."""
    from gpusimilarity_tpu_torch.tools import probe_mxu

    records = []
    for record in probe_mxu.run(probe_mxu.parse_args([]), device):
        log("[m] probe " + json.dumps(record))
        records.append(record)
    return records


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _post(port, fields, timeout=300):
    body = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(
        f"http://localhost:{port}/similarity_search_json", data=body
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"HTTP {r.status}")
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _qt_string(b: bytes) -> bytes:
    return struct.pack(">I", len(b) + 1) + b + b"\0"


def encode_socket_request(dbs, request_num, k, cutoff, fp: bytes) -> bytes:
    """A request of the reference's socket protocol (QDataStream Qt_5_2, as
    its front end writes it, ``gpusim_server.py:76-92``): the database
    (name, key) pairs, the request number, k, the cutoff as a double and the
    packed fingerprint."""
    parts = [struct.pack(">i", len(dbs))]
    for name, key in dbs:
        parts += [_qt_string(name.encode()), _qt_string(key.encode())]
    parts.append(struct.pack(">iid", request_num, k, cutoff))
    parts.append(struct.pack(">I", len(fp)) + fp)
    return b"".join(parts)


def decode_socket_response(buf: bytes):
    """``((request_num, approximate_count, smiles, ids, scores), bytes
    used)``, or None while ``buf`` holds less than one response."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(buf):
            raise EOFError
        pos += n
        return buf[pos - n:pos]

    def string():
        (n,) = struct.unpack(">I", take(4))
        return take(n)[:-1].decode()

    try:
        request_num, count = struct.unpack(">ii", take(8))
        (approx,) = struct.unpack(">Q", take(8))
        smiles = [string() for _ in range(count)]
        ids = [string() for _ in range(count)]
        scores = list(struct.unpack(f">{count}d", take(8 * count)))
    except EOFError:
        return None
    return (request_num, approx, smiles, ids, scores), pos


class SocketClient:
    """One connection to the server's Unix socket; requests in sequence."""

    def __init__(self, path):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(300)
        self.sock.connect(str(path))
        self.buf = b""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.sock.close()

    def ask(self, payload: bytes):
        """Send one request; its decoded response."""
        self.sock.sendall(payload)
        while True:
            done = decode_socket_response(self.buf)
            if done is not None:
                self.buf = self.buf[done[1]:]
                return done[0]
            chunk = self.sock.recv(1 << 20)
            check(bool(chunk), "the server closed the socket mid-response")
            self.buf += chunk


def server_rows(device, n_rows):
    """(d)'s library: ``n_rows`` Morgan-density rows from a seed, and their
    popcounts."""
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = random_rows(n_rows, gen, device)
    return rows, popcount_rows(rows).to(torch.int16)


def write_server_library(device, n_rows, tmp) -> Path:
    """Write (d)'s library once as ``smoke.fsim``: ids ``SMK<index>``, the
    SMILES field ``C<index>``, dbkey ``smoke``. (d), (f) and (h) serve it."""
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData, write_fsim

    rows, _pops = server_rows(device, n_rows)
    fps = rows.cpu().numpy().view(np.uint8).reshape(n_rows, 128)
    path = Path(tmp) / "smoke.fsim"
    t0 = time.monotonic()
    write_fsim(path, FingerprintData(
        dbkey="smoke", bitcount=1024, fingerprints=fps,
        smiles=[f"C{i}".encode() for i in range(n_rows)],
        ids=[f"SMK{i:08d}".encode() for i in range(n_rows)],
    ))
    log(f"[d] wrote {n_rows:,}-row .fsim in {time.monotonic() - t0:.2f}s")
    return path


def _port_env(root=ROOT) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root), env.get("PYTHONPATH", "")) if p
    )
    return env


@contextlib.contextmanager
def serving(paths, server_args, tag, socket_dir=None, processes=1, logs=None,
            root=ROOT, started=None):
    """Run ``python -m gpusimilarity_tpu_torch.cli.server`` on ``paths`` and
    yield its HTTP port once it prints ``ready``; stop it on exit. Its
    ``--socket_name`` socket goes in ``socket_dir`` (its ``TMPDIR``). With
    ``processes`` > 1 it runs a multi-process job on this machine
    (``--coordinator``), waits for every worker's ``ready`` too, and SIGINT
    to process 0 shuts the job down; ``logs`` then gets each process's exit
    code and stderr lines. The package comes from ``root``; ``started`` gets
    each process and its stderr lines (a list that grows) once all are
    ready."""
    port = _free_port()
    env = _port_env(root)
    if socket_dir is not None:
        env["TMPDIR"] = str(socket_dir)
    job = []
    if processes > 1:
        job = ["--coordinator", f"127.0.0.1:{_free_port()}",
               "--num_processes", str(processes)]
    t0 = time.monotonic()
    procs, lines, ready = [], [], []
    for pid in range(processes):
        proc = subprocess.Popen(
            [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server",
             *map(str, paths), "--port", str(port), *server_args, *job,
             *(["--process_id", str(pid)] if job else [])],
            cwd=root, env=env, stderr=subprocess.PIPE, text=True,
        )
        procs.append(proc)
        lines.append([])
        ready.append(threading.Event())
        marker = "ready on" if pid == 0 else f"worker {pid} ready"

        def pump(proc=proc, out=lines[-1], event=ready[-1], marker=marker):
            for line in proc.stderr:
                out.append(line)
                if marker in line:
                    event.set()

        threading.Thread(target=pump, daemon=True).start()
    try:
        while not all(e.wait(1.0) for e in ready):
            for pid, proc in enumerate(procs):
                check(proc.poll() is None,
                      f"server process {pid} exited:\n" + "".join(lines[pid][-30:]))
            check(time.monotonic() - t0 < 600, "server not ready in 600 s")
        log(f"[{tag}] server ready in {time.monotonic() - t0:.2f}s"
            + (f" ({processes} processes)" if processes > 1 else ""))
        if started is not None:
            started.extend(zip(procs, lines))
        yield port
    finally:
        procs[0].send_signal(signal.SIGINT)
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        if logs is not None:
            logs.extend((proc.returncode, out) for proc, out in zip(procs, lines))


def phase_server(device, path, n_rows, server_args=(), fold=1, tag="d",
                 kernel="bitplane_phase1", socket_dir=None):
    """Serve (d)'s written .fsim through the CLI and check its answers over
    HTTP, and with ``socket_dir`` two over the reference's socket too;
    returns the launches of ``kernel`` the server counted for them (from
    /stats, zero when the server starts) and the number of requests."""
    rows, pops = server_rows(device, n_rows)
    args = ["--batch_window_ms", "50", *server_args]
    if socket_dir is not None:
        args += ["--socket_name", SOCKET_NAME]
    with serving([path], args, tag, socket_dir) as port:
        stats = _get(port, "/stats")
        db_stats = stats["databases"]["smoke"]
        log(f"[{tag}] /stats: fold {db_stats['fold_factor']}, scan mode "
            f"{db_stats['scan_mode']}, {db_stats['device_bytes']:,} device bytes")
        check(db_stats["fold_factor"] == fold, f"server fold {db_stats['fold_factor']}")
        launches0 = stats["kernel_launches"][kernel]
        count = _check_requests(port, rows, pops, device, fold, tag)
        if socket_dir is not None:
            count += _check_socket_requests(
                Path(socket_dir) / SOCKET_NAME, rows, pops, device, fold, tag)
        stats = _get(port, "/stats")
        launches = stats["kernel_launches"][kernel] - launches0
        log(f"[{tag}] answered {count} requests; server {kernel} launches "
            f"{launches}; /stats searches {stats['searches']}")
    return launches, count


def _check_folded(tag, name, got_scores, got_idx, want_count, approx, full,
                  cut, self_row=None):
    """Rules of a folded search: the query's own row first at 1.0, every
    score its row's full-width score, (-score, index) order, every score
    >= the cutoff, and the approximate count equal to the plain folded
    count."""
    got_scores = np.asarray(got_scores, np.float32)
    if self_row is not None:
        check(len(got_idx) > 0 and got_idx[0] == self_row and got_scores[0] == 1.0,
              f"{name}: self row not first at 1.0")
    check(np.array_equal(got_scores, np.asarray(full, np.float32)),
          f"{name}: returned scores are not their rows' full-width scores")
    check(all(a > b or (a == b and i < j) for a, b, i, j in zip(
        got_scores, got_scores[1:], got_idx, got_idx[1:])),
        f"{name}: not in (-score, index) order")
    check(bool((got_scores >= cut).all()), f"{name}: score below the cutoff")
    check(approx == want_count,
          f"{name}: approximate count {approx} != folded count {want_count}")


def _check_answer(tag, what, rows, pops, q, k, cut, sim, ab, got, idx, approx,
                  fold=1, self_row=None, quiet=False):
    """(d)'s rules for one answer from (d)'s library (``idx``: the row of
    each returned id): unfolded, the top-k scores and the count of the plain
    full scan; folded, (e)'s rules (:func:`_check_folded`). ``quiet`` logs
    nothing when the answer is exact."""
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.ops.scan import (
        full_scan_topk,
        popcount_rows,
        scores_np,
    )

    cut_t = torch.tensor([cut], dtype=torch.float32, device=rows.device)
    got = np.asarray(got, np.float32)
    if fold == 1:
        v, _i, c = full_scan_topk(rows, pops, q[None, :], k, cut_t, sim, *ab)
        want = v[0][v[0] >= cut].cpu().numpy()
        check(np.array_equal(got, want), f"{what} k={k}: scores differ from "
              "the full scan")
        check(approx == int(c[0]), "approximate count differs")
        if self_row is not None:
            check(got[0] == 1.0, "self-query not 1.0 at rank 0")
    else:
        folded = fold_words(rows, fold)
        _v, _i, c = full_scan_topk(
            folded, popcount_rows(folded), fold_words(q[None, :], fold), 1,
            cut_t, sim, *ab,
        )
        full = scores_np(
            rows[idx].cpu().numpy().view(np.uint32),
            q.cpu().numpy().view(np.uint32), sim, *ab,
        )
        _check_folded(tag, f"{what} {sim} k={k}", got, idx, int(c[0]), approx,
                      full, cut, self_row)
    if quiet:
        return
    log(f"[{tag}] {what} {sim} k={k} cut={cut}: {len(got)} results, "
        f"approximate_count {approx}, exact against "
        + ("the full scan" if fold == 1 else "full-width rescore and the "
           "folded full scan"))


def _smoke_rows(tag, ids, smiles):
    """Row indices of (d)'s library from returned ids, checked against the
    returned SMILES field."""
    idx = [int(cid[3:]) for cid in ids]
    for i, cid, smi in zip(idx, ids, smiles):
        check(cid == f"SMK{i:08d}" and smi == f"C{i}",
              f"[{tag}] id {cid!r} and smiles {smi!r} disagree")
    return idx


def _check_requests(port, rows, pops, device, fold=1, tag="d"):
    from gpusimilarity_tpu_torch.serve.server import smiles_to_query_words

    n = rows.shape[0]
    rng = np.random.default_rng(SEED + 3)
    picks = [int(i) for i in rng.integers(0, n, 4)]

    def fp_form(i, k, cut, **extra):
        hexq = rows[i].cpu().numpy().view(np.uint8).tobytes().hex()
        return {"fp_hex": hexq, "return_count": k, "similarity_cutoff": cut,
                "dbnames": "smoke", "dbkeys": "smoke", **extra}

    requests = [
        (rows[picks[0]], fp_form(picks[0], 20, 0.0)),
        # the concurrent pair shares a scoring mode, so the batcher can
        # coalesce it into one kernel launch
        (rows[picks[1]], fp_form(picks[1], 128, 0.3)),
        (rows[picks[2]], fp_form(picks[2], 20, 0.0)),
        (rows[picks[3]], fp_form(picks[3], 20, 0.2, similarity="tversky",
                                 alpha=0.7, beta=0.3)),
    ]
    smiles_q, _ = smiles_to_query_words("c1ccccc1O")
    requests.append((
        torch.from_numpy(smiles_q.view(np.int32)).to(device),
        {"smiles": "c1ccccc1O", "return_count": 10, "dbnames": "smoke",
         "dbkeys": "smoke"},
    ))
    replies: list = [None] * len(requests)

    def ask(i):
        replies[i] = _post(port, requests[i][1])

    ask(0)
    pair = [threading.Thread(target=ask, args=(i,)) for i in (1, 2)]
    for t in pair:
        t.start()
    for t in pair:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in pair), "concurrent requests hung")
    ask(3)
    ask(4)
    for ri, ((q, form), reply) in enumerate(zip(requests, replies)):
        check(set(reply) >= {"approximate_count", "results"}, "reply shape")
        check(all(len(r) == 3 and isinstance(r[0], str) and isinstance(r[1], str)
                  for r in reply["results"]), "result rows are [id, smiles, score]")
        ids, smiles, got = zip(*reply["results"]) if reply["results"] else ((), (), ())
        _check_answer(
            tag, form.get("smiles") or "fp_hex", rows, pops, q,
            int(form["return_count"]), float(form.get("similarity_cutoff", 0)),
            form.get("similarity", "tanimoto"),
            (float(form.get("alpha", 1)), float(form.get("beta", 1))),
            got, _smoke_rows(tag, ids, smiles), reply["approximate_count"],
            fold, picks[ri] if "fp_hex" in form else None,
        )
    wrong = _post(port, {**requests[0][1], "dbkeys": "wrong"})
    check(wrong["results"] == [] and wrong["approximate_count"] == 0,
          "wrong dbkey must return no results")
    log(f"[{tag}] wrong dbkey: results []")
    return len(requests) + 1


def _check_socket_requests(path, rows, pops, device, fold, tag):
    """Two fingerprint self-queries over the reference's socket protocol,
    one connection, checked by :func:`_check_answer`."""
    rng = np.random.default_rng(SEED + 11)
    picks = [int(i) for i in rng.integers(0, rows.shape[0], 2)]
    with SocketClient(path) as client:
        for rn, (i, k, cut) in enumerate(zip(picks, (20, 128), (0.0, 0.3)), 1):
            fp = rows[i].cpu().numpy().tobytes()
            got_rn, approx, smiles, ids, scores = client.ask(
                encode_socket_request([("smoke", "smoke")], rn, k, cut, fp))
            check(got_rn == rn, f"[{tag}] socket request_num {got_rn} != {rn}")
            check(len(scores) > 0, f"[{tag}] socket self-query returned nothing")
            _check_answer(tag, "socket fp", rows, pops, rows[i], k, cut,
                          "tanimoto", (1.0, 1.0), scores,
                          _smoke_rows(tag, ids, smiles), approx, fold, i)
    return len(picks)


def phase_folded_library(device, n_rows, tmp):
    """(e) Write a synthetic .tfsim and load it through the registry with
    no fold or mode given."""
    from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
    from gpusimilarity_tpu_torch.parallel.mesh import Mesh, available_device_memory
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
    from gpusimilarity_tpu_torch.utils.strings import ConstantStringTable
    from gpusimilarity_tpu_torch.utils.synth import VirtualFingerprints
    from gpusimilarity_tpu_torch.utils.tfsim import save_native

    path = Path(tmp) / "enamine.tfsim"
    save_native(path, FingerprintData(
        dbkey="enamine", bitcount=1024,
        fingerprints=VirtualFingerprints(n_rows, 1024, SEED),
        smiles=ConstantStringTable(b"C", n_rows),
        ids=ConstantStringTable(b"ENAMINE", n_rows),
    ))
    free = available_device_memory(Mesh([device]))
    log(f"[e] synthetic .tfsim of {n_rows:,} rows x 1024 bits "
        f"({n_rows * 128 / 1e9:.2f} GB at full width); free device memory "
        f"{free / 1e9 if free else float('nan'):.2f} GB")
    t0 = time.monotonic()
    reg = DatabaseRegistry.from_fsim_files([str(path)], device)
    sync(device)
    build_s = time.monotonic() - t0
    db = reg.get("enamine")
    free = available_device_memory(reg.mesh)
    store = db.store.shards[0]
    log(f"[e] registry resolved fold {db.fold_factor}, scan mode {db.scan_mode}; "
        f"store {store.nbytes:,} bytes ({store.word_count} words/row, "
        f"popcounts {'no' if store.popcounts is None else 'yes'}); built in "
        f"{build_s:.2f}s; free device memory "
        f"{free / 1e9 if free else float('nan'):.2f} GB")
    check(db.fold_factor == 4 and db.scan_mode == "dense",
          f"expected fold 4 dense, got fold {db.fold_factor} {db.scan_mode}")
    return db


def phase_folded_engine(db, device, reps=(5, 3)):
    """(e) Engine searches on the folded dense library, each result held to
    the full-width rescore, the plain folded full scan and its order."""
    from gpusimilarity_tpu_torch.models.fingerprint_db import _k_bucket
    from gpusimilarity_tpu_torch.ops.fold import fold_words, overfetch_count
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np, scores_np
    from gpusimilarity_tpu_torch.parallel.sharded import (
        DenseStore,
        dense_full_scan_topk,
        dense_local_topk,
    )
    from gpusimilarity_tpu_torch.utils.synth import (
        pick_query_rows,
        virtual_full_topk,
        virtual_rows_np,
    )

    n, store, fold = db.count, db.store.shards[0], db.fold_factor
    rows = pick_query_rows(32, n, fold, seed=SEED)
    qfull = virtual_rows_np(rows, seed=SEED)
    qf = np.ascontiguousarray(fold_words(qfull, fold))
    cut32 = np.tile(np.float32([0.0, 0.3, 0.5, 0.2]), 8)
    qt = torch.from_numpy(qf.view(np.int32)).to(device)
    qp = torch.from_numpy(popcount_rows_np(qf)).to(device)
    ct = torch.from_numpy(cut32).to(device)
    k_fetch_max = _k_bucket(overfetch_count(128, fold), n)
    t0 = time.monotonic()
    ov, oi, oc = dense_full_scan_topk(store, qt, qp, ct, k_fetch_max)
    sync(device)
    log(f"[e] plain folded full scan (B=32, top {k_fetch_max}) in "
        f"{time.monotonic() - t0:.2f}s; query folded popcounts "
        f"{int(qp.min())}-{int(qp.max())}")
    latency, results = {}, {}
    for b, k in ((1, 20), (1, 128), (32, 20), (32, 128)):
        res = db.search_batch(qfull[:b], k, cut32[:b], db.dbkey, return_indices=True)
        results[(b, k)] = res
        for qi, r in enumerate(res):
            full = scores_np(virtual_rows_np(np.array(r.indices), seed=SEED), qfull[qi])
            _check_folded("e", f"B={b} k={k} q{qi}", r.scores, r.indices,
                          int(oc[qi]), r.approximate_count, full, cut32[qi],
                          int(rows[qi]))
        k_fetch = _k_bucket(overfetch_count(k, fold), n)
        v, i, c = dense_local_topk(store, qt[:b], qp[:b], ct[:b], k_fetch)
        check(torch.equal(v, ov[:b, :k_fetch]) and torch.equal(i, oi[:b, :k_fetch]),
              f"B={b} k={k}: device candidates differ from the plain folded scan")
        check(torch.equal(c, oc[:b]), f"B={b} k={k}: device counts differ")
        ts = []
        for _ in range(reps[0] if b == 1 else reps[1]):
            t0 = time.perf_counter()
            db.search_batch(qfull[:b], k, cut32[:b], db.dbkey)
            ts.append((time.perf_counter() - t0) * 1e3)
        latency[(b, k)] = statistics.median(ts)
        log(f"[e] engine B={b} k={k} (k_fetch {k_fetch}): rules 1-5 hold "
            f"(count[0]={res[0].approximate_count}); search_batch median "
            f"{latency[(b, k)]:.3f} ms (host clock, rescore included)")
    log(f"[e] B=1 latency {latency[(1, 20)]:.3f} ms (k=20) / "
        f"{latency[(1, 128)]:.3f} ms (k=128) beside the reference's "
        f"{REFERENCE_FOLD4_MS} ms on 4x V100 at fold 4 (a yardstick, not a claim)")

    # one popless engine search: the same words, no popcount array
    pdb = copy.copy(db)
    pdb._store = dataclasses.replace(db.store, shards=(
        DenseStore(words=store.words, popcounts=None, n_valid=n),))
    pdb.popless = True
    pres = pdb.search_batch(qfull, 128, cut32, db.dbkey, return_indices=True)
    for p_r, r in zip(pres, results[(32, 128)]):
        check((p_r.scores, p_r.indices, p_r.approximate_count)
              == (r.scores, r.indices, r.approximate_count),
              "popless search differs from the search with popcounts")
    log("[e] popless search B=32 k=128: identical to the search with popcounts")

    t0 = time.monotonic()
    _tv, ti, _tc = virtual_full_topk(n, qfull, 20, SEED, row_chunk=1 << 18,
                                     device=device)
    got = db.search_batch(qfull, 20, 0.0, db.dbkey, return_indices=True)
    hits = [len(set(r.indices) & set(ti[qi].tolist())) / 20 for qi, r in enumerate(got)]
    log(f"[e] recall@20 against the full-width top 20 (B=32, cutoff 0): mean "
        f"{statistics.mean(hits):.4f}, min {min(hits):.2f}; full-width oracle in "
        f"{time.monotonic() - t0:.2f}s")
    return latency


def _hold_dense_to_plain(tag, name, args, device):
    """One dense-kernel case: the checked wrapper the engine calls against
    the plain version, bit for bit; returns (max abs err, plain ms)."""
    from gpusimilarity_tpu_torch.ops import dense_phase1 as ph2

    words, _pops, q, _qp, cut, _ab, n_valid = args[:7]
    (pbm, pcnt), plain_ms = timed(lambda: ph2.dense_phase1_plain(*args), device)
    bm, cnt = ph2.dense_phase1(*args)
    sync(device)
    finite = torch.isfinite(bm) & torch.isfinite(pbm)
    err = (bm[finite] - pbm[finite]).abs().max().item()
    check(torch.isneginf(bm).eq(torch.isneginf(pbm)).all().item(),
          f"{name}: -inf pattern differs")
    check(torch.equal(bm.view(torch.int32), pbm.view(torch.int32)),
          f"{name}: block maxima not bit-identical (max abs err {err})")
    check(torch.equal(cnt, pcnt), f"{name}: counts differ")
    want = min(n_valid, words.shape[1])
    for i in torch.nonzero(cut <= 0.0).flatten().tolist():
        check(int(cnt[i]) == want, f"{name}: cutoff<=0 count {int(cnt[i])} != {want}")
    if len(q) > 1:
        check(bm[-1].max().item() == 0.0, f"{name}: zero query not 0")
    log(f"[{tag}] {name} over {words.shape[1]:,} columns "
        f"(n_valid {want:,}): block maxima and counts bit-identical "
        f"(counts[:4]={pcnt[:4].tolist()}, max abs err {err}); plain {plain_ms:.3f} ms")
    return err, plain_ms


def phase_dense_kernel_vs_plain(store, device, reps=(10, 10)):
    """(b2) The dense kernel against its plain version, bit for bit, in
    (e)'s store. At full width: B=1 (Tanimoto, Tversky, popless) and B=32
    with cutoffs 0 and 0.35 mixed. On column prefixes, where the plain
    version at full width would take minutes: B=32 Tversky and popless, and
    where the kernel forks: cutoffs 0, 0.35, 1.0
    and a negative one in one launch at B 5 (no multiple of 16), 32 and 48
    (two slices), with ``n_valid`` off a block boundary; a zero query last
    in every batch over 1."""
    from gpusimilarity_tpu_torch.ops import dense_phase1 as ph2
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.tools.probe_mxu import dense_bound
    from gpusimilarity_tpu_torch.utils.synth import pick_query_rows, virtual_rows_np

    n = store.n_valid
    fold = 32 // store.word_count
    rows = pick_query_rows(47, n, fold, seed=SEED, rng_seed=SEED)
    lib_q = fold_words(virtual_rows_np(rows, seed=SEED), fold)
    zero = np.zeros((1, store.word_count), np.uint32)
    q32 = np.concatenate([lib_q[:31], zero])  # 31 library rows + a zero query
    q48 = np.concatenate([lib_q, zero])
    mixed = np.where(np.arange(32) % 2 == 0, 0.0, 0.35).astype(np.float32)
    mixed4 = np.tile(np.float32([0.0, 0.35, 1.0, -0.5]), 12)
    prefix = min(PLAIN_PREFIX_COLS, store.n_padded)
    forks = min(PLAIN_PREFIX_FORKS, store.n_padded)
    cases = [
        # name, queries, cutoffs, similarity, alpha/beta, popless, columns,
        # n_valid (None: the store's)
        ("B1 tanimoto cut0.35", q32[:1], [0.35], "tanimoto", (1, 1), False, None, None),
        ("B1 tversky cut0.35", q32[:1], [0.35], "tversky", (0.7, 0.3), False, None, None),
        ("B1 popless cut0", q32[:1], [0.0], "tanimoto", (1, 1), True, None, None),
        ("B32 tanimoto cut0/0.35", q32, mixed, "tanimoto", (1, 1), False, None, None),
        ("B32 tversky cut0.35", q32, [0.35] * 32, "tversky", (0.7, 0.3), False, prefix, None),
        ("B32 popless cut0/0.35", q32, mixed, "tanimoto", (1, 1), True, prefix, None),
        ("B32 tanimoto cut0/0.35/1/-0.5", q32, mixed4[:32], "tanimoto", (1, 1), False, forks, forks - 77),
        ("B5 tanimoto cut0/0.35/1/-0.5", q32[27:], mixed4[:5], "tanimoto", (1, 1), False, forks, forks - 77),
        ("B48 tanimoto cut0/0.35/1/-0.5", q48, mixed4, "tanimoto", (1, 1), False, forks, forks - 77),
        ("B48 popless tversky cut0.35", q48, [0.35] * 48, "tversky", (0.7, 0.3), True, forks, forks - 77),
    ]
    max_err, timing = 0.0, {}
    for name, q, cut, sim, ab, popless, cols, n_valid in cases:
        words = store.words if cols is None else store.words[:, :cols]
        pops = None if popless else store.popcounts[:words.shape[1]]
        args = (
            words, pops, torch.from_numpy(q.view(np.int32)).to(device),
            torch.from_numpy(popcount_rows_np(q)).to(device),
            torch.tensor(cut, dtype=torch.float32, device=device),
            torch.tensor(ab, dtype=torch.float32, device=device),
            n if n_valid is None else n_valid, 256, sim,
        )
        err, plain_ms = _hold_dense_to_plain("b2", name, args, device)
        max_err = max(max_err, err)
        if cols is None and not popless and sim == "tanimoto":
            b = len(q)
            r = reps[0] if b == 1 else reps[1]
            k_ms = median_ms(lambda: ph2.dense_phase1(*args), device, r)
            timing[b] = (k_ms, plain_ms,
                         dense_bound(words.shape[1], store.word_count, b, 256))
            log(f"[b2] B={b} at {n:,} rows: kernel median {k_ms:.3f} ms (one "
                f"launch and its zeroed counts), plain {plain_ms:.3f} ms (one run)")
    return max_err, timing


def phase_dense_folds(rows, device):
    """(m) The dense kernel on rows of 4 and 16 words (fold 8 and 2: a k
    step padded with zero words, and two k steps), against its plain
    version on the first FOLD_CHECK_ROWS rows of (b)'s library."""
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows
    from gpusimilarity_tpu_torch.parallel.sharded import build_store

    n = min(FOLD_CHECK_ROWS, rows.shape[0])
    max_err = 0.0
    for fold in (8, 2):
        store = build_store(rows[:n], fold_factor=fold)
        q = torch.cat([fold_words(rows[:31], fold),
                       torch.zeros_like(rows[:1, :32 // fold])])
        args = (
            store.words, store.popcounts, q.contiguous(), popcount_rows(q),
            torch.from_numpy(np.tile(np.float32([0.0, 0.35, 1.0, -0.5]), 8)).to(device),
            torch.ones(2, dtype=torch.float32, device=device), n - 77, 256, "tanimoto",
        )
        err, _ = _hold_dense_to_plain(
            "m", f"fold {fold} ({store.word_count} words a row) B32 tanimoto "
            "cut0/0.35/1/-0.5", args, device)
        max_err = max(max_err, err)
    return max_err


def phase_profile_dense(store, device, reps=10):
    """(p2) Where a dense fold-4 search's time goes, by device op."""
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.parallel.sharded import dense_local_topk
    from gpusimilarity_tpu_torch.utils.synth import pick_query_rows, virtual_rows_np

    fold = 32 // store.word_count
    rows = pick_query_rows(32, store.n_valid, fold, seed=SEED, rng_seed=SEED + 5)
    q32 = np.ascontiguousarray(fold_words(virtual_rows_np(rows, seed=SEED), fold))
    for b in (1, 32):
        q = q32[:b]
        args = (
            store, torch.from_numpy(q.view(np.int32)).to(device),
            torch.from_numpy(popcount_rows_np(q)).to(device),
            torch.zeros(b, dtype=torch.float32, device=device), 2048,
        )
        _profile_search("p2", f"B={b} k=128 (k_fetch 2048) fold {fold}",
                        lambda: dense_local_topk(*args), device, reps)


def phase_bitplane_fold(device, n_rows, fold=4):
    """(g) One B=32, k=128 bitplane search at fold 4 on a virtual library,
    checked by (e)'s rules; returns the bitplane kernel's launches."""
    from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB
    from gpusimilarity_tpu_torch.ops import bitplane_phase1 as ph1
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.ops.scan import full_scan_topk, popcount_rows, scores_np
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
    from gpusimilarity_tpu_torch.utils.strings import ConstantStringTable
    from gpusimilarity_tpu_torch.utils.synth import (
        VirtualFingerprints,
        pick_query_rows,
        virtual_folded_rows,
        virtual_rows_np,
    )

    data = FingerprintData(
        dbkey="g", bitcount=1024, fingerprints=VirtualFingerprints(n_rows, 1024, SEED),
        smiles=ConstantStringTable(b"C", n_rows), ids=ConstantStringTable(b"G", n_rows),
    )
    t0 = time.monotonic()
    db = FingerprintDB(data, device=device, fold_factor=fold, scan_mode="bitplane")
    sync(device)
    log(f"[g] bitplane store of {n_rows:,} virtual rows at fold {fold}: "
        f"{db.store.shards[0].planes.shape[0]} planes, {db.store.nbytes:,} bytes, "
        f"built in {time.monotonic() - t0:.2f}s")
    rows = pick_query_rows(32, n_rows, fold, seed=SEED, rng_seed=SEED + 9)
    qfull = virtual_rows_np(rows, seed=SEED)
    cut = np.tile(np.float32([0.0, 0.3, 0.5, 0.2]), 8)
    ph1.reset_launch_count()
    t0 = time.perf_counter()
    res = db.search_batch(qfull, 128, cut, "g", return_indices=True)
    ms = (time.perf_counter() - t0) * 1e3
    launches = ph1.launch_count()
    folded = virtual_folded_rows(n_rows, fold, 32, SEED, device)
    qf = np.ascontiguousarray(fold_words(qfull, fold))
    _v, _i, counts = full_scan_topk(
        folded, popcount_rows(folded), torch.from_numpy(qf.view(np.int32)).to(device),
        1, torch.from_numpy(cut).to(device),
    )
    for qi, r in enumerate(res):
        full = scores_np(virtual_rows_np(np.array(r.indices), seed=SEED), qfull[qi])
        _check_folded("g", f"q{qi}", r.scores, r.indices, int(counts[qi]),
                      r.approximate_count, full, cut[qi], int(rows[qi]))
    log(f"[g] B=32 k=128 at fold {fold}: rules 1-4 hold for every query; "
        f"search_batch {ms:.3f} ms (host clock, rescore included); "
        f"bitplane launches {launches}")
    return launches


S_BITPLANE_SHARDS = 4  # (s): shards of the 113,335,291-row bitplane library
S_DENSE_SHARDS = 2  # (s): shards of the 1,020,017,472-row fold-4 library
S_ROUND_TRIPS = 50  # (s): B=1 requests per server for each p50


def _one_shard(store, device):
    """An unsharded store as the one shard of a one-device mesh."""
    from gpusimilarity_tpu_torch.parallel.mesh import Mesh
    from gpusimilarity_tpu_torch.parallel.sharded import ShardedStore

    return ShardedStore(shards=(store,), row0s=(0,), n_valid=store.n_valid,
                        n_shards=1, per_shard=store.n_padded, mesh=Mesh([device]))


def _host_ms(fn, reps):
    """Median host-clock ms of ``fn`` (which returns host tensors, so each
    call ends synchronised), after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_sharded_bitplane(rows, store, device, reps=10):
    """(s) The 113,335,291-row bitplane library cut into 4 shards on the
    card, searched through ``sharded_local_topk`` against the unsharded
    store's answers to the same queries: equal scores, equal summed counts,
    every index carrying its score; one kernel launch per shard; the
    search's wall time at 4 shards and at 1. Returns the times and the
    launches."""
    from gpusimilarity_tpu_torch.ops import bitplane_phase1 as ph1
    from gpusimilarity_tpu_torch.ops.bitplane import query_plane_indices
    from gpusimilarity_tpu_torch.ops.scan import (
        popcount_rows,
        popcount_rows_np,
        similarity_from_counts,
    )
    from gpusimilarity_tpu_torch.parallel.mesh import make_mesh
    from gpusimilarity_tpu_torch.parallel.sharded import (
        build_sharded_store,
        sharded_local_topk,
    )

    n = store.n_valid
    t0 = time.monotonic()
    four = build_sharded_store(rows, make_mesh([device] * S_BITPLANE_SHARDS), "bitplane")
    sync(device)
    log(f"[s] {n:,} rows in {S_BITPLANE_SHARDS} bitplane shards on one card "
        f"(spans of {four.per_shard:,} rows): built in {time.monotonic() - t0:.2f}s, "
        f"{four.nbytes:,} bytes against {store.nbytes:,} unsharded")
    one = _one_shard(store, device)
    pops = store.popcounts[:n]
    idx = pick_queries(rows, pops, n, 32, 64, SEED + 5)
    q32 = rows[idx].cpu().numpy().view(np.uint32)
    cut32 = np.tile(np.float32([0.0, 0.3, 0.5, 0.2]), 8)
    out, launches = {}, 0
    for b in (1, 32):
        q, cut = q32[:b], cut32[:b]
        plane_idx, _bucket = query_plane_indices(q, store.bitcount)
        qp = popcount_rows_np(q)
        v1, _i1, c1 = sharded_local_topk(one, plane_idx, qp, cut, 128)
        before = ph1.launch_count()
        v4, i4, c4 = sharded_local_topk(four, plane_idx, qp, cut, 128)
        sync(device)
        per_search = ph1.launch_count() - before
        launches += per_search
        check(per_search == S_BITPLANE_SHARDS,
              f"[s] B={b}: {per_search} launches for {S_BITPLANE_SHARDS} shards")
        check(torch.equal(v4, v1), f"[s] B={b}: 4-shard scores differ from 1 shard")
        check(tuple(c4.shape) == (S_BITPLANE_SHARDS, b)
              and torch.equal(c4.sum(0), c1.sum(0)), f"[s] B={b}: counts differ")
        qt = torch.from_numpy(q.view(np.int32)).to(device)
        gi = i4.to(device)
        common = popcount_rows(rows[gi] & qt[:, None, :])
        rescored = similarity_from_counts(common, pops[gi], popcount_rows(qt))
        check(bool((gi >= 0).all()) and torch.equal(rescored.cpu(), v4),
              f"[s] B={b}: returned indices do not carry their scores")
        ms1 = _host_ms(lambda: sharded_local_topk(one, plane_idx, qp, cut, 128), reps)
        ms4 = _host_ms(lambda: sharded_local_topk(four, plane_idx, qp, cut, 128), reps)
        out[b] = (ms1, ms4)
        log(f"[s] bitplane B={b} k=128: 4 shards exact against 1 shard "
            f"(count[0]={int(c4[:, 0].sum())}, {per_search} launches); wall "
            f"(host clock, median of {reps}) 1 shard {ms1:.3f} ms, "
            f"{S_BITPLANE_SHARDS} shards {ms4:.3f} ms")
    del four
    return out, launches


def dense_reference(db, device, reps=5):
    """(s) The unsharded fold-4 library's answers to (s)'s queries, and its
    ``sharded_local_topk`` wall time, before the store is freed."""
    from gpusimilarity_tpu_torch.models.fingerprint_db import _k_bucket
    from gpusimilarity_tpu_torch.ops.fold import fold_words, overfetch_count
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.parallel.sharded import sharded_local_topk
    from gpusimilarity_tpu_torch.utils.synth import pick_query_rows, virtual_rows_np

    rows = pick_query_rows(32, db.count, db.fold_factor, seed=SEED, rng_seed=SEED + 21)
    qfull = virtual_rows_np(rows, seed=SEED)
    qf = np.ascontiguousarray(fold_words(qfull, db.fold_factor))
    cut = np.tile(np.float32([0.0, 0.3, 0.5, 0.2]), 8)
    k_fetch = _k_bucket(overfetch_count(128, db.fold_factor), db.count)
    ref = {"rows": rows, "qfull": qfull, "qf": qf, "cut": cut, "k_fetch": k_fetch,
           "answers": {}, "ms": {}}
    for b in (1, 32):
        ref["answers"][b] = [
            (r.scores, r.indices, r.approximate_count)
            for r in db.search_batch(qfull[:b], 128, cut[:b], db.dbkey,
                                     return_indices=True)
        ]
        args = (qf[:b].view(np.int32), popcount_rows_np(qf[:b]), cut[:b], k_fetch)
        ref["ms"][b] = _host_ms(lambda: sharded_local_topk(db.store, *args), reps)
    return ref


def phase_sharded_dense(path, ref, device, reps=5):
    """(s) The 1,020,017,472-row library loaded again through the registry
    on a mesh of 2 shards on the card (the unsharded store freed first): it
    must resolve fold 4, dense, as unsharded (free memory counts the card
    once); its engine answers equal the unsharded ones exactly (dense:
    scores, indices and counts); one kernel launch per shard per 32-query
    slice; the wall time at 2 shards beside 1. Returns times, launches."""
    from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
    from gpusimilarity_tpu_torch.ops import dense_phase1 as ph2
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.parallel.mesh import make_mesh
    from gpusimilarity_tpu_torch.parallel.sharded import sharded_local_topk

    t0 = time.monotonic()
    reg = DatabaseRegistry.from_fsim_files(
        [str(path)], mesh=make_mesh([device] * S_DENSE_SHARDS))
    sync(device)
    db = reg.get("enamine")
    log(f"[s] {db.count:,} rows in {S_DENSE_SHARDS} shards on one card: fold "
        f"{db.fold_factor}, {db.scan_mode}, {db.store.nbytes:,} bytes, built in "
        f"{time.monotonic() - t0:.2f}s")
    check(db.fold_factor == 4 and db.scan_mode == "dense",
          f"[s] expected fold 4 dense, got fold {db.fold_factor} {db.scan_mode}")
    out, launches = {}, 0
    qf, cut, k_fetch = ref["qf"], ref["cut"], ref["k_fetch"]
    for b in (1, 32):
        before = ph2.launch_count()
        res = db.search_batch(ref["qfull"][:b], 128, cut[:b], db.dbkey,
                              return_indices=True)
        per_search = ph2.launch_count() - before
        launches += per_search
        check(per_search == S_DENSE_SHARDS * -(-b // 32),
              f"[s] B={b}: {per_search} dense launches for {S_DENSE_SHARDS} shards")
        got = [(r.scores, r.indices, r.approximate_count) for r in res]
        check(got == ref["answers"][b],
              f"[s] B={b}: 2-shard answers differ from the unsharded ones")
        check(all(r.indices[0] == int(row) and r.scores[0] == 1.0
                  for r, row in zip(res, ref["rows"])), "[s] self row not first")
        args = (qf[:b].view(np.int32), popcount_rows_np(qf[:b]), cut[:b], k_fetch)
        ms2 = _host_ms(lambda: sharded_local_topk(db.store, *args), reps)
        out[b] = (ref["ms"][b], ms2)
        log(f"[s] fold 4 dense B={b} k=128 (k_fetch {k_fetch}): answers equal "
            f"the unsharded engine's; {per_search} launches; wall of the store "
            f"search (host clock, median of {reps}) 1 shard {ref['ms'][b]:.3f} ms, "
            f"{S_DENSE_SHARDS} shards {ms2:.3f} ms")
    del db, reg
    return out, launches


def phase_sharded_server_stats(device, path):
    """(s) (d)'s library served in process over a 4-shard bitplane mesh and
    a 2-shard fold-4 dense mesh on the card: answers exact by (d)'s rules,
    ``/stats`` reporting the shards and counting one launch per shard per
    request. Returns each kernel's launches over the checked requests, read
    from ``/stats``."""
    from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
    from gpusimilarity_tpu_torch.parallel.mesh import make_mesh
    from gpusimilarity_tpu_torch.serve.server import SimilarityServer

    rows, pops = server_rows(device, SERVER_ROWS)
    served = {}
    for shards, fold, kernel in ((S_BITPLANE_SHARDS, None, "bitplane_phase1"),
                                 (S_DENSE_SHARDS, 4, "dense_phase1")):
        reg = DatabaseRegistry.from_fsim_files(
            [str(path)], mesh=make_mesh([device] * shards), fold_factor=fold)
        srv = SimilarityServer(reg, port=0, window_ms=50.0)
        srv.start_background()
        try:
            stats = _get(srv.port, "/stats")
            check(stats["databases"]["smoke"]["shards"] == shards,
                  f"[s] /stats shards {stats['databases']['smoke']['shards']}")
            l_start = stats["kernel_launches"][kernel]
            _check_requests(srv.port, rows, pops, device, fold or 1, "s")
            l0 = _get(srv.port, "/stats")["kernel_launches"][kernel]
            for i in (11, SERVER_ROWS // 7, SERVER_ROWS - 1):
                _post(srv.port, {
                    "fp_hex": rows[i].cpu().numpy().view(np.uint8).tobytes().hex(),
                    "return_count": 20, "dbnames": "smoke", "dbkeys": "smoke"})
            stats = _get(srv.port, "/stats")
            launches = stats["kernel_launches"][kernel] - l0
            check(launches == 3 * shards,
                  f"[s] /stats: {launches} {kernel} launches for 3 requests on "
                  f"{shards} shards")
            served[kernel] = stats["kernel_launches"][kernel] - l_start
            mode = stats["databases"]["smoke"]["scan_mode"]
            log(f"[s] /stats on {shards} shards ({mode}, "
                f"fold {fold or 1}): answers exact; 3 requests, {launches} "
                f"{kernel} launches")
        finally:
            srv.close()
        del reg
    return served


def _round_trips(port, sock, rows, n_rows):
    """Median ms of ``S_ROUND_TRIPS`` B=1 self-queries (k=20) over HTTP and
    over the socket, one at a time."""
    rng = np.random.default_rng(SEED + 23)
    picks = [int(i) for i in rng.integers(0, n_rows, S_ROUND_TRIPS)]
    http, sockt = [], []
    for i in picks:
        form = {"fp_hex": rows[i].cpu().numpy().view(np.uint8).tobytes().hex(),
                "return_count": 20, "dbnames": "smoke", "dbkeys": "smoke"}
        t0 = time.perf_counter()
        reply = _post(port, form)
        http.append((time.perf_counter() - t0) * 1e3)
        check(reply["results"][0][0] == f"SMK{i:08d}", "[s] HTTP self-query")
    with SocketClient(sock) as client:
        for rn, i in enumerate(picks, 1):
            payload = encode_socket_request([("smoke", "smoke")], rn, 20, 0.0,
                                            rows[i].cpu().numpy().tobytes())
            t0 = time.perf_counter()
            _rn, _approx, _smiles, ids, _scores = client.ask(payload)
            sockt.append((time.perf_counter() - t0) * 1e3)
            check(ids[0] == f"SMK{i:08d}", "[s] socket self-query")
    return statistics.median(http), statistics.median(sockt)


def phase_two_process_server(device, path, tmp, server_args=()):
    """(s) ``cli.server`` on (d)'s library as one process, then as two
    processes sharing the card (``--coordinator``): the two-process
    answers exact by (d)'s rules over HTTP and the socket, each process fed
    its half of the fingerprint bytes, both exiting cleanly; the HTTP and
    socket B=1 round-trip p50 of each. Returns the p50s and process 0's
    bitplane launches."""
    from gpusimilarity_tpu_torch.parallel.sharded import (
        SELECT_BLOCK_COLS,
        plan_shard_spans,
    )

    rows, pops = server_rows(device, SERVER_ROWS)
    sock_dir = Path(tmp) / "s"
    sock_dir.mkdir(exist_ok=True)
    sock = sock_dir / SOCKET_NAME
    p50, launches = {}, 0
    for processes in (1, 2):
        logs = []
        with serving([path], ["--socket_name", SOCKET_NAME, *server_args], "s",
                     sock_dir, processes=processes, logs=logs) as port:
            stats = _get(port, "/stats")
            check(stats["processes"] == processes
                  and stats["databases"]["smoke"]["shards"] == processes,
                  f"[s] /stats of the {processes}-process server: {stats}")
            if processes == 2:
                l0 = stats["kernel_launches"]["bitplane_phase1"]
                _check_requests(port, rows, pops, device, 1, "s")
                _check_socket_requests(sock, rows, pops, device, 1, "s")
                launches = _get(port, "/stats")["kernel_launches"]["bitplane_phase1"] - l0
            p50[processes] = _round_trips(port, sock, rows, SERVER_ROWS)
        log(f"[s] {processes}-process server, B=1 k=20 round trip p50 over "
            f"{S_ROUND_TRIPS} requests: HTTP {p50[processes][0]:.3f} ms, socket "
            f"{p50[processes][1]:.3f} ms")
        if processes == 2:
            spans = plan_shard_spans(SERVER_ROWS, 2, SELECT_BLOCK_COLS)
            for pid, (rc, lines) in enumerate(logs):
                check(rc == 0, f"[s] server process {pid} exited {rc}:\n"
                      + "".join(lines[-20:]))
                fed = [int(m.group(1)) for m in map(
                    re.compile(r"worker \d+: smoke fed (\d+) fp bytes").search,
                    lines) if m]
                lo, hi = spans[pid]
                check(fed == [(hi - lo) * 128],
                      f"[s] process {pid} fed {fed}, its span is {(hi - lo) * 128}")
                log(f"[s] process {pid}: fed {fed[0]:,} fp bytes (rows "
                    f"[{lo:,}, {hi:,})), exited 0")
    return p50, launches


W_NEXT = 20  # (w): B=1 round trips after the first, for the median
W_BURST = 8  # (w): concurrent requests of the first burst
W_LATER = 5  # (w): bursts after the first, for the median (the batcher's
# grouping of a burst varies from one to the next)
W_SERVERS = (  # (w): (label, fold, kernel, server flags)
    ("bitplane", 1, "bitplane_phase1", ()),
    ("dense fold 4", 4, "dense_phase1", ("--fold", "4")),
)


def _timed_post(port, form):
    t0 = time.perf_counter()
    reply = _post(port, form)
    return reply, t0, time.perf_counter()


def _burst(port, forms):
    """``forms`` sent together from one thread each, released at once:
    ``(replies, wall ms until all are answered, the slowest request's ms)``."""
    done = [None] * len(forms)
    gate = threading.Barrier(len(forms) + 1)

    def ask(j):
        gate.wait()
        done[j] = _timed_post(port, forms[j])

    threads = [threading.Thread(target=ask, args=(j,)) for j in range(len(forms))]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    check(all(d is not None for d in done), "[w] a burst request did not return")
    return ([d[0] for d in done], (max(d[2] for d in done) - t0) * 1e3,
            max((d[2] - d[1]) * 1e3 for d in done))


def _first_requests(port, forms, kernel):
    """The first request, ``W_NEXT`` more one at a time, then the burst of
    ``W_BURST`` and ``W_LATER`` more of it for reference: the replies and
    the times, with the kernel's launches (the batcher's groups) in the
    first burst and the median over the later ones."""
    replies, out = [], {}
    reply, t0, t1 = _timed_post(port, forms[0])
    replies.append(reply)
    out["first_ms"] = (t1 - t0) * 1e3
    next_ms = []
    for form in forms[1:1 + W_NEXT]:
        reply, t0, t1 = _timed_post(port, form)
        replies.append(reply)
        next_ms.append((t1 - t0) * 1e3)
    out["next_p50_ms"] = statistics.median(next_ms)
    out["next_max_ms"] = max(next_ms)
    burst = forms[1 + W_NEXT:]
    walls, slowest, groups = [], [], []
    for _ in range(1 + W_LATER):
        l0 = _get(port, "/stats")["kernel_launches"][kernel]
        got, wall, slow = _burst(port, burst)
        groups.append(_get(port, "/stats")["kernel_launches"][kernel] - l0)
        walls.append(wall)
        slowest.append(slow)
        replies += got
    out["burst_ms"], out["burst_slowest_ms"] = walls[0], slowest[0]
    out["burst_launches"] = groups[0]
    out["later_burst_p50_ms"] = statistics.median(walls[1:])
    out["later_burst_launches_p50"] = statistics.median(groups[1:])
    return replies, {key: round(v, 3) for key, v in out.items()}


def phase_first_requests(device, path, server_args=()):
    """(w) a server's start-up up to its first answers: ``cli.server`` on
    (d)'s library, bitplane and ``--fold 4`` dense, each started with
    ``--no_warmup`` and then with its default warm-up. Per server: the
    seconds to ``ready``, the warm-up's own seconds (its ``warmed up``
    line), the first B=1 k=20 HTTP round trip, the median of the next 20,
    the first burst of 8 concurrent requests (wall ms until all are
    answered, the slowest, and the batcher's groups as kernel launches),
    then the median of 5 more such bursts. Every answer exact by (d)'s
    rules; the warmed
    server launched its kernel before ``ready`` and the other did not; each
    exits 0 on SIGINT. Returns the records and each kernel's launches over
    the requests (``/stats`` deltas)."""
    rows, pops = server_rows(device, SERVER_ROWS)
    rng = np.random.default_rng(SEED + 29)
    picks = [int(i) for i in rng.choice(SERVER_ROWS, 1 + W_NEXT + W_BURST,
                                        replace=False)]
    forms = [{"fp_hex": rows[i].cpu().numpy().view(np.uint8).tobytes().hex(),
              "return_count": 20, "similarity_cutoff": 0, "dbnames": "smoke",
              "dbkeys": "smoke"} for i in picks]
    records, launches = [], {"bitplane_phase1": 0, "dense_phase1": 0}
    for label, fold, kernel, flags in W_SERVERS:
        for warm in (False, True):
            logs = []
            t0 = time.monotonic()
            args = [*flags, *server_args] + ([] if warm else ["--no_warmup"])
            with serving([path], args, "w", logs=logs) as port:
                ready_s = time.monotonic() - t0
                at_ready = _get(port, "/stats")["kernel_launches"][kernel]
                check((at_ready > 0) == warm,
                      f"[w] {label}: {at_ready} {kernel} launches before ready "
                      f"({'with' if warm else 'without'} warm-up)")
                replies, times = _first_requests(port, forms, kernel)
                stats = _get(port, "/stats")
                launched = stats["kernel_launches"][kernel] - at_ready
            rc, lines = logs[0]
            check(rc == 0, f"[w] {label} server exited {rc} on SIGINT:\n"
                  + "".join(lines[-20:]))
            warmed = [float(m.group(1)) for m in map(
                re.compile(r"warmed up smoke \(([0-9.]+)s\)").search, lines) if m]
            check(len(warmed) == int(warm), f"[w] {label}: warm-up lines {warmed}")
            check(len(replies) == len(picks) + W_LATER * W_BURST
                  and launched > 0 and stats["searches"] == len(replies),
                  f"[w] {label}: {launched} launches, {stats['searches']} searches")
            for i, reply in zip(picks + picks[1 + W_NEXT:] * W_LATER, replies):
                ids, smiles, got = zip(*reply["results"])
                _check_answer("w", label, rows, pops, rows[i], 20, 0.0, "tanimoto",
                              (1.0, 1.0), got, _smoke_rows("w", ids, smiles),
                              reply["approximate_count"], fold, i, quiet=True)
            launches[kernel] += launched
            record = {
                "server": label, "warmup": warm, "ready_s": round(ready_s, 3),
                "warmup_s": warmed[0] if warmed else None, **times,
                "launches_before_ready": at_ready, "launches": launched,
            }
            records.append(record)
            log(f"[w] {label} {'with' if warm else 'without'} warm-up: ready in "
                f"{ready_s:.2f}s" + (f" (warm-up {warmed[0]}s)" if warmed else "")
                + f", first B=1 {times['first_ms']} ms, next {W_NEXT} p50 "
                f"{times['next_p50_ms']} ms, first burst of {W_BURST} "
                f"{times['burst_ms']} ms (slowest {times['burst_slowest_ms']}, "
                f"{times['burst_launches']} launches), the next {W_LATER} p50 "
                f"{times['later_burst_p50_ms']} ms ({times['later_burst_launches_p50']} "
                f"launches); {len(replies)} answers exact; {kernel} {at_ready} launches "
                f"before ready, {launched} for the requests")
    log("[w] " + json.dumps({"first_requests": records, "card": gpu_line()}))
    return records, launches


X_FIRST_MS = 3000  # (x): the capture around a server's first requests
X_LOAD_MS = 2000  # (x): the capture under the load test's 32 clients
X_SERVERS = (  # (x): (label, fold, kernel, its name in the trace, flags, from
    # a fresh copy of the package with no build directory)
    ("fold 4 dense", 4, "dense_phase1", "dense_phase1_mma_kernel", ("--fold", "4"),
     True),
    ("bitplane", 1, "bitplane_phase1", "bitplane_phase1_kernel", (), False),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _merged(intervals):
    """Sorted, disjoint ``(start, end)`` intervals covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, lo, hi):
    """How much of ``[lo, hi]`` the merged intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def _self_times(events):
    """Each event's duration less its direct children's (events of one
    thread, nested by time)."""
    out, stack = collections.Counter(), []
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        if stack:
            out[stack[-1]["name"]] -= e["dur"]
        out[e["name"]] += e["dur"]
        stack.append(e)
    return out


def _short(name, width=60):
    return name if len(name) <= width else name[:width - 3] + "..."


def span_split(events, span):
    """One search span of a trace: its wall ms, the device's busy ms inside
    it, the top 5 host ops of its thread by self ms and the top 5 device ops
    by ms inside it."""
    lo, hi = span["ts"], span["ts"] + span["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    host = [e for e in events if e.get("ph") == "X" and e.get("pid") == span["pid"]
            and e.get("tid") == span["tid"] and e.get("cat") not in DEVICE_CATS
            and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
    by_device = collections.Counter()
    for e in device:
        by_device[e["name"]] += min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)
    busy = _covered(_merged((e["ts"], e["ts"] + e["dur"]) for e in device), lo, hi)
    return {
        "wall_ms": round(span["dur"] / 1e3, 3),
        "device_busy_ms": round(busy / 1e3, 3),
        "host_top": [[_short(n), round(us / 1e3, 3)]
                     for n, us in _self_times(host).most_common(5)],
        "device_top": [[_short(n), round(us / 1e3, 3)]
                       for n, us in by_device.most_common(5)],
    }


def _checked_trace(tag, reply, kernel_name, batches, launches):
    """A capture's trace against the server's ``/stats`` deltas over the
    window: one ``tpusim.search.smoke`` span a batch, none on the listener's
    thread, and one ``kernel_name`` device event a launch. Returns the trace
    and its spans in time order."""
    events = _trace_events(reply["trace"])
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] == "tpusim.search.smoke"), key=lambda e: e["ts"])
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel_name in e["name"]]
    check(len(spans) == batches == reply["spans"].get("tpusim.search.smoke"),
          f"[{tag}] {len(spans)} spans in the trace, {reply['spans']} in the "
          f"reply, {batches} batches in /stats")
    check(all(e["tid"] != reply["listener_tid"] for e in spans),
          f"[{tag}] a search span on the listener's thread")
    check(len(kernels) == launches > 0,
          f"[{tag}] {len(kernels)} {kernel_name} events in the trace, {launches} "
          "launches in /stats")
    return events, spans


def _second_capture_refused(profiler_port, tag):
    try:
        urllib.request.urlopen(
            f"http://localhost:{profiler_port}/capture?duration_ms=100", timeout=60)
    except urllib.error.HTTPError as e:
        check(e.code == 409, f"[{tag}] a second capture got {e.code}, not 409")
        return
    check(False, f"[{tag}] a second capture was not refused")


def listening_ports(pid):
    """The TCP ports process ``pid`` listens on (``/proc``)."""
    inodes = set()
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        with contextlib.suppress(OSError):
            target = os.readlink(fd)
            if target.startswith("socket:["):
                inodes.add(target[8:-1])
    ports = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        with contextlib.suppress(OSError), open(table) as f:
            for row in list(f)[1:]:
                cols = row.split()
                if cols[3] == "0A" and cols[9] in inodes:  # LISTEN
                    ports.add(int(cols[1].rsplit(":", 1)[1], 16))
    return ports


def _package_copy(directory) -> Path:
    """The package, ``native/`` sources and ``pyproject.toml`` copied as a
    fresh checkout holds them: no build directory, no built library."""
    import shutil

    root = Path(directory) / "fresh"
    skip = shutil.ignore_patterns("__pycache__", "*.so", "*.o")
    for name in ("gpusimilarity_tpu_torch", "native"):
        shutil.copytree(ROOT / name, root / name, ignore=skip)
    shutil.copy2(ROOT / "pyproject.toml", root / "pyproject.toml")
    return root


def _start_up_seconds(lines):
    """From a server's log: the library's load line and the kernels' ready
    lines, in log order, with the seconds each reports."""
    order, seconds = [], {}
    for line in lines:
        m = re.search(r"loaded smoke: .*\(([0-9.]+)s\)", line)
        if m:
            order.append("load")
            seconds["load_s"] = float(m.group(1))
        m = re.search(r"uploaded smoke to .*\(([0-9.]+)s", line)
        if m:
            seconds["upload_s"] = float(m.group(1))
        m = re.search(r"(\w+) kernel ready \(.*built in ([0-9.]+)s\)", line)
        if m:
            order.append(m.group(1))
            seconds[f"{m.group(1)}_build_s"] = float(m.group(2))
    return order, seconds


def phase_profiled_servers(device, path, tmp, server_args=()):
    """(x) the live profiling hook and the overlapped start-up.

    Two servers on (d)'s library with ``--no_warmup --profiler_port``: fold
    4 dense from a fresh copy of the package (its kernels built at start-up
    while the library loads: the load's log line must come before
    ``dense_phase1 kernel ready``), and bitplane from the checkout. On each,
    a ``X_FIRST_MS`` capture opened right after ``ready`` holds the first
    B=1 k=20 request, ``W_NEXT`` more and a burst of ``W_BURST``, every
    answer exact by (d)'s rules; the trace holds one span a batch, none on
    the listener's thread, and one kernel event a launch (``/stats``
    deltas); a second capture meanwhile gets 409; the first request's span
    and the median of the next ones are split into host and device time.
    Then a capture on the bitplane server is cut by SIGINT: exit 0, trace
    written. A server without the flag listens on its HTTP port only. Last,
    ``tools.loadtest --profile_ms X_LOAD_MS``: its 32 clients under a
    capture, read for the device's busy share, the search spans' p50 and
    the share of request time outside any search span. Returns the
    records and each kernel's launches in the captured windows."""
    rows, pops = server_rows(device, SERVER_ROWS)
    rng = np.random.default_rng(SEED + 31)
    picks = [int(i) for i in rng.choice(SERVER_ROWS, 1 + W_NEXT + W_BURST,
                                        replace=False)]
    forms = [{"fp_hex": rows[i].cpu().numpy().view(np.uint8).tobytes().hex(),
              "return_count": 20, "similarity_cutoff": 0, "dbnames": "smoke",
              "dbkeys": "smoke"} for i in picks]
    trace_dir = Path(tmp) / "traces"
    records, launches = {}, {"bitplane_phase1": 0, "dense_phase1": 0}
    for label, fold, kernel, kernel_name, flags, cold in X_SERVERS:
        root = _package_copy(tmp) if cold else ROOT
        profiler_port = _free_port()
        logs, started = [], []
        t0 = time.monotonic()
        args = [*flags, *server_args, "--no_warmup", "--profiler_port",
                str(profiler_port), "--profile_dir", str(trace_dir)]
        with serving([path], args, "x", logs=logs, root=root,
                     started=started) as port:
            ready_s = time.monotonic() - t0
            pid = started[0][0].pid
            check(listening_ports(pid) == {port, profiler_port},
                  f"[x] {label}: listening on {listening_ports(pid)}")
            stats0 = _get(port, "/stats")
            capture = profiler.start_capture(profiler_port, X_FIRST_MS)
            times, replies = [], []
            for form in forms[:1 + W_NEXT]:
                sent = time.time()
                replies.append(_post(port, form))
                times.append((sent, time.time()))
            got, _wall, _slow = _burst(port, forms[1 + W_NEXT:])
            replies += got
            done_at = time.time()
            _second_capture_refused(profiler_port, "x")
            reply = capture.result(timeout=X_FIRST_MS / 1e3 + 300)
            stats = _get(port, "/stats")
            lo, hi = reply["window"]
            check(times[0][0] >= lo and done_at <= hi,
                  f"[x] {label}: the requests ran outside the window "
                  f"[{lo:.3f}, {hi:.3f}] ({times[0][0]:.3f}-{done_at:.3f})")
            launched = (stats["kernel_launches"][kernel]
                        - stats0["kernel_launches"][kernel])
            events, spans = _checked_trace(
                "x", reply, kernel_name, stats["batches"] - stats0["batches"],
                launched)
            launches[kernel] += launched
            for i, answer in zip(picks, replies):
                ids, smiles, scores = zip(*answer["results"])
                _check_answer("x", label, rows, pops, rows[i], 20, 0.0, "tanimoto",
                              (1.0, 1.0), scores, _smoke_rows("x", ids, smiles),
                              answer["approximate_count"], fold, i, quiet=True)
            nxt = sorted(spans[1:1 + W_NEXT], key=lambda e: e["dur"])
            record = {
                "ready_s": round(ready_s, 3),
                "first_ms": round((times[0][1] - times[0][0]) * 1e3, 3),
                "next_p50_ms": round(statistics.median(
                    (b - a) * 1e3 for a, b in times[1:]), 3),
                "first_span": span_split(events, spans[0]),
                "next_median_span": span_split(events, nxt[len(nxt) // 2]),
                "spans": len(spans), "launches": launched,
                "trace_bytes": reply["bytes"], "events": reply["events"],
                "threads": reply["threads"],
            }
            if cold:
                order, seconds = _start_up_seconds(started[0][1])
                check("load" in order and "dense_phase1" in order
                      and order.index("load") < order.index("dense_phase1"),
                      f"[x] cold start: log order {order}, not the load first")
                record["start_up"] = seconds
            else:
                # a capture cut short by SIGINT: the server still exits 0
                # and the trace is written
                before = set(trace_dir.iterdir())
                profiler.start_capture(profiler_port, 60_000)
        rc, lines = logs[0]
        check(rc == 0, f"[x] {label}: exit {rc} on SIGINT:\n" + "".join(lines[-20:]))
        if not cold:
            check(len(set(trace_dir.iterdir()) - before) == 1,
                  f"[x] {label}: no trace written by the capture SIGINT cut")
            record["sigint_during_capture_rc"] = rc
        records[label] = record
        log(f"[x] {label}: ready in {ready_s:.2f}s"
            + (f" (start-up {record['start_up']})" if cold else "")
            + f"; {len(replies)} answers exact inside a {X_FIRST_MS} ms capture, "
            f"{len(spans)} spans = batches, {launched} {kernel_name} events = "
            f"launches; trace {reply['bytes']:,} bytes, {reply['events']:,} "
            f"events, {reply['threads']} threads; 409 for a second capture")
        for key in ("first_span", "next_median_span"):
            log(f"[x] {label} {key}: {json.dumps(record[key])}")

    # off by default: no second port
    started = []
    with serving([path], [*server_args, "--no_warmup"], "x", started=started) as port:
        ports = listening_ports(started[0][0].pid)
        check(ports == {port}, f"[x] without --profiler_port: listening on {ports}")
    log(f"[x] without --profiler_port the server listens on {port} only")

    p = _tool("x", "loadtest", "--profile_ms", X_LOAD_MS, env={"TMPDIR": str(tmp)},
              timeout=900)
    check(p["failures"] == 0 and p["requests"] == p["searches"],
          f"[x] loadtest: {p['failures']} failures, {p['requests']} requests, "
          f"{p['searches']} searches")
    events = _trace_events(p["profile"]["trace"])
    complete = [e for e in events if e.get("ph") == "X"]
    device = _merged((e["ts"], e["ts"] + e["dur"]) for e in complete
                     if e.get("cat") in DEVICE_CATS)
    searches = [e for e in complete if e.get("cat") == "user_annotation"
                and e["name"].startswith(profiler.SPAN_PREFIX)]
    requests = [e for e in complete if e.get("cat") == "user_annotation"
                and e["name"] == profiler.REQUEST_SPAN]
    check(searches and requests, "[x] loadtest: no search or request spans")
    in_search = _merged((e["ts"], e["ts"] + e["dur"]) for e in searches)
    request_us = sum(e["dur"] for e in requests)
    records["load"] = {
        "qps": p["profiled_qps"], "p50_ms": p["profiled_p50_ms"],
        "samples": p["profiled_samples"],
        "device_busy_share": round(
            sum(b - a for a, b in device) / 1e3 / X_LOAD_MS, 4),
        "search_span_p50_ms": round(statistics.median(
            e["dur"] for e in searches) / 1e3, 3),
        "request_outside_search_share": round(1 - sum(
            _covered(in_search, e["ts"], e["ts"] + e["dur"]) for e in requests)
            / request_us, 4),
        "spans": len(searches), "requests_traced": len(requests),
        "trace_bytes": p["profile"]["bytes"], "events": p["profile"]["events"],
    }
    for name, n in p["kernel_launches"].items():
        launches[name] += n
    log(f"[x] load ({gpu_line()}): {json.dumps(records['load'])}")
    log("[x] " + json.dumps({"profiled_servers": records, "card": gpu_line()}))
    return records, launches


def phase_dryrun(device):
    """(s) ``tools/dryrun_multichip`` over 4 shards on the card."""
    from gpusimilarity_tpu_torch.tools import dryrun_multichip
    from gpusimilarity_tpu_torch.parallel.mesh import make_mesh

    done = dryrun_multichip.dryrun_multichip(make_mesh([device] * 4))
    log(f"[s] dryrun_multichip(4) on {device}: " + "; ".join(done))


H_SMILES = 100_000  # (h): compounds of the SMILES library createdb builds
H_DBKEY = "zinc"
# (h): chain units of the SMILES library, each bonded to the unit before it
# through its first atom and to the one after it through its last, and the
# groups that end a chain
SMILES_UNITS = (
    "C", "CC", "CCC", "C(C)", "C(C)(C)", "C(=O)", "C(=O)N", "NC(=O)", "N",
    "N(C)", "O", "OC", "S", "S(=O)(=O)", "C(F)(F)", "C(O)", "C(N)", "C(Cl)",
    "C=C", "c1ccc(cc1)", "c1ccccc1", "c1ccncc1", "c1cc(F)ccc1", "c1ccsc1",
    "c1cc[nH]c1", "c1ccc2ccccc2c1", "C1CCN(CC1)", "N1CCN(CC1)", "C1CC1",
    "C1CCOC1", "c1cnc(nc1)", "C(C#N)", "c1ccoc1", "c1cc(Cl)ccc1",
    "c1cc(OC)ccc1", "C1CCCCC1", "N1CCOCC1", "C(=O)O", "OCC", "NC",
)
SMILES_ENDS = (
    "C", "O", "N", "F", "Cl", "Br", "C(=O)O", "C#N", "C(F)(F)F", "OC",
    "S(N)(=O)=O", "C(C)C", "c1ccccc1", "N(C)C", "C(=O)N",
)
BAD_SMILES_LINE = "C1CC(N BAD000000001\n"  # unclosed ring and branch
CUTOFF_GRID = tuple(np.float32(c) for c in np.arange(0.0, 1.0001, 0.05))


def write_smiles_library(path, n, seed) -> dict[str, str]:
    """A gzip ``.smi`` of ``n`` SMILES made by string assembly from
    :data:`SMILES_UNITS` (two or three units and an end group) with ids
    ``ZINC<index>``, plus one bad line in the middle; returns id -> SMILES
    of the good lines, in file order."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, 4, n)
    units = rng.integers(0, len(SMILES_UNITS), (n, 3))
    ends = rng.integers(0, len(SMILES_ENDS), n)
    by_id = {}
    for i in range(n):
        by_id[f"ZINC{i:09d}"] = "".join(
            SMILES_UNITS[u] for u in units[i, :lengths[i]]
        ) + SMILES_ENDS[ends[i]]
    lines = [f"{smi} {cid}\n" for cid, smi in by_id.items()]
    lines.insert(n // 2, BAD_SMILES_LINE)
    with gzip.open(path, "wt") as fh:
        fh.writelines(lines)
    return by_id


def _run_cli(tag, name, *args, stdin=None, timeout=900):
    """Run ``python -m gpusimilarity_tpu_torch.cli.<name>``; returns the
    finished process and its seconds. Fails on a non-zero exit."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", f"gpusimilarity_tpu_torch.cli.{name}",
         *map(str, args)],
        cwd=ROOT, env=_port_env(), input=stdin, capture_output=True, text=True,
        timeout=timeout,
    )
    seconds = time.monotonic() - t0
    check(proc.returncode == 0,
          f"[{tag}] {name} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return proc, seconds


def _same_data(a, b) -> bool:
    return (a.count == b.count and a.bitcount == b.bitcount
            and a.dbkey == b.dbkey and a.generator == b.generator
            and np.array_equal(np.asarray(a.fingerprints), np.asarray(b.fingerprints))
            and list(a.smiles) == list(b.smiles) and list(a.ids) == list(b.ids))


def phase_createdb(tmp):
    """(h) 1-5: build a library from SMILES with the port's createdb, to
    ``.fsim`` and streamed to ``.tfsim``; convertdb and mergedb; check the
    files. Returns the paths, the loaded library and the times."""
    from gpusimilarity_tpu_torch.utils.fingerprints import (
        generator_tag,
        smiles_to_fingerprint_bin,
    )
    from gpusimilarity_tpu_torch.utils.tfsim import load_any

    tmp = Path(tmp)
    smi = tmp / "zinc.smi.gz"
    by_id = write_smiles_library(smi, H_SMILES, SEED + 13)
    fsim, merged = tmp / "zinc.fsim", tmp / "zinc2.fsim"
    created, converted = tmp / "created.tfsim", tmp / "converted.tfsim"
    # one worker per core this process may run on (os.cpu_count() counts
    # the host's, which a container may not have)
    workers = len(os.sched_getaffinity(0))
    proc, secs = _run_cli("h", "createdb", smi, fsim, "--dbkey", H_DBKEY,
                          "--workers", workers)
    check("Error processing" in proc.stderr, "createdb did not report the bad line")
    _proc, secs_t = _run_cli("h", "createdb", smi, created, "--dbkey", H_DBKEY,
                             "--workers", workers)
    rates = (H_SMILES / secs, H_SMILES / secs_t)
    log(f"[h] createdb of {H_SMILES:,} SMILES and one bad line with "
        f"{workers} workers: .fsim {secs:.2f}s, {rates[0]:.0f} "
        f"compounds/s; streamed .tfsim {secs_t:.2f}s, {rates[1]:.0f} compounds/s")
    _proc, secs_c = _run_cli("h", "convertdb", fsim, converted)
    _proc, secs_m = _run_cli("h", "mergedb", "-o", merged, fsim, fsim)
    log(f"[h] convertdb .fsim -> .tfsim {secs_c:.2f}s; mergedb of the .fsim "
        f"with itself {secs_m:.2f}s")

    data = load_any(fsim)
    ids = [b.decode() for b in data.ids]
    check(data.count == H_SMILES and ids == list(by_id),
          f"createdb kept {data.count} rows, not the {H_SMILES:,} good lines "
          "in order")
    check(data.dbkey == H_DBKEY and data.generator == generator_tag(),
          f"dbkey {data.dbkey!r}, generator {data.generator!r}")
    sample = np.random.default_rng(SEED + 14).choice(H_SMILES, 200, replace=False)
    for i in sample:
        fp, canon = smiles_to_fingerprint_bin(by_id[ids[i]])
        check(data.fingerprints[i].tobytes() == fp and data.smiles[i] == canon,
              f"row {i}: fingerprint or SMILES differs from "
              "smiles_to_fingerprint_bin")
    check(_same_data(load_any(created), data), "createdb's .tfsim != the .fsim")
    check(_same_data(load_any(converted), data), "convertdb's .tfsim != the .fsim")
    two = load_any(merged)
    check(two.count == 2 * H_SMILES and two.dbkey == H_DBKEY
          and np.array_equal(two.fingerprints, np.concatenate([data.fingerprints] * 2))
          and [b.decode() for b in two.ids] == ids * 2,
          "mergedb output is not the library twice")
    log(f"[h] bad line dropped, {H_SMILES:,} rows, 200 sampled rows equal "
        "smiles_to_fingerprint_bin, both .tfsim load equal to the .fsim, the "
        f"merged file has {two.count:,} rows")
    return {"fsim": fsim, "merged": merged, "data": data, "by_id": by_id,
            "rates": rates, "seconds": (secs, secs_t, secs_c, secs_m)}


class _Library:
    """One database the (h) server serves, for the plain checks: rows and
    popcounts on the card, and the id and SMILES of each row."""

    def __init__(self, name, key, rows, pops, ids=None, smiles=None):
        self.name, self.key, self.rows, self.pops = name, key, rows, pops
        self._ids, self._smiles = ids, smiles

    def id(self, i):
        return self._ids[i] if self._ids is not None else f"SMK{i:08d}"

    def smiles(self, i):
        return self._smiles[i] if self._smiles is not None else f"C{i}"

    def counts(self, q, cuts):
        from gpusimilarity_tpu_torch.ops.scan import full_scan_topk

        qs = q[None, :].expand(len(cuts), -1).contiguous()
        cut_t = torch.tensor(cuts, dtype=torch.float32, device=q.device)
        return full_scan_topk(self.rows, self.pops, qs, 1, cut_t)[2].tolist()

    def at_least(self, q, cut, count):
        """(score, row) of every row scoring >= ``cut``: ``count`` many."""
        from gpusimilarity_tpu_torch.ops.scan import full_scan_topk

        if count == 0:
            return []
        cut_t = torch.tensor([cut], dtype=torch.float32, device=q.device)
        v, i, c = full_scan_topk(self.rows, self.pops, q[None, :], count, cut_t)
        check(int(c[0]) == count and bool((v[0] >= cut).all()), "plain count")
        return list(zip(v[0].tolist(), i[0].tolist()))


def expected_merge(libs, q, k):
    """The reference's multi-database answer (``gpusim.cpp:306-374``) to a
    query at the smallest cutoff of :data:`CUTOFF_GRID` at which every
    database's whole >= cutoff set fits in ``k``, so that no tie decides
    which rows come back: all rows sorted by (-score, database order, id,
    SMILES), duplicate SMILES dropped with their ids joined by ``;:;``.
    Returns (cutoff, count, smiles, ids, scores)."""
    counts = np.array([lib.counts(q, CUTOFF_GRID) for lib in libs])
    fits = np.flatnonzero(counts.sum(axis=0) <= k)
    check(fits.size > 0, f"more than {k} rows score 1.0")
    ci = int(fits[0])
    cut = float(CUTOFF_GRID[ci])
    rows = []
    for order, lib in enumerate(libs):
        rows += [(-sc, order, lib.id(i), lib.smiles(i))
                 for sc, i in lib.at_least(q, cut, int(counts[order, ci]))]
    rows.sort()
    smiles, ids, scores, seen = [], [], [], {}
    for neg, _order, cid, smi in rows:
        if smi in seen:
            ids[seen[smi]] += ";:;" + cid
            continue
        seen[smi] = len(smiles)
        smiles.append(smi)
        ids.append(cid)
        scores.append(-neg)
    return cut, int(counts[:, ci].sum()), smiles, ids, scores


def _post_page(port, path, fields):
    body = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(f"http://localhost:{port}{path}", data=body)
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read().decode()


def phase_entrypoints(device, tmp, smoke_path, built, server_args=()):
    """(h) 6-12: serve the built library, its merged twin and (d)'s library
    through ``cli.server --socket_name --http_interface``, then ask it over
    the socket, the HTML UI, ``cli.search`` and the FDW."""
    from gpusimilarity_tpu_torch.fdw import TpuSimilarityFDW
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows

    data = built["data"]
    words = np.ascontiguousarray(data.fingerprints).view(np.int32)
    zrows = torch.from_numpy(words).to(device)
    zpops = popcount_rows(zrows).to(torch.int16)
    zids = [b.decode() for b in data.ids]
    zsmiles = [b.decode() for b in data.smiles]
    srows, spops = server_rows(device, SERVER_ROWS)
    libs = {
        "zinc": _Library("zinc", H_DBKEY, zrows, zpops, zids, zsmiles),
        "zinc2": _Library("zinc2", H_DBKEY, torch.cat([zrows, zrows]),
                          torch.cat([zpops, zpops]), zids * 2, zsmiles * 2),
        "smoke": _Library("smoke", "smoke", srows, spops),
    }
    rng = np.random.default_rng(SEED + 17)
    zr = [int(i) for i in rng.integers(0, H_SMILES, 5)]
    sr = [int(i) for i in rng.integers(0, SERVER_ROWS, 53)]
    out = {}
    args = ["--socket_name", SOCKET_NAME, "--http_interface", *server_args]
    with serving([built["fsim"], built["merged"], smoke_path], args, "h", tmp) as port:
        sock = Path(tmp) / SOCKET_NAME
        launches0 = _get(port, "/stats")["kernel_launches"]["bitplane_phase1"]

        def fp_of(name, i):
            return libs[name].rows[i % libs[name].rows.shape[0]]

        # (d)'s library has no duplicate SMILES: (d)'s rules. Answers from
        # the built libraries merge duplicate molecules, so they are held to
        # the plain scans' merge, exactly
        singles = [(sr[0], 20, 0.0), (sr[1], 128, 0.3)]
        merges = [(("zinc",), "zinc", zr[0]), (("zinc2",), "zinc", zr[1]),
                  (("zinc", "smoke"), "zinc", zr[2]),
                  (("zinc", "zinc2"), "zinc", zr[3]),
                  (("zinc2", "zinc", "smoke"), "zinc", zr[4]),
                  (("smoke", "zinc"), "smoke", sr[2])]
        with SocketClient(sock) as client:
            for rn, (i, k, cut) in enumerate(singles, 1):
                lib, q = libs["smoke"], fp_of("smoke", i)
                got_rn, approx, smiles, ids, scores = client.ask(
                    encode_socket_request([("smoke", lib.key)], rn, k, cut,
                                          q.cpu().numpy().tobytes()))
                check(got_rn == rn and len(scores) > 0,
                      f"[h] socket smoke: request {got_rn}, {len(scores)} results")
                _check_answer("h", "socket smoke", lib.rows, lib.pops, q, k, cut,
                              "tanimoto", (1.0, 1.0), scores,
                              _smoke_rows("h", ids, smiles), approx, 1, i)
            for rn, (names, qname, i) in enumerate(merges, len(singles) + 1):
                q = fp_of(qname, i)
                cut, count, want_smiles, want_ids, want_scores = expected_merge(
                    [libs[n] for n in names], q, 100)
                got = client.ask(encode_socket_request(
                    [(n, libs[n].key) for n in names], rn, 100, cut,
                    q.cpu().numpy().tobytes()))
                check(got == (rn, count, want_smiles, want_ids, want_scores),
                      f"[h] socket {names}: the answer differs from the plain "
                      f"scans' merge at cutoff {cut}")
                check(want_scores[0] == 1.0, f"[h] socket {names}: no self hit")
                joined = sum(";:;" in cid for cid in want_ids)
                log(f"[h] socket {'+'.join(names)} cut={cut:.2f}: {len(want_ids)} "
                    f"results ({joined} with joined ids), count {count}, exact "
                    "against the plain scans' merge")
            wrong = client.ask(encode_socket_request(
                [("zinc", "wrong")], 99, 20, 0.0, fp_of("zinc", zr[0]).cpu().numpy().tobytes()))
            check(wrong == (99, 0, [], [], []), "[h] socket wrong dbkey answered")
            log("[h] socket wrong dbkey: empty answer")

        # a complete record whose first string lacks its NUL: the server
        # must drop the connection, then answer on a new one
        corrupt = struct.pack(">iI", 1, 4) + b"zinc" + _qt_string(b"k") + \
            struct.pack(">iid", 7, 5, 0.0) + struct.pack(">I", 128) + bytes(128)
        with SocketClient(sock) as client:
            client.sock.sendall(corrupt)
            check(client.sock.recv(1 << 16) == b"", "[h] corrupt request answered")
        latencies = []
        with SocketClient(sock) as client:
            for rn, i in enumerate(sr[3:], 1000):
                payload = encode_socket_request(
                    [("smoke", "smoke")], rn, 20, 0.0, fp_of("smoke", i).cpu().numpy().tobytes())
                t0 = time.perf_counter()
                got_rn, _approx, _smiles, ids, scores = client.ask(payload)
                latencies.append((time.perf_counter() - t0) * 1e3)
                check(got_rn == rn and ids[0] == f"SMK{i:08d}" and scores[0] == 1.0,
                      "[h] socket self-query")
        out["socket_p50_ms"] = statistics.median(latencies)
        log(f"[h] corrupt request: connection dropped; the server answered "
            f"{len(latencies)} B=1 self-queries on a new connection after it, "
            f"round trip p50 {out['socket_p50_ms']:.3f} ms (min "
            f"{min(latencies):.3f}, max {max(latencies):.3f}; k=20, "
            f"{SERVER_ROWS:,} rows)")

        with urllib.request.urlopen(f"http://localhost:{port}/", timeout=60) as r:
            status, page = r.status, r.read().decode()
        check(status == 200 and 'action="/similarity_search"' in page,
              "[h] GET / is not the search form")
        # the UI, the REPL and the FDW ask for an input SMILES whose 10 best
        # rows are 10 molecules: the merge folds rows of one SMILES into one,
        # so a compound with duplicates among its neighbours returns fewer
        for row in rng.integers(0, H_SMILES, 64):
            query_row = int(row)
            query_smiles = built["by_id"][zids[query_row]]
            want = _post(port, {"smiles": query_smiles, "return_count": 10,
                                "dbnames": "zinc", "dbkeys": H_DBKEY})
            if len(want["results"]) == 10:
                break
        check(len(want["results"]) == 10, "[h] no compound with 10 distinct neighbours")
        form = {"smiles": query_smiles, "return_count": 20,
                "similarity_cutoff": 0.0, "dbnames": "zinc", "dbkeys": H_DBKEY}
        page_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            status, page = _post_page(port, "/similarity_search", form)
            page_ms.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f"[h] HTML search {status}")
        check(page.count("<svg") >= 2
              and 'href="http://zinc.docking.org/substance/' in page,
              "[h] the results page lacks depictions or ZINC links")
        out["page_ms"] = (page_ms[0], statistics.median(page_ms[1:]))
        log(f"[h] HTML UI: GET / 200 with the form; POST /similarity_search 200, "
            f"{page.count('<svg')} SVG depictions, ZINC links; page "
            f"{page_ms[0]:.3f} ms first (depictions drawn), "
            f"{out['page_ms'][1]:.3f} ms median of 4 more (memoised)")

        proc, _secs = _run_cli(
            "h", "search", "--port", port, "--dbnames", "zinc", "--dbkeys",
            H_DBKEY, "--return_count", 5, stdin=query_smiles + "\n\n")
        hit = [ln for ln in proc.stdout.splitlines()
               if ln.split()[:1] == ["1.0000"] and ln.split()[-1] == zsmiles[query_row]]
        check(bool(hit), f"[h] cli.search printed no self hit:\n{proc.stdout}")
        log(f"[h] cli.search: {hit[0].strip()}")

        Qual = collections.namedtuple("Qual", "field_name operator value")
        fdw = TpuSimilarityFDW({"server": "localhost", "port": str(port),
                                "db_name": "zinc", "dbkey": H_DBKEY,
                                "max_results": "10"}, {})
        cols = ["id", "query", "smiles", "similarity"]
        fdw_rows = list(fdw.execute([Qual("query", "=", query_smiles)], cols))
        check(fdw_rows == [{"id": cid, "query": query_smiles, "smiles": smi,
                             "similarity": sc} for cid, smi, sc in want["results"]],
              f"[h] FDW rows {fdw_rows[:2]} differ from the JSON answer")
        # the self row leads, among any rows of the same fingerprint
        check(fdw_rows[0]["similarity"] == 1.0
              and any(r["smiles"] == zsmiles[query_row] for r in fdw_rows
                      if r["similarity"] == 1.0), "[h] FDW: no self row first")
        check(list(fdw.execute([], cols)) == [], "[h] FDW without a qual")
        log(f"[h] FDW: {len(fdw_rows)} rows, the JSON answer's, self row first "
            f"({fdw_rows[0]['id']})")

        stats = _get(port, "/stats")
        out["launches"] = stats["kernel_launches"]["bitplane_phase1"] - launches0
        check(out["launches"] > 0, "[h] the bitplane kernel did not launch")
        log(f"[h] server bitplane launches {out['launches']}; /stats searches "
            f"{stats['searches']}")
    out["createdb_rates"] = built["rates"]
    return out


TOOLS = "gpusimilarity_tpu_torch.tools"
SCALE_ROWS = 16_777_216  # (t4)-(t6): the fold_scale library's rows (cut)
LOAD104_ROWS = 104_000_000  # (t5): loadtest104's rows, cut to SCALE_ROWS
ACCURACY_CHECK = ("--rows", 50_000, "--queries", 10)  # (t3): card vs host
# (t6): rows of the synthetic .tfsim served, cut from FOLDED_ROWS: its ids are
# stored, 13 bytes a row, and writing 1,020,017,472 of them took 150 s on the
# H100 machine's host (PERF.md section 6)
FLAGSHIP_ROWS = LIB_ROWS


def _tool(tag, name, *args, env=None, timeout=900, one_line=False, result=True,
          every_line=False):
    """Run ``python -m gpusimilarity_tpu_torch.tools.<name> args`` from the
    repository root (a subprocess, as a user runs it); it must exit 0. Its
    last stdout line is its JSON result (unless ``result`` is false): logged
    beside the card, returned parsed. ``every_line``: every stdout line is
    a JSON result; each is logged, and the list is returned."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", f"{TOOLS}.{name}", *map(str, args)], cwd=ROOT,
        env={**_port_env(), **(env or {})}, capture_output=True, text=True,
        timeout=timeout,
    )
    check(proc.returncode == 0,
          f"[{tag}] {name} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    if not result:
        log(f"[{tag}] {name} {' '.join(map(str, args))} in "
            f"{time.monotonic() - t0:.1f}s ({gpu_line()})")
        return None
    lines = proc.stdout.strip().splitlines()
    check(bool(lines) and (len(lines) == 1 or not one_line),
          f"[{tag}] {name} printed {len(lines)} stdout lines, not one")
    if every_line:
        log(f"[{tag}] {name} {' '.join(map(str, args))} in "
            f"{time.monotonic() - t0:.1f}s ({gpu_line()}):")
        for line in lines:
            log(f"[{tag}]   {line}")
        return [json.loads(line) for line in lines]
    log(f"[{tag}] {name} {' '.join(map(str, args))} "
        f"{' '.join(f'{k}={v}' for k, v in (env or {}).items())} in "
        f"{time.monotonic() - t0:.1f}s ({gpu_line()}): {lines[-1]}")
    return json.loads(lines[-1])


def _add_launches(total, payload):
    for name, n in payload["kernel_launches"].items():
        total[name] += n


def phase_bench(launches):
    """(t1), (t2) the port's bench as a subprocess: fold 4 on 1,020,017,472
    virtual rows at its defaults (never cut), then unfolded on 113,335,291
    rows, bitplane and dense; every oracle error field 0, self-matches
    full, and at fold 1 every full-oracle query's whole top-k exact."""
    from gpusimilarity_tpu_torch.tools import bench
    from gpusimilarity_tpu_torch.utils.synth import aligned_virtual_rows

    out = {}
    for tag, env, default, ladder in (
        ("t1", {}, bench.FOLDED_ROWS, bench.FOLDED_LADDER),
        ("t2", {"TPUSIM_BENCH_FOLD": "1"}, bench.UNFOLDED_ROWS, bench.UNFOLDED_LADDER),
        ("t2", {"TPUSIM_BENCH_FOLD": "1", "TPUSIM_BENCH_MODE": "dense"},
         bench.UNFOLDED_ROWS, bench.UNFOLDED_LADDER),
    ):
        with phase(tag):
            p = _tool(tag, "bench", env=env, timeout=900, one_line=True)
        rungs = [aligned_virtual_rows(r, 1) for r in ladder]
        check(p["platform"] == "cuda", f"[{tag}] platform {p['platform']}")
        check(p["rows"] in (default, *rungs), f"[{tag}] rows {p['rows']}")
        if p["rows"] != default:
            log(f"[{tag}] ran the ladder rung of {p['rows']:,} rows, not "
                f"{default:,} ({gpu_line()})")
        check(p["exact_self_match"] == "1/1" and p["batch32_self_match"] == "32/32",
              f"[{tag}] self-matches {p['exact_self_match']}, {p['batch32_self_match']}")
        for field in ("oracle_inclusion_violations", "oracle_score_errors",
                      "oracle_order_errors", "oracle_count_mismatches"):
            check(p[field] == 0, f"[{tag}] {field} = {p[field]}")
        if p["fold"] == 1:
            n_q = int(p["oracle_full_queries"].split()[0])
            check(p["oracle_exact_topk_queries"] == n_q
                  and p["oracle_fold1_seq_mismatches"] == 0,
                  f"[{tag}] exact top-k for {p['oracle_exact_topk_queries']} of {n_q}")
        _add_launches(launches, p)
        out[p["mode"]] = p
    return out


def phase_fold_accuracy():
    """(t3) the fold-accuracy study: the same line on the card as on the
    host (but ``wall_s``) at 50,000 rows, then its default run."""
    on_card = _tool("t3", "fold_accuracy", *ACCURACY_CHECK)
    on_host = _tool("t3", "fold_accuracy", *ACCURACY_CHECK, "--cpu_only")
    on_card.pop("wall_s")
    on_host.pop("wall_s")
    check(on_card == on_host, f"[t3] card {on_card} != host {on_host}")
    return _tool("t3", "fold_accuracy")


def phase_fold_scale(directory):
    """(t4) fold_scale's synthetic library (Morgan-like, ``--and_slabs 4``)
    written under ``directory``, searched at fold 4 dense and bitplane:
    every query exact (the tool exits 1 otherwise)."""
    common = ("--rows", SCALE_ROWS, "--and_slabs", 4, "--dir", directory)
    _tool("t4", "fold_scale", *common, "--generate_only", result=False)
    out = {}
    for mode in ("dense", "bitplane"):
        p = _tool("t4", "fold_scale", *common, "--fold", 4, "--mode", mode)
        check(p["fold"] == 4 and p["exact_self_match"] == "8/8",
              f"[t4] {mode}: {p['exact_self_match']} at fold {p['fold']}")
        out[mode] = p
    return out


def phase_loadtests(directory, launches):
    """(t5) the load tests: ``loadtest`` in full, ``loadtest104`` on (t4)'s
    library (rows cut); every request answered and exact."""
    from gpusimilarity_tpu_torch.tools.loadtest import PASS_REQUESTS, PRESETS

    out = {}
    for preset, args in (("loadtest", ()),
                         ("loadtest104", ("--rows", SCALE_ROWS, "--dir", directory))):
        if args:
            log(f"[t5] {preset} cut from {LOAD104_ROWS:,} to {SCALE_ROWS:,} rows "
                f"({gpu_line()})")
        p = _tool("t5", "loadtest", "--preset", preset, *args, timeout=1200)
        want = 2 * PASS_REQUESTS + sum(PRESETS[preset]["warmup"])
        check(p["failures"] == 0 and p["requests"] == want == p["searches"],
              f"[t5] {preset}: {p['failures']} failures, {p['requests']} requests, "
              f"{p['searches']} searches")
        _add_launches(launches, p)
        out[preset] = p
    return out


def write_flagship_library(path, n_rows):
    """(t6) a synthetic ``.tfsim`` of ``n_rows`` virtual rows whose ids and
    smiles are ``SYN%010d`` (``flagship_server_bench`` reads each result's
    row from its id; distinct smiles, so the server merges no rows): the
    file ``save_native`` writes, its constant string tables then replaced by
    ``fold_scale``'s stored ids (13 bytes a row, smiles hardlinked)."""
    from gpusimilarity_tpu_torch.tools.fold_scale import STRIDED_IDS, write_strided_ids
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
    from gpusimilarity_tpu_torch.utils.strings import ConstantStringTable
    from gpusimilarity_tpu_torch.utils.synth import VirtualFingerprints
    from gpusimilarity_tpu_torch.utils.tfsim import save_native

    save_native(path, FingerprintData(
        dbkey="flagship", bitcount=1024,
        fingerprints=VirtualFingerprints(n_rows, 1024, SEED),
        smiles=ConstantStringTable(b"C", n_rows), ids=ConstantStringTable(b"S", n_rows),
    ))
    write_strided_ids(Path(path), n_rows)
    meta = json.loads((Path(path) / "meta.json").read_text())
    meta["strings"] = {"ids": STRIDED_IDS, "smiles": STRIDED_IDS}
    (Path(path) / "meta.json").write_text(json.dumps(meta))


def phase_flagship(directory, launches):
    """(t6) flagship_server_bench on a synthetic ``.tfsim`` of
    ``FLAGSHIP_ROWS`` rows served at fold 4: every answer exact."""
    path = Path(directory) / "flagship.tfsim"
    t0 = time.monotonic()
    write_flagship_library(path, FLAGSHIP_ROWS)
    log(f"[t6] synthetic .tfsim cut from {FOLDED_ROWS:,} to {FLAGSHIP_ROWS:,} "
        f"rows, stored ids written in {time.monotonic() - t0:.1f}s ({gpu_line()})")
    p = _tool("t6", "flagship_server_bench", "--lib", path, "--fold", 4,
              timeout=1200)
    check(p["exactness_checks_passed"] == "12/12" and p["fold"] == 4,
          f"[t6] {p['exactness_checks_passed']} exact at fold {p['fold']}")
    _add_launches(launches, p)
    return p


# (u1): northstar's rows, cut from its 1,024,000,000: the run writes 45 bytes
# of string blobs a row (4.8 GiB here; 42.9 GiB at full size) and serves them
NORTHSTAR_ROWS = LIB_ROWS
NORTHSTAR_FULL_ROWS = 1_024_000_000
CHEM_ROWS = 200_000  # (u2): chem_scale's compounds, cut from 5,000,000
CHEM_FULL_ROWS = 5_000_000


def phase_northstar(directory, launches):
    """(u1) the north-star run on ``NORTHSTAR_ROWS`` rows at fold 4: every
    query exact, recall against the full-width oracle printed, the server's
    page prewarm logged (its memory-mapped string blobs warmed)."""
    log(f"[u1] northstar cut from {NORTHSTAR_FULL_ROWS:,} to {NORTHSTAR_ROWS:,} "
        f"rows ({gpu_line()})")
    p = _tool("u1", "northstar", "--rows", NORTHSTAR_ROWS, "--fold", 4,
              "--dir", directory, timeout=1200)
    check(p["exactness_checks_passed"] == "12/12" and p["fold"] == 4,
          f"[u1] {p['exactness_checks_passed']} exact at fold {p['fold']}")
    check(p["prewarm"].startswith("prewarmed"), f"[u1] prewarm line {p['prewarm']!r}")
    check(0.0 <= p["recall_at_k"] <= 1.0, f"[u1] recall {p['recall_at_k']}")
    _add_launches(launches, p)
    return p


def phase_chem_scale(directory, launches):
    """(u2) chem_scale's SMILES corpus of ``CHEM_ROWS`` compounds through
    ``cli.createdb``, then every sampled row found as its own top hit."""
    log(f"[u2] chem_scale cut from {CHEM_FULL_ROWS:,} to {CHEM_ROWS:,} compounds "
        f"({gpu_line()})")
    p = _tool("u2", "chem_scale", "--rows", CHEM_ROWS, "--dir", directory)
    check(p["self_match"] == "8/8" and p["rows"] == CHEM_ROWS,
          f"[u2] self_match {p['self_match']} over {p['rows']} rows")
    _add_launches(launches, p)
    return p


def phase_probes(launches):
    """(u3) probe_fold_batch and probe_wordsel, (u4) probe_phase1, all at
    their defaults: every stage and configuration timed, no time under its
    bound (a time under it would be a wrong bound or a lost launch)."""
    from gpusimilarity_tpu_torch.tools.probe_phase1 import CONFIGS

    out = {}
    for tag, name, n_timed in (("u3", "probe_fold_batch", 3), ("u3", "probe_wordsel", 3),
                               ("u4", "probe_phase1", len(CONFIGS))):
        with phase(tag):
            lines = _tool(tag, name, every_line=True)
        timed_lines = [p for p in lines if "ms" in p]
        check(len(timed_lines) == n_timed, f"[{tag}] {name}: {len(timed_lines)} timed lines")
        for p in timed_lines:
            check(p["ms"] >= p["bound_ms"] > 0, f"[{tag}] {name} under its bound: {p}")
        _add_launches(launches, lines[-1])
        out[name] = lines
    return out


def phase_exactdiv():
    """(u5) verify_exactdiv: torch's float32 divide on the card and the
    cutoff predicate over every Tanimoto quotient, 0 mismatches."""
    p = _tool("u5", "verify_exactdiv")
    check(p["mismatches"] == 0 and p["device"].startswith("cuda"), f"[u5] {p}")
    return p


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.monotonic()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(gpu_line())
    from gpusimilarity_tpu_torch.ops import bitplane_phase1 as ph1
    from gpusimilarity_tpu_torch.ops import dense_phase1 as ph2
    from gpusimilarity_tpu_torch.ops import mxu_phase1 as ph3
    from gpusimilarity_tpu_torch.parallel.sharded import build_store

    with phase("a"):
        builds = phase_build()

    with phase("b"):
        rows, store = phase_library(LIB_ROWS, device)
        before = ph1.launch_count()
        max_err, timing = phase_kernel_vs_plain(rows, store, device)
        check(ph1.launch_count() > before, "(b) launched no kernel")

    with phase("c"):
        ph1.reset_launch_count()  # the bitplane main path starts here
        latency = phase_engine(rows, store, device)
        engine_launches = ph1.launch_count()
        check(engine_launches > 0, "(c) launched no kernel")
    with phase("p"):
        phase_profile(rows, store, device)
    with phase("s"):
        # (s) counts the launches of the sharded searches it checks, each read
        # around its search: the unsharded references, the timing loops and
        # the dry run count nowhere
        s_bitplane, s_bitplane_launches = phase_sharded_bitplane(rows, store, device)
        s_launches = {"bitplane_phase1": s_bitplane_launches, "dense_phase1": 0}
    del store
    torch.cuda.empty_cache()

    with phase("m"):
        dstore = build_store(rows)
        before = ph3.launch_count()
        mxu = phase_mxu_vs_plain(rows, dstore, device)
        check(ph3.launch_count() > before, "(m) launched no kernel")
        fold_err = phase_dense_folds(rows, device)
        del rows, dstore
        torch.cuda.empty_cache()
        ph3.reset_launch_count()  # the matrix-product main path: the probe
        probe_records = phase_probe(device)
        probe_launches = ph3.launch_count()
        check(probe_launches > 0, "(m) the probe launched no kernel")
        check(len(probe_records) == 12, f"(m) {len(probe_records)} probe records")
    torch.cuda.empty_cache()

    run_tmp = tempfile.TemporaryDirectory()
    with phase("d"):
        smoke_path = write_server_library(device, SERVER_ROWS, run_tmp.name)
        server_launches, n_requests = phase_server(device, smoke_path, SERVER_ROWS)
        check(server_launches > 0, "(d) launched no kernel")
        check(n_requests >= 4, "fewer than 4 requests answered")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        with phase("e"):
            ph2.reset_launch_count()  # the dense main path starts here
            db = phase_folded_library(device, FOLDED_ROWS, tmp)
            folded_latency = phase_folded_engine(db, device)
            dense_engine_launches = ph2.launch_count()
            check(dense_engine_launches > 0, "(e) launched no dense kernel")
        with phase("b2"):
            before = ph2.launch_count()
            max_err2, timing2 = phase_dense_kernel_vs_plain(db.store.shards[0], device)
            check(ph2.launch_count() > before, "(b2) launched no kernel")
        with phase("p2"):
            phase_profile_dense(db.store.shards[0], device)
        with phase("s"):
            dense_ref = dense_reference(db, device)
        del db
        torch.cuda.empty_cache()
        with phase("s"):
            s_dense, s_dense_launches = phase_sharded_dense(
                Path(tmp) / "enamine.tfsim", dense_ref, device)
            s_launches["dense_phase1"] += s_dense_launches
    torch.cuda.empty_cache()

    with phase("f"):
        folded_server_launches, n_requests = phase_server(
            device, smoke_path, SERVER_ROWS, ("--fold", "4"), fold=4, tag="f",
            kernel="dense_phase1", socket_dir=run_tmp.name,
        )
        check(folded_server_launches > 0, "(f) launched no dense kernel")
        check(n_requests >= 6, "fewer than 6 requests answered")
    torch.cuda.empty_cache()

    with phase("g"):
        fold_launches = phase_bitplane_fold(device, LIB_ROWS)
        check(fold_launches > 0, "(g) launched no kernel")
    torch.cuda.empty_cache()

    with phase("s"):
        for kernel, n in phase_sharded_server_stats(device, smoke_path).items():
            s_launches[kernel] += n
        phase_dryrun(device)
        p50, two_process_launches = phase_two_process_server(
            device, smoke_path, run_tmp.name)
        s_launches["bitplane_phase1"] += two_process_launches
        check(all(s_launches.values()), f"(s) launched no kernel: {s_launches}")
    torch.cuda.empty_cache()

    with phase("h"):
        built = phase_createdb(run_tmp.name)
        entry_points = phase_entrypoints(device, run_tmp.name, smoke_path, built)
    torch.cuda.empty_cache()

    with phase("w"):
        first_requests, w_launches = phase_first_requests(device, smoke_path)
        check(all(w_launches.values()), f"(w) launched no kernel: {w_launches}")
    with phase("x"):
        profiled, x_launches = phase_profiled_servers(device, smoke_path, run_tmp.name)
        check(all(x_launches.values()), f"(x) launched no kernel: {x_launches}")
    run_tmp.cleanup()
    torch.cuda.empty_cache()

    # (t): the measurement entry points, each a subprocess that counts its
    # own launches and reports them (the bench its whole run, the servers
    # their /stats over the requests)
    t_launches = {"bitplane_phase1": 0, "dense_phase1": 0}
    bench_runs = phase_bench(t_launches)
    with tempfile.TemporaryDirectory() as tmp:
        with phase("t3"):
            accuracy = phase_fold_accuracy()
        with phase("t4"):
            scale = phase_fold_scale(tmp)
        with phase("t5"):
            loads = phase_loadtests(tmp, t_launches)
        with phase("t6"):
            flagship = phase_flagship(tmp, t_launches)
    check(all(t_launches.values()), f"(t) launched no kernel: {t_launches}")

    # (u): the port's last tools, each a subprocess reporting its own
    # launches (northstar its server's /stats)
    u_launches = {"bitplane_phase1": 0, "dense_phase1": 0}
    with tempfile.TemporaryDirectory() as tmp:
        with phase("u1"):
            northstar = phase_northstar(tmp, u_launches)
        with phase("u2"):
            chem = phase_chem_scale(tmp, u_launches)
    probes = phase_probes(u_launches)
    with phase("u5"):
        exactdiv = phase_exactdiv()
    check(all(u_launches.values()), f"(u) launched no kernel: {u_launches}")

    log(f"main path kernel launches: bitplane engine {engine_launches}, "
        f"server {server_launches}, fold 4 {fold_launches}, entry points "
        f"{entry_points['launches']}, sharded {s_launches['bitplane_phase1']}, "
        f"first requests {w_launches['bitplane_phase1']}, profiled "
        f"{x_launches['bitplane_phase1']}; "
        f"dense engine {dense_engine_launches}, server {folded_server_launches}, "
        f"sharded {s_launches['dense_phase1']}, first requests "
        f"{w_launches['dense_phase1']}, profiled {x_launches['dense_phase1']}; "
        f"matrix-product probe "
        f"{probe_launches}; measurement entry points (t) bitplane "
        f"{t_launches['bitplane_phase1']}, dense {t_launches['dense_phase1']}; "
        f"last tools (u) bitplane {u_launches['bitplane_phase1']}, dense "
        f"{u_launches['dense_phase1']}")
    split = probes["probe_fold_batch"][-1]
    wordsel = probes["probe_wordsel"][-1]
    log(f"last tools ({gpu_line()}): northstar {northstar['rows']:,} rows fold 4 "
        f"p50 {northstar['value']} ms, warm {northstar['warm_p50_ms']} ms, cold start "
        f"{northstar['cold_start_s']} s (warm-up {northstar['warmup_s']} s), prewarm "
        f"done {northstar['prewarm_done_s']} s "
        f"({northstar['prewarm']}), recall@{northstar['k']} "
        f"{northstar['recall_at_k']} (min {northstar['recall_at_k_min']}, >=0.5 "
        f"{northstar['recall_strong_ge_0.5']}); chem_scale {chem['rows']:,} compounds "
        f"{chem['value']} mol/s, self_match {chem['self_match']}; fold-4 bitplane "
        f"B=32 {split['rows']:,} rows: kernel 1 {split['phase1_ms']} ms (bound "
        f"{split['kernel_bound_ms']}), selection {split['selection_ms']} ms (s1 "
        f"{wordsel['s1_ms']}, s2 +{wordsel['s2_delta_ms']}, s3 "
        f"+{wordsel['s3_delta_ms']}), host and rescore "
        f"{split['host_and_rescore_ms']} ms; exact divide mismatches "
        f"{exactdiv['mismatches']}")
    log(f"measurement entry points ({gpu_line()}): bench "
        + "; ".join(f"{mode} {p['rows']:,} rows {p['value']:.4g} fp/s "
                    f"(vs_baseline {p['vs_baseline']}), p50 B=1 "
                    f"{p['p50_latency_ms']} ms, B=32 {p['batch32_p50_ms']} ms, "
                    f"host rescore {p['host_rescore']}"
                    for mode, p in bench_runs.items())
        + f"; fold accuracy {accuracy['rows']:,} rows: "
        + ", ".join(f"fold {f} {accuracy[f'fold{f}_mismatch_pct']}%" for f in (2, 4, 8))
        + "; fold_scale " + ", ".join(f"{m} p50 {p['value']} ms" for m, p in scale.items())
        + "; " + "; ".join(f"{name} warm {p['warm_qps']} qps, p99 {p['warm_p99_ms']} ms"
                           for name, p in loads.items())
        + f"; flagship p50 {flagship['value']} ms, p99 {flagship['p99_ms']} ms")
    log(f"sharded ({gpu_line()}): bitplane {LIB_ROWS:,} rows, 1 -> "
        f"{S_BITPLANE_SHARDS} shards on one card: "
        + ", ".join(f"B={b} {a:.3f} -> {c:.3f} ms" for b, (a, c) in s_bitplane.items())
        + f"; fold 4 dense {FOLDED_ROWS:,} rows, 1 -> {S_DENSE_SHARDS} shards: "
        + ", ".join(f"B={b} {a:.3f} -> {c:.3f} ms" for b, (a, c) in s_dense.items())
        + "; server B=1 round trip p50, 1 -> 2 processes: HTTP "
        f"{p50[1][0]:.3f} -> {p50[2][0]:.3f} ms, socket {p50[1][1]:.3f} -> "
        f"{p50[2][1]:.3f} ms")
    log(f"first requests ({gpu_line()}), {SERVER_ROWS:,} rows: " + "; ".join(
        f"{r['server']} {'warm-up ' + str(r['warmup_s']) + ' s' if r['warmup'] else 'no warm-up'}"
        f": ready {r['ready_s']} s, first {r['first_ms']} ms, next {W_NEXT} p50 "
        f"{r['next_p50_ms']} ms, burst of {W_BURST} {r['burst_ms']} ms (next "
        f"{W_LATER} p50 {r['later_burst_p50_ms']})"
        for r in first_requests))
    load = profiled["load"]
    log(f"profiled servers ({gpu_line()}), {SERVER_ROWS:,} rows, --no_warmup "
        f"inside a {X_FIRST_MS} ms capture: " + "; ".join(
            f"{label} ready {r['ready_s']} s{' ' + str(r['start_up']) if cold else ''}"
            f", first {r['first_ms']} ms (span {r['first_span']['wall_ms']} ms, "
            f"device {r['first_span']['device_busy_ms']} ms), next {W_NEXT} p50 "
            f"{r['next_p50_ms']} ms (span {r['next_median_span']['wall_ms']} ms, "
            f"device {r['next_median_span']['device_busy_ms']} ms), trace "
            f"{r['trace_bytes']:,} bytes" for label, *_, cold in X_SERVERS
            for r in [profiled[label]])
        + f"; load {load['qps']} qps under a {X_LOAD_MS} ms capture, device busy "
        f"share {load['device_busy_share']}, search span p50 "
        f"{load['search_span_p50_ms']} ms, request time outside any search "
        f"{load['request_outside_search_share']}")
    log(f"entry points ({gpu_line()}): createdb "
        f"{entry_points['createdb_rates'][0]:.0f} compounds/s to .fsim, "
        f"{entry_points['createdb_rates'][1]:.0f} to .tfsim; socket round trip "
        f"p50 {entry_points['socket_p50_ms']:.3f} ms; HTML page "
        f"{entry_points['page_ms'][0]:.3f} ms first, "
        f"{entry_points['page_ms'][1]:.3f} ms memoised")
    log(f"engine latency (ms) unfolded 113,335,291 rows: "
        + ", ".join(f"B={b} k={k}: {ms:.3f}" for (b, k), ms in latency.items()))
    log(f"engine latency (ms) fold 4 1,020,017,472 rows: "
        + ", ".join(f"B={b} k={k}: {ms:.3f}" for (b, k), ms in folded_latency.items()))
    log("phase seconds: " + ", ".join(
        f"({name}) {sec:.1f}" for name, sec in PHASE_SECONDS.items()))
    log(f"total {time.monotonic() - t_start:.1f}s")

    def entry(name, launches, err, times, library_ms=None):
        source, replaces = KERNELS[name]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": times[32][0], "plain_ms": times[32][1],
            "bound_ms": times[32][2][0], "bound_by": times[32][2][1],
            "library_ms": library_ms, "build_s": builds[name].seconds,
            "ms_b1": times[1][0], "plain_ms_b1": times[1][1],
            "bound_ms_b1": times[1][2][0], "bound_by_b1": times[1][2][1],
        }

    mxu_times = {b: (mxu["ms"][b][0], mxu["plain_ms"][b], mxu["ms"][b][1])
                 for b in (1, 32)}
    k3 = entry("mxu_phase1", probe_launches, mxu["max_err"], mxu_times,
               mxu["library_ms"])
    k3.update({
        "ms_b64": mxu["ms"][64][0], "bound_ms_b64": mxu["ms"][64][1][0],
        "ms_b128": mxu["ms"][128][0], "bound_ms_b128": mxu["ms"][128][1][0],
        "dense_ms_same_store": mxu["dense_ms"],
    })
    k1 = entry("bitplane_phase1", engine_launches + server_launches + fold_launches
               + entry_points["launches"] + s_launches["bitplane_phase1"]
               + w_launches["bitplane_phase1"] + x_launches["bitplane_phase1"]
               + t_launches["bitplane_phase1"]
               + u_launches["bitplane_phase1"],
               max_err, timing)
    k1.update({"ms_b128": timing[128][0], "plain_ms_b128": timing[128][1],
               "bound_ms_b128": timing[128][2][0]})
    k2 = entry("dense_phase1", dense_engine_launches + folded_server_launches
               + s_launches["dense_phase1"] + w_launches["dense_phase1"]
               + x_launches["dense_phase1"]
               + t_launches["dense_phase1"] + u_launches["dense_phase1"],
               max(max_err2, fold_err), timing2)
    log(json.dumps({"kernels": [k1, k2, k3]}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
