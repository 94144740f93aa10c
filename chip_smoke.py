"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and no
JAX needed. Phases, in order; any failure raises and the run exits non-zero:

(a) build the three phase-1 kernels from ``gpusimilarity_tpu_torch/csrc``,
    one nvcc per source, started together;
(b) hold the bitplane kernel against its plain PyTorch version, bit for
    bit, on a synthetic library of 113,335,291 rows x 1024 bits (the size
    of Enamine REAL in the reference's presentation) made on the card from
    a seed, at B 1, 32 and 128 (the batches the probe of (m) times it at);
(c) the engine's bitplane search (k 20 and 128, batches of 1 and 32) at
    that size against a plain dense full scan over the packed rows;
(p) where one search's time goes at that size (B 1 and 32, k 128): wall
    time from CUDA events without the profiler, the device's busy time and
    its top ops from torch.profiler, and the idle share;
(m) the matrix-product kernel (kernel 3) on an unfolded dense store of the
    same rows: bit for bit against its plain version and against the dense
    kernel on the same store, int8 and bf16, B 1, 32 and 128, Tanimoto
    cutoffs 0 and 0.35 mixed in one launch and one Tversky launch; its
    times, bound and ``torch._int_mm`` yardstick; then the probe
    (``gpusimilarity_tpu_torch.tools.probe_mxu``) at its default rows, which
    times kernels 3, 2 and 1 at B 1, 32 and 128;
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
    store;
(p2) the breakdown of (p) for a dense fold-4 search;
(f) the server with ``--fold 4`` (auto resolves dense) on (d)'s library,
    checked by (e)'s rules;
(g) one bitplane search at fold 4 on 113,335,291 virtual rows, checked by
    (e)'s rules.

The main path of each kernel is driven with its launch counter reset just
before and read just after: the bitplane kernel in (c), (d) and (g), the
dense kernel in (e) and (f) (the servers' counts come from ``/stats``), the
matrix-product kernel in the probe of (m), which is the one entry point
that runs it. Launches made in (b), (b2), (p), (p2) and (m) before the
probe, to compare or profile, do not count. It prints the card's name and power limit, one JSON line describing
the kernels, the seconds of each phase, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import torch

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
    from gpusimilarity_tpu_torch.utils import kernels

    t0 = time.monotonic()
    builds = kernels.load_all()
    for name, build in builds.items():
        log(f"[a] built {build.path.name} in {build.seconds:.2f}s")
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[a] ptxas {name}: {line.strip()}")
    log(f"[a] {len(builds)} kernels loaded in {time.monotonic() - t0:.2f}s")
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
    """Kernel against plain version, bit for bit, for both Tanimoto
    branches, Tversky, plane buckets 64 and 256, B 1, 32 and 128 (the
    probe's batches) and a zero query. Times at bucket 64: the kernel's
    median, the plain version's one checked run."""
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
    cases = [
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
        if sim == "tanimoto" and cut[0] == 0.0:
            check(int(cnt[0]) == n, f"{name}: cutoff-0 count {int(cnt[0])} != {n}")
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
    unfolded dense store, bit for bit: int8 and bf16, B 1, 32 and 128,
    Tanimoto cutoffs 0 and 0.35 mixed in one launch and a Tversky 0.7/0.3
    launch, a zero query in every batch over 1. Against kernel 2 at full
    size; against the plain version at full size for B=1 and B=32
    Tanimoto, else on the first PLAIN_PREFIX_MXU columns. Times at full
    size: kernel 3 and kernel 2 alone, the plain version at B 1 and 32, and
    ``torch._int_mm`` on the unpacked bits at B=32 (the product alone)."""
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
    for b in (1, 32, 128):
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
            dargs = (store.words, store.popcounts, qt, qp, ct, abt, n, 256, sim)
            dbm, dcnt = ph2.dense_phase1(*dargs)
            pargs = (store.words[:, :cols], store.popcounts[:cols], qbits, qp, ct,
                     abt, 0, 256, n, sim)
            (pbm, pcnt), p_ms = timed(lambda: ph3.mxu_phase1_plain(*pargs), device)
            if full_plain:
                results["plain_ms"].setdefault(b, p_ms)
            where = "all rows" if full_plain else f"the first {cols:,} columns"
            for int8 in (True, False):
                name = f"B{b} {'int8' if int8 else 'bf16'} {sim}"
                bm, cnt = ph3.mxu_phase1(store.words, store.popcounts, qbits, qp, ct,
                                         abt, 0, 256, n, sim, int8)
                sync(device)
                check(torch.equal(bm.view(torch.int32), dbm.view(torch.int32)),
                      f"{name}: block maxima differ from the dense kernel's")
                check(torch.equal(cnt, dcnt), f"{name}: counts differ from the dense kernel's")
                if full_plain:
                    kbm, kcnt = bm, cnt
                else:
                    kbm, kcnt = ph3.mxu_phase1(*pargs, int8)
                finite = torch.isfinite(kbm) & torch.isfinite(pbm)
                err = (kbm[finite] - pbm[finite]).abs().max().item()
                results["max_err"] = max(results["max_err"], err)
                check(torch.isneginf(kbm).eq(torch.isneginf(pbm)).all().item(),
                      f"{name}: -inf pattern differs from the plain version")
                check(torch.equal(kbm.view(torch.int32), pbm.view(torch.int32)),
                      f"{name}: block maxima not bit-identical to the plain "
                      f"version (max abs err {err})")
                check(torch.equal(kcnt, pcnt), f"{name}: counts differ from the plain version")
                if sim == "tanimoto":
                    check(int(cnt[0]) == n, f"{name}: cutoff-0 count {int(cnt[0])} != {n}")
                if b > 1:
                    check(bm[-1].max().item() == 0.0, f"{name}: zero query not 0")
                log(f"[m] {name}: block maxima and counts bit-identical to the dense "
                    f"kernel's over all rows and to the plain version's over {where} "
                    f"(counts[0]={int(cnt[0])}, max abs err {err})")
                if sim == "tanimoto":
                    args = (store.words, store.popcounts, qbits, qp, ct, abt, 0, 256,
                            n, sim, int8)
                    k_ms = median_ms(lambda: ph3.mxu_phase1_kernel(*args), device, reps)
                    bound = mxu_bound(n_cols, b, 256, int8)
                    results["ms"][(b, int8)] = (k_ms, bound)
                    log(f"[m] B={b} {'int8' if int8 else 'bf16'} at {n:,} rows: kernel "
                        f"median {k_ms:.3f} ms, bound {bound[0]:.3f} ms by {bound[1]} "
                        f"({bound[0] / k_ms:.3f} of it)")
            if sim == "tanimoto":
                d_ms = median_ms(lambda: ph2.dense_phase1_kernel(*dargs), device, reps)
                results["dense_ms"][b] = d_ms
                log(f"[m] B={b} dense kernel on the same store: median {d_ms:.3f} ms; "
                    f"plain mxu version {p_ms:.3f} ms over {where}")
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
    """(m) The probe's functions at its default rows: kernel 3 (int8 and
    bf16) and kernel 2 on one dense store, kernel 1 on a bitplane store,
    B 1, 32 and 128; one JSON line per configuration."""
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


def phase_server(device, n_rows, server_args=(), fold=1, tag="d",
                 kernel="bitplane_phase1"):
    """Serve a written .fsim through the CLI and check its answers; returns
    the launches of ``kernel`` the server counted for them (from /stats,
    zero when the server starts) and the number of requests."""
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows
    from gpusimilarity_tpu_torch.utils.fsim import FingerprintData, write_fsim

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = random_rows(n_rows, gen, device)
    pops = popcount_rows(rows).to(torch.int16)
    fps = rows.cpu().numpy().view(np.uint8).reshape(n_rows, 128)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "smoke.fsim"
        t0 = time.monotonic()
        write_fsim(path, FingerprintData(
            dbkey="smoke", bitcount=1024, fingerprints=fps,
            smiles=[f"C{i}".encode() for i in range(n_rows)],
            ids=[f"SMK{i:08d}".encode() for i in range(n_rows)],
        ))
        log(f"[{tag}] wrote {n_rows:,}-row .fsim in {time.monotonic() - t0:.2f}s")
        port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p
        )
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server",
             str(path), "--port", str(port), "--batch_window_ms", "50",
             *server_args],
            cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True,
        )
        lines: list[str] = []
        ready = threading.Event()

        def pump():
            for line in proc.stderr:
                lines.append(line)
                if "ready on" in line:
                    ready.set()

        threading.Thread(target=pump, daemon=True).start()
        try:
            while not ready.wait(1.0):
                check(proc.poll() is None,
                      "server exited:\n" + "".join(lines[-30:]))
                check(time.monotonic() - t0 < 600, "server not ready in 600 s")
            log(f"[{tag}] server ready in {time.monotonic() - t0:.2f}s")
            stats = _get(port, "/stats")
            db_stats = stats["databases"]["smoke"]
            log(f"[{tag}] /stats: fold {db_stats['fold_factor']}, scan mode "
                f"{db_stats['scan_mode']}, {db_stats['device_bytes']:,} device bytes")
            check(db_stats["fold_factor"] == fold, f"server fold {db_stats['fold_factor']}")
            launches0 = stats["kernel_launches"][kernel]
            count = _check_requests(port, rows, pops, device, fold, tag)
            stats = _get(port, "/stats")
            launches = stats["kernel_launches"][kernel] - launches0
            log(f"[{tag}] answered {count} requests; server {kernel} launches "
                f"{launches}; /stats searches {stats['searches']}")
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
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


def _check_requests(port, rows, pops, device, fold=1, tag="d"):
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.ops.scan import (
        full_scan_topk,
        popcount_rows,
        scores_np,
    )
    from gpusimilarity_tpu_torch.serve.server import smiles_to_query_words

    n = rows.shape[0]
    rng = np.random.default_rng(SEED + 3)
    picks = [int(i) for i in rng.integers(0, n, 4)]
    if fold > 1:
        folded = fold_words(rows, fold)
        fpops = popcount_rows(folded)

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
        sim = form.get("similarity", "tanimoto")
        ab = (float(form.get("alpha", 1)), float(form.get("beta", 1)))
        k, cut = int(form["return_count"]), float(form.get("similarity_cutoff", 0))
        cut_t = torch.tensor([cut], dtype=torch.float32, device=device)
        got = np.array([r[2] for r in reply["results"]], np.float32)
        check(all(len(r) == 3 and isinstance(r[0], str) and isinstance(r[1], str)
                  for r in reply["results"]), "result rows are [id, smiles, score]")
        idx = [int(cid[3:]) for cid, _smi, _score in reply["results"]]
        for i, (_cid, smi, _score) in zip(idx, reply["results"]):
            check(smi == f"C{i}", "id and smiles disagree")
        what = form.get("smiles") or "fp_hex"
        if fold == 1:
            v, _i, c = full_scan_topk(rows, pops, q[None, :], k, cut_t, sim, *ab)
            want = v[0][v[0] >= cut].cpu().numpy()
            check(np.array_equal(got, want), f"{what} k={k}: scores differ from "
                  "the full scan")
            check(reply["approximate_count"] == int(c[0]), "approximate count differs")
            if "fp_hex" in form:
                check(got[0] == 1.0, "self-query not 1.0 at rank 0")
        else:
            _v, _i, c = full_scan_topk(
                folded, fpops, fold_words(q[None, :], fold), 1, cut_t, sim, *ab
            )
            full = scores_np(
                rows[idx].cpu().numpy().view(np.uint32),
                q.cpu().numpy().view(np.uint32), sim, *ab,
            )
            _check_folded(tag, f"{what} {sim} k={k}", got, idx, int(c[0]),
                          reply["approximate_count"], full, cut,
                          picks[ri] if "fp_hex" in form else None)
        log(f"[{tag}] {what} {sim} k={k} cut={cut}: {len(got)} results, "
            f"approximate_count {reply['approximate_count']}, exact against "
            + ("the full scan" if fold == 1 else "full-width rescore and the "
               "folded full scan"))
    wrong = _post(port, {**requests[0][1], "dbkeys": "wrong"})
    check(wrong["results"] == [] and wrong["approximate_count"] == 0,
          "wrong dbkey must return no results")
    log(f"[{tag}] wrong dbkey: results []")
    return len(requests) + 1


def phase_folded_library(device, n_rows, tmp):
    """(e) Write a synthetic .tfsim and load it through the registry with
    no fold or mode given."""
    from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
    from gpusimilarity_tpu_torch.parallel.mesh import available_device_memory
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
    free = available_device_memory(device)
    log(f"[e] synthetic .tfsim of {n_rows:,} rows x 1024 bits "
        f"({n_rows * 128 / 1e9:.2f} GB at full width); free device memory "
        f"{free / 1e9 if free else float('nan'):.2f} GB")
    t0 = time.monotonic()
    reg = DatabaseRegistry.from_fsim_files([str(path)], device)
    sync(device)
    build_s = time.monotonic() - t0
    db = reg.get("enamine")
    free = available_device_memory(device)
    log(f"[e] registry resolved fold {db.fold_factor}, scan mode {db.scan_mode}; "
        f"store {db.store.nbytes:,} bytes ({db.store.word_count} words/row, "
        f"popcounts {'no' if db.store.popcounts is None else 'yes'}); built in "
        f"{build_s:.2f}s; free device memory "
        f"{free / 1e9 if free else float('nan'):.2f} GB")
    check(db.fold_factor == 4 and db.scan_mode == "dense",
          f"expected fold 4 dense, got fold {db.fold_factor} {db.scan_mode}")
    return db


def full_width_topk(n_rows, queries_full, k, seed, device, chunk=1 << 18):
    """Exact full-width lowest-index top-k of the virtual library: rows made
    on the card chunk by chunk, intersection counts as a float32 product of
    0/1 bit matrices (exact: sums <= 1024). The recall oracle."""
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows, similarity_from_counts
    from gpusimilarity_tpu_torch.ops.topk import topk_lowest_index
    from gpusimilarity_tpu_torch.utils.synth import virtual_rows

    shifts = torch.arange(32, dtype=torch.int32, device=device)

    def bits(words):
        return ((words[:, :, None] >> shifts) & 1).reshape(len(words), -1).float()

    q = torch.from_numpy(queries_full.view(np.int32)).to(device)
    qbits, qpops = bits(q), popcount_rows(q)
    b = len(q)
    best_v = torch.empty((b, 0), device=device)
    best_i = torch.empty((b, 0), dtype=torch.int64, device=device)
    for lo in range(0, n_rows, chunk):
        hi = min(n_rows, lo + chunk)
        r = virtual_rows(lo, hi - lo, 32, seed, device)
        common = (bits(r) @ qbits.T).T.to(torch.int32)  # (B, chunk)
        s = similarity_from_counts(common, popcount_rows(r), qpops)
        v = torch.cat([best_v, s], dim=1)
        i = torch.cat([best_i, torch.arange(lo, hi, device=device).expand(b, -1)], dim=1)
        best_v, pos = topk_lowest_index(v, min(k, v.shape[1]), tiebreak=i)
        best_i = torch.gather(i, 1, pos)
    return best_v, best_i


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
    from gpusimilarity_tpu_torch.utils.synth import pick_query_rows, virtual_rows_np

    n, store, fold = db.count, db.store, db.fold_factor
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
    pdb._store = DenseStore(words=store.words, popcounts=None, n_valid=n)
    pdb.popless = True
    pres = pdb.search_batch(qfull, 128, cut32, db.dbkey, return_indices=True)
    for p_r, r in zip(pres, results[(32, 128)]):
        check((p_r.scores, p_r.indices, p_r.approximate_count)
              == (r.scores, r.indices, r.approximate_count),
              "popless search differs from the search with popcounts")
    log("[e] popless search B=32 k=128: identical to the search with popcounts")

    t0 = time.monotonic()
    tv, ti = full_width_topk(n, qfull, 20, SEED, device)
    sync(device)
    got = db.search_batch(qfull, 20, 0.0, db.dbkey, return_indices=True)
    hits = [len(set(r.indices) & set(ti[qi].tolist())) / 20 for qi, r in enumerate(got)]
    log(f"[e] recall@20 against the full-width top 20 (B=32, cutoff 0): mean "
        f"{statistics.mean(hits):.4f}, min {min(hits):.2f}; full-width oracle in "
        f"{time.monotonic() - t0:.2f}s")
    return latency


def phase_dense_kernel_vs_plain(store, device, reps=(20, 10)):
    """(b2) The dense kernel against its plain version, bit for bit, in
    (e)'s store: Tanimoto cutoffs 0 and 0.35 (mixed in one launch),
    Tversky 0.7/0.3, popless, B 1 and 32, a zero query."""
    from gpusimilarity_tpu_torch.ops import dense_phase1 as ph2
    from gpusimilarity_tpu_torch.ops.fold import fold_words
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np
    from gpusimilarity_tpu_torch.tools.probe_mxu import dense_bound
    from gpusimilarity_tpu_torch.utils.synth import pick_query_rows, virtual_rows_np

    n = store.n_valid
    fold = 32 // store.word_count
    rows = pick_query_rows(31, n, fold, seed=SEED, rng_seed=SEED)
    q32 = np.concatenate([
        fold_words(virtual_rows_np(rows, seed=SEED), fold),
        np.zeros((1, store.word_count), np.uint32),
    ])  # 31 library rows + a zero query
    mixed = np.where(np.arange(32) % 2 == 0, 0.0, 0.35).astype(np.float32)
    prefix = min(PLAIN_PREFIX_COLS, store.n_padded)
    cases = [
        # name, queries, cutoffs, similarity, alpha/beta, popless, columns
        ("B1 tanimoto cut0.35", q32[:1], [0.35], "tanimoto", (1, 1), False, None),
        ("B1 tversky cut0.35", q32[:1], [0.35], "tversky", (0.7, 0.3), False, None),
        ("B1 popless cut0", q32[:1], [0.0], "tanimoto", (1, 1), True, None),
        ("B32 tanimoto cut0/0.35", q32, mixed, "tanimoto", (1, 1), False, None),
        ("B32 tversky cut0.35", q32, [0.35] * 32, "tversky", (0.7, 0.3), False, prefix),
        ("B32 popless cut0/0.35", q32, mixed, "tanimoto", (1, 1), True, prefix),
    ]
    max_err, timing = 0.0, {}
    for name, q, cut, sim, ab, popless, cols in cases:
        words = store.words if cols is None else store.words[:, :cols]
        pops = None if popless else store.popcounts[:words.shape[1]]
        args = (
            words, pops, torch.from_numpy(q.view(np.int32)).to(device),
            torch.from_numpy(popcount_rows_np(q)).to(device),
            torch.tensor(cut, dtype=torch.float32, device=device),
            torch.tensor(ab, dtype=torch.float32, device=device), n, 256, sim,
        )
        bm, cnt = ph2.dense_phase1(*args)
        (pbm, pcnt), plain_ms = timed(lambda: ph2.dense_phase1_plain(*args), device)
        finite = torch.isfinite(bm) & torch.isfinite(pbm)
        err = (bm[finite] - pbm[finite]).abs().max().item()
        max_err = max(max_err, err)
        check(torch.isneginf(bm).eq(torch.isneginf(pbm)).all().item(),
              f"{name}: -inf pattern differs")
        check(torch.equal(bm.view(torch.int32), pbm.view(torch.int32)),
              f"{name}: block maxima not bit-identical (max abs err {err})")
        check(torch.equal(cnt, pcnt), f"{name}: counts differ")
        if cut[0] == 0.0:
            want = min(n, words.shape[1])
            check(int(cnt[0]) == want, f"{name}: cutoff-0 count {int(cnt[0])} != {want}")
        if len(q) == 32:
            check(bm[31].max().item() == 0.0, f"{name}: zero query not 0")
        where = "all rows" if cols is None else f"the first {cols:,} columns"
        log(f"[b2] {name} over {where}: block maxima and counts bit-identical "
            f"(counts[0]={int(cnt[0])}, max abs err {err}); plain {plain_ms:.3f} ms")
        if cols is None and not popless and sim == "tanimoto":
            b = len(q)
            k_ms = median_ms(lambda: ph2.dense_phase1_kernel(*args), device,
                             reps[0] if b == 1 else reps[1])
            timing[b] = (k_ms, plain_ms,
                         dense_bound(words.shape[1], store.word_count, b, 256))
            log(f"[b2] B={b} at {n:,} rows: kernel median {k_ms:.3f} ms (one "
                f"launch and its zeroed counts), plain {plain_ms:.3f} ms (one run)")
    return max_err, timing


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
        f"{db.store.planes.shape[0]} planes, {db.store.nbytes:,} bytes, built in "
        f"{time.monotonic() - t0:.2f}s")
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
    del store
    torch.cuda.empty_cache()

    with phase("m"):
        dstore = build_store(rows)
        before = ph3.launch_count()
        mxu = phase_mxu_vs_plain(rows, dstore, device)
        check(ph3.launch_count() > before, "(m) launched no kernel")
        del rows, dstore
        torch.cuda.empty_cache()
        ph3.reset_launch_count()  # the matrix-product main path: the probe
        probe_records = phase_probe(device)
        probe_launches = ph3.launch_count()
        check(probe_launches > 0, "(m) the probe launched no kernel")
        check(len(probe_records) == 12, f"(m) {len(probe_records)} probe records")
    torch.cuda.empty_cache()

    with phase("d"):
        server_launches, n_requests = phase_server(device, SERVER_ROWS)
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
            max_err2, timing2 = phase_dense_kernel_vs_plain(db.store, device)
            check(ph2.launch_count() > before, "(b2) launched no kernel")
        with phase("p2"):
            phase_profile_dense(db.store, device)
        del db
    torch.cuda.empty_cache()

    with phase("f"):
        folded_server_launches, n_requests = phase_server(
            device, SERVER_ROWS, ("--fold", "4"), fold=4, tag="f",
            kernel="dense_phase1",
        )
        check(folded_server_launches > 0, "(f) launched no dense kernel")
        check(n_requests >= 4, "fewer than 4 requests answered")
    torch.cuda.empty_cache()

    with phase("g"):
        fold_launches = phase_bitplane_fold(device, LIB_ROWS)
        check(fold_launches > 0, "(g) launched no kernel")

    log(f"main path kernel launches: bitplane engine {engine_launches}, "
        f"server {server_launches}, fold 4 {fold_launches}; dense engine "
        f"{dense_engine_launches}, server {folded_server_launches}; "
        f"matrix-product probe {probe_launches}")
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
            "bound_ms_b1": times[1][2][0],
        }

    mxu_times = {b: (mxu["ms"][(b, True)][0], mxu["plain_ms"][b],
                     mxu["ms"][(b, True)][1]) for b in (1, 32)}
    k3 = entry("mxu_phase1", probe_launches, mxu["max_err"], mxu_times,
               mxu["library_ms"])
    k3.update({
        "ms_b128": mxu["ms"][(128, True)][0],
        "bound_ms_b128": mxu["ms"][(128, True)][1][0],
        "ms_bf16": {b: mxu["ms"][(b, False)][0] for b in (1, 32, 128)},
        "dense_ms_same_store": mxu["dense_ms"],
    })
    k1 = entry("bitplane_phase1", engine_launches + server_launches + fold_launches,
               max_err, timing)
    k1.update({"ms_b128": timing[128][0], "plain_ms_b128": timing[128][1],
               "bound_ms_b128": timing[128][2][0]})
    log(json.dumps({"kernels": [
        k1,
        entry("dense_phase1", dense_engine_launches + folded_server_launches,
              max_err2, timing2),
        k3,
    ]}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
