"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and no
JAX needed. Phases, in order; any failure raises and the run exits non-zero:

(a) build the phase-1 kernel from ``gpusimilarity_tpu_torch/csrc``;
(b) hold the kernel against its plain PyTorch version, bit for bit, on a
    synthetic library of 113,335,291 rows x 1024 bits (the size of Enamine
    REAL in the reference's presentation) made on the card from a seed;
(c) the engine's bitplane search (k 20 and 128, batches of 1 and 32) at
    that size against a plain dense full scan over the packed rows;
(p) where one search's time goes at that size (B 1 and 32, k 128): wall
    time from CUDA events without the profiler, the device's busy time and
    its top ops from torch.profiler, and the idle share;
(d) the HTTP server (``python -m gpusimilarity_tpu_torch.cli.server``) on a
    1,618,358-row ``.fsim`` (the ChEMBL size of the same slide), answering
    fp_hex self-queries (two of them concurrent, one Tversky), a SMILES
    query and a wrong-key query, checked against the plain full scan.

The main path is (c) and (d): the kernel's launch counter is reset just
before (c) and read after (c) and from the server's ``/stats`` after (d);
launches made in (b) to compare the kernel with its plain version do not
count. It prints the card's name and power limit, one JSON line describing
the kernel, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

ROOT = Path(__file__).resolve().parent
LIB_ROWS = 113_335_291
SERVER_ROWS = 1_618_358
SEED = 2026
KERNEL_SOURCE = "gpusimilarity_tpu_torch/csrc/bitplane_phase1.cu"
REPLACES = "gpusimilarity_tpu/ops/pallas_bitplane.py:53"


def log(msg: str) -> None:
    print(msg, flush=True)


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


def median_ms(fn, device, reps: int) -> float:
    """Median wall time of ``fn`` in ms, each run ending in a synchronize
    (CUDA events around each run on a card)."""
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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
    build = kernels.load("bitplane_phase1")
    log(f"[a] built {build.path.name} in {build.seconds:.2f}s "
        f"(load total {time.monotonic() - t0:.2f}s)")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[a] ptxas: {line.strip()}")
    return build


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


def phase_kernel_vs_plain(rows, store, device, reps=(20, 3)):
    """Kernel against plain version, bit for bit, for both Tanimoto
    branches, Tversky, plane buckets 64 and 256 and a zero query."""
    from gpusimilarity_tpu_torch.ops.bitplane import query_plane_indices
    from gpusimilarity_tpu_torch.ops.bitplane_phase1 import (
        bitplane_phase1_batched,
        bitplane_phase1_kernel,
        bitplane_phase1_plain,
    )
    from gpusimilarity_tpu_torch.ops.scan import popcount_rows_np

    n = store.n_valid
    pops = store.popcounts[:n]
    idx = pick_queries(rows, pops, n, 31, 64, SEED)
    lib_q = rows[idx].cpu().numpy().view(np.uint32)
    q32 = np.concatenate([lib_q, np.zeros((1, 32), np.uint32)])  # + zero query
    q1 = q32[:1]
    mixed = np.where(np.arange(32) % 2 == 0, 0.0, 0.35).astype(np.float32)
    cases = [
        ("B1 b64 tanimoto cut0", q1, [0.0], "tanimoto", (1, 1), 64),
        ("B1 b64 tanimoto cut0.35", q1, [0.35], "tanimoto", (1, 1), 64),
        ("B1 b64 tversky cut0.35", q1, [0.35], "tversky", (0.7, 0.3), 64),
        ("B32 b64 tanimoto cut0", q32, [0.0] * 32, "tanimoto", (1, 1), 64),
        ("B32 b64 tanimoto cut0/0.35", q32, mixed, "tanimoto", (1, 1), 64),
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
        pcolmax, pcnt = bitplane_phase1_plain(*args, n, sim)
        sync(device)
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
        if len(q) == 32:
            check(colmax[31].max().item() == 0.0, f"{name}: zero query not 0")
        log(f"[b] {name}: colmax and counts bit-identical "
            f"(counts[0]={int(cnt[0])}, max abs err {err})")
        if bucket == 64 and sim == "tanimoto" and name.endswith("0.35"):
            b = len(q)
            k_ms = median_ms(
                lambda: bitplane_phase1_kernel(*args, n, sim), device, reps[0]
            )
            w_ms = median_ms(
                lambda: bitplane_phase1_batched(*args, n, sim), device, reps[0]
            )
            p_ms = median_ms(
                lambda: bitplane_phase1_plain(*args, n, sim), device, reps[1]
            )
            timing[b] = (k_ms, p_ms)
            log(f"[b] B={b} bucket 64 at {n:,} rows: kernel median "
                f"{k_ms:.3f} ms (one launch and its zeroed counts), wrapper "
                f"median {w_ms:.3f} ms (kernel, allocation and block max), "
                f"plain median {p_ms:.3f} ms")
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


def phase_profile(rows, store, device, reps=10):
    """Where a search's time goes, by device op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        for _ in range(3):
            bitplane_local_topk(*args)
        wall = median_ms(lambda: bitplane_local_topk(*args), device, reps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                bitplane_local_topk(*args)
            sync(device)
        ops = sorted(
            (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
            key=lambda e: -e.self_device_time_total,
        )
        if not ops:
            log(f"[p] B={b} k=128 bucket {bucket}: wall {wall:.3f} ms per "
                "search; the profiler saw no device ops, busy time not measured")
            continue
        busy = sum(e.self_device_time_total for e in ops) / reps / 1e3
        log(f"[p] B={b} k=128 bucket {bucket}: wall {wall:.3f} ms per search "
            f"(median, CUDA events, no profiler); device busy {busy:.3f} ms per search "
            f"(profiler, {reps} searches); idle share {1 - busy / wall:.3f}")
        for e in ops[:8]:
            log(f"[p]   {e.self_device_time_total / reps / 1e3:.3f} ms "
                f"x{e.count / reps:g}  {e.key[:90]}")


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


def phase_server(device, n_rows, server_args=()):
    """Serve a written .fsim through the CLI and check its answers."""
    from gpusimilarity_tpu_torch.ops.scan import full_scan_topk, popcount_rows
    from gpusimilarity_tpu_torch.serve.server import smiles_to_query_words
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
        log(f"[d] wrote {n_rows:,}-row .fsim in {time.monotonic() - t0:.2f}s")
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
            log(f"[d] server ready in {time.monotonic() - t0:.2f}s")
            launches0 = _get(port, "/stats")["kernel_launches"]["bitplane_phase1"]
            count = _check_requests(port, rows, pops, smiles_to_query_words,
                                    full_scan_topk, device)
            stats = _get(port, "/stats")
            launches = stats["kernel_launches"]["bitplane_phase1"] - launches0
            log(f"[d] answered {count} requests; server kernel launches "
                f"{launches}; /stats searches {stats['searches']}")
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        return launches, count


def _check_requests(port, rows, pops, smiles_to_query_words, full_scan_topk,
                    device):
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
    for (q, form), reply in zip(requests, replies):
        check(set(reply) >= {"approximate_count", "results"}, "reply shape")
        sim = form.get("similarity", "tanimoto")
        ab = (float(form.get("alpha", 1)), float(form.get("beta", 1)))
        k, cut = int(form["return_count"]), float(form.get("similarity_cutoff", 0))
        v, _i, c = full_scan_topk(
            rows, pops, q[None, :], k,
            torch.tensor([cut], dtype=torch.float32, device=device), sim, *ab,
        )
        want = v[0][v[0] >= cut].cpu().numpy()
        got = np.array([r[2] for r in reply["results"]], np.float32)
        check(all(len(r) == 3 and isinstance(r[0], str) and isinstance(r[1], str)
                  for r in reply["results"]), "result rows are [id, smiles, score]")
        check(np.array_equal(got, want), f"{form.get('smiles') or 'fp_hex'} "
              f"k={k}: scores differ from the full scan")
        check(reply["approximate_count"] == int(c[0]), "approximate count differs")
        for cid, smi, score in reply["results"]:
            i = int(cid[3:])
            check(smi == f"C{i}", "id and smiles disagree")
        if "fp_hex" in form:
            check(got[0] == 1.0, "self-query not 1.0 at rank 0")
        log(f"[d] {form.get('smiles') or 'fp_hex'} {sim} k={k} cut={cut}: "
            f"{len(got)} results, approximate_count {reply['approximate_count']}, "
            "exact against the full scan")
    wrong = _post(port, {**requests[0][1], "dbkeys": "wrong"})
    check(wrong["results"] == [] and wrong["approximate_count"] == 0,
          "wrong dbkey must return no results")
    log("[d] wrong dbkey: results []")
    return len(requests) + 1


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

    build = phase_build()

    rows, store = phase_library(LIB_ROWS, device)
    before = ph1.launch_count()
    max_err, timing = phase_kernel_vs_plain(rows, store, device)
    check(ph1.launch_count() > before, "(b) launched no kernel")

    ph1.reset_launch_count()  # the main path starts here
    latency = phase_engine(rows, store, device)
    engine_launches = ph1.launch_count()
    check(engine_launches > 0, "(c) launched no kernel")
    phase_profile(rows, store, device)
    del rows, store
    torch.cuda.empty_cache()

    server_launches, n_requests = phase_server(device, SERVER_ROWS)
    check(server_launches > 0, "(d) launched no kernel")
    check(n_requests >= 4, "fewer than 4 requests answered")
    log(f"main path kernel launches: engine {engine_launches}, "
        f"server {server_launches}")
    log(f"total {time.monotonic() - t_start:.1f}s; engine latency (ms) "
        + ", ".join(f"B={b} k={k}: {ms:.3f}" for (b, k), ms in latency.items()))

    k_ms, p_ms = timing[32]
    log(json.dumps({"kernels": [{
        "name": "bitplane_phase1", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": engine_launches + server_launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "build_s": build.seconds, "ms_b1": timing[1][0],
        "plain_ms_b1": timing[1][1],
    }]}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
