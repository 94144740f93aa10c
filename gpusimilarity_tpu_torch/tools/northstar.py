"""The north-star run: 1,024,000,000 rows served by the port's server on one
card (twin of the repository's ``tools/northstar.py``)::

    python -m gpusimilarity_tpu_torch.tools.northstar [--rows N] [--fold 8]
        [--k 128] [--queries 12] [--dir D] [--reuse] [--cpu] [--skip_oracle]
        [--oracle_only] [--port P]

The reference's published headline is about 10^9 compounds in fractions of
a second on a multi-GPU box (presentation slide 13: 1,020,017,472 rows at
fold 4 in 451.7 ms on 4x V100). This tool runs 1,024,000,000 rows through
the port's real serving stack on one card:

* writes a ``.tfsim`` through ``utils/tfsim.TfsimStreamWriter``: synthetic
  fingerprints (the counter mixer of ``utils/synth.py``; a stored
  full-width matrix would be 131 GB) with real on-disk strided string
  tables, 32-byte SMILES-like records and 13-byte ``SYN%010d`` ids, 42.9 GiB
  of blobs that every result row reads; the bytes equal the JAX tool's;
* computes the full-width exact oracle of the queries before the server
  starts (``synth.virtual_full_topk`` on the card, cutoffs 0.3 and 0.5; the
  card's cache is emptied after it) and caches it beside the library;
* serves the library with ``python -m gpusimilarity_tpu_torch.cli.server
  LIB --fold F --popless --scan_mode dense --warmup_ks K --warmup_batch 1``
  (fold 8 popless is 15.26 GiB of device words at the default size; the
  JAX tool's warm-up flags), waits for its ``ready on`` line, then for its
  page-prewarm line;
* reports the p50 and warm p50 latency of HTTP searches, cold start,
  prewarm time, the exactness checks (each query's own row first at 1.0,
  every returned score equal to the full-width rescore of its row, scores
  descending) and the recall of the true top k against the oracle.

Each query is a library row (numpy seed 123). The JAX tool's
``--jax_cache_dir`` has no counterpart in the port's server and is left
out. ``cold_start_s`` includes the warm-up, whose seconds (the server's
``warmed up`` line) are ``warmup_s``; ``compile_plus_first_s`` times the
first request after it. The library goes under ``--dir`` (default
``$TMPDIR/tpusim_northstar``). Runs on the card; ``--cpu`` serves with
``--cpu_only`` and computes the oracle on the host. Prints one JSON line,
the JAX tool's record plus ``card``, ``kernel_launches`` (``/stats`` deltas
over the searches) and ``prewarm`` (the server's prewarm log line); exits 1
unless every query passes the exactness checks.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
from pathlib import Path

import numpy as np

from ..utils.synth import _GOLD, _mix32_np
from .loadtest import READY_MARKER, card, free_port, get_json, post_search

GiB = 1 << 30
SEED = 7
ID_W, SMI_W = 13, 32  # "SYN%010d" / 8 four-byte fragments
SLAB_ROWS = 4 << 20  # rows written per append_batch
PREWARM_MARKERS = ("prewarmed", "prewarm skipped", "prewarm not needed")

# 256 SMILES-flavoured 4-byte fragments (16 x 16 two-character tokens):
# real, distinct, page-faulting string data per row, not chemistry
_TOKENS = [
    "C(", "CC", "CN", "CO", "c1", "cc", "N(", "NC",
    "O)", "OC", "S(", "=O", ")C", ")N", "1C", "2c",
]
FRAGS = np.frombuffer(
    "".join(a + b for a in _TOKENS for b in _TOKENS).encode(), np.uint8
).reshape(256, 4)


def smiles_blob(lo: int, hi: int) -> np.ndarray:
    """Strided SMILES records of rows ``[lo, hi)``: uint8 ``(n, 32)``, each
    row 8 fragments drawn by the mixer from its index."""
    idx = np.arange(lo, hi, dtype=np.uint32)
    h = _mix32_np(idx ^ np.uint32(0x51E57A7E))
    sel = np.empty((hi - lo, 8), np.uint32)
    for k in range(8):
        sel[:, k] = _mix32_np(h + np.uint32((k * _GOLD) & 0xFFFFFFFF))
    return FRAGS[sel & 255].reshape(hi - lo, SMI_W)


def ids_blob(lo: int, hi: int) -> np.ndarray:
    """``SYN%010d`` records of rows ``[lo, hi)``: uint8 ``(n, 13)``."""
    n = hi - lo
    out = np.empty((n, ID_W), np.uint8)
    out[:, 0:3] = np.frombuffer(b"SYN", np.uint8)
    x = np.arange(lo, hi, dtype=np.int64)
    for d in range(10):
        out[:, 12 - d] = 48 + (x % 10)
        x //= 10
    return out


def _slab(lo: int, hi: int):
    return smiles_blob(lo, hi), ids_blob(lo, hi)


def build_library(path: Path, rows: int) -> float:
    """Write the library; returns its seconds. The slabs' strings are made
    on a pool of threads (numpy releases the GIL in its loops), at most two
    slabs a thread ahead of the writer, and appended in order."""
    from ..utils.tfsim import TfsimStreamWriter

    t0 = time.monotonic()
    threads = min(8, os.cpu_count() or 1)
    with TfsimStreamWriter(
        path, dbkey="northstar", generator="synthetic-mixer-v1",
        synthetic_seed=SEED, strided={"smiles": SMI_W, "ids": ID_W},
    ) as w, cf.ThreadPoolExecutor(threads) as pool:
        pending = collections.deque()

        def append_oldest():
            lo, slab = pending.popleft()
            w.append_batch(None, *slab.result())
            if lo % (64 << 20) == 0:
                print(f"  strings {lo / rows:.0%} ({time.monotonic() - t0:.0f}s)",
                      file=sys.stderr, flush=True)

        for lo in range(0, rows, SLAB_ROWS):
            pending.append((lo, pool.submit(_slab, lo, min(lo + SLAB_ROWS, rows))))
            if len(pending) > 2 * threads:
                append_oldest()
        while pending:
            append_oldest()
    return time.monotonic() - t0


def compute_oracle(n: int, queries: np.ndarray, k: int, cpu: bool) -> dict:
    """The full-width top k and the >= 0.3 / >= 0.5 counts of every query
    over all ``n`` rows, on the card (or the host); the card's caching
    allocator is emptied afterwards, so the server gets its memory."""
    import torch

    from ..parallel.mesh import resolve_device
    from ..utils import synth

    device = torch.device("cpu") if cpu else resolve_device(None)
    t0 = time.monotonic()
    vals, idx, counts = synth.virtual_full_topk(
        n, queries, k, seed=SEED, cutoffs=(0.3, 0.5), device=device,
        row_chunk=1 << 18,
    )
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "oracle_s": round(time.monotonic() - t0, 1),
        "vals": vals.tolist(),
        "idx": idx.tolist(),
        "count_03": counts[:, 0].tolist(),
        "count_05": counts[:, 1].tolist(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_024_000_000)
    ap.add_argument("--fold", type=int, default=8)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--dir", default=str(Path(tempfile.gettempdir()) / "tpusim_northstar"))
    ap.add_argument("--reuse", action="store_true",
                    help="reuse an existing library directory")
    ap.add_argument("--cpu", action="store_true",
                    help="serve with --cpu_only and compute the oracle on the host")
    ap.add_argument("--skip_oracle", action="store_true")
    ap.add_argument("--oracle_only", action="store_true",
                    help="compute and cache the full-width oracle, then exit")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)

    from ..utils.tfsim import load_native

    lib = Path(args.dir) / f"rows{args.rows}.tfsim"
    port = args.port or free_port()
    build_s = 0.0
    if lib.exists() and args.reuse:
        print(f"reusing {lib}", file=sys.stderr)
    else:
        print(f"building {lib} ({args.rows} rows)", file=sys.stderr)
        lib.parent.mkdir(parents=True, exist_ok=True)
        build_s = build_library(lib, args.rows)
        print(f"built in {build_s:.0f}s", file=sys.stderr)

    data = load_native(lib)
    n = data.count
    full = data.packed_words()  # VirtualWords: rows made on demand
    rng = np.random.default_rng(123)
    q_rows = np.sort(rng.choice(n, size=args.queries, replace=False))
    queries = full[q_rows.astype(np.int64)]

    # the full-width exact oracle, before the server owns the card
    oracle_path = lib.parent / f"oracle_rows{n}_q{args.queries}_k{args.k}.json"
    oracle = None
    if not args.skip_oracle:
        if oracle_path.exists():
            oracle = json.loads(oracle_path.read_text())
            print(f"reusing oracle {oracle_path}", file=sys.stderr)
        else:
            oracle = compute_oracle(n, queries, args.k, args.cpu)
            oracle_path.write_text(json.dumps(oracle))
            print(f"oracle computed in {oracle['oracle_s']}s", file=sys.stderr)
    if args.oracle_only:
        print(json.dumps({"oracle_path": str(oracle_path),
                          "oracle_s": oracle.get("oracle_s") if oracle else None}))
        return 0

    server_cmd = [
        sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server", str(lib),
        "--port", str(port), "--fold", str(args.fold),
        "--popless", "--scan_mode", "dense",
        "--warmup_ks", str(args.k), "--warmup_batch", "1",
    ]
    if args.cpu:
        server_cmd.append("--cpu_only")
    dbname = lib.name[: -len(".tfsim")]
    log_path = Path(tempfile.gettempdir()) / f"northstar_server_{port}.log"
    t_start = time.monotonic()
    with log_path.open("wb") as log_file:
        proc = subprocess.Popen(server_cmd, stdout=log_file, stderr=subprocess.STDOUT)
    try:
        return _measure(args, proc, port, log_path, t_start, dbname, data, full,
                        q_rows, queries, oracle, build_s)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _wait_for(proc, log_path: Path, markers, deadline_s: float) -> str:
    """The first line of the server's log holding one of ``markers``; raises
    if the server exits or the deadline passes first."""
    deadline = time.monotonic() + deadline_s
    while True:
        for line in log_path.read_text(errors="replace").splitlines():
            if any(m in line for m in markers):
                return line
        if proc.poll() is not None:
            raise RuntimeError(f"server died; see {log_path}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"no {markers} in the server log in time; see {log_path}")
        time.sleep(1)


def _measure(args, proc, port, log_path, t_start, dbname, data, full, q_rows,
             queries, oracle, build_s) -> int:
    _wait_for(proc, log_path, (READY_MARKER,), 3600)
    load_s = time.monotonic() - t_start
    warmup = re.search(r"warmed up \S+ \(([0-9.]+)s\)",
                       log_path.read_text(errors="replace"))
    stats0 = get_json(port, "/stats")

    def query(fp_hex, timeout=3600):
        """One search; a 503 (the search outlived the server's deadline) is
        retried until ``timeout`` seconds have passed, then raised."""
        fields = {"fp_hex": fp_hex, "return_count": args.k, "similarity_cutoff": 0,
                  "dbnames": dbname, "dbkeys": data.dbkey}
        deadline = time.monotonic() + timeout
        while True:
            try:
                return post_search(port, fields, timeout=timeout)
            except urllib.error.HTTPError as e:
                if e.code == 503 and time.monotonic() < deadline:
                    time.sleep(5)
                    continue
                raise

    hexes = [np.ascontiguousarray(q).tobytes().hex() for q in queries]
    t0 = time.monotonic()
    query(hexes[0])
    compile_s = time.monotonic() - t0
    # steady state: the string-blob (and rescore-row) page prewarm is done
    prewarm_line = _wait_for(proc, log_path, PREWARM_MARKERS, 3600)
    prewarm_s = time.monotonic() - t_start

    lat, warm_lat, exact_ok = [], [], 0
    recalls, recalls05 = [], []
    for bi, qi in enumerate(map(int, q_rows)):
        t0 = time.monotonic()
        r = query(hexes[bi])
        lat.append(time.monotonic() - t0)
        scores = [row[2] for row in r["results"]]
        ridx = np.array([int(row[0][3:]) for row in r["results"]])  # SYN%010d
        rescored = full.rescore(ridx, np.asarray(queries[bi]))
        # the exactness triple: self match first at 1.0, every score the
        # full-width rescore of its row, scores descending
        if (
            len(ridx) and ridx[0] == qi
            and scores[0] == 1.0
            and np.allclose(scores, rescored, atol=1e-6)
            and scores == sorted(scores, reverse=True)
        ):
            exact_ok += 1
        else:
            print(f"query row {qi}: not exact (top {r['results'][:2]})", file=sys.stderr)
        if oracle is not None:
            got = set(ridx.tolist())
            recalls.append(len(set(oracle["idx"][bi]) & got) / args.k)
            strong = [i for i, v in zip(oracle["idx"][bi], oracle["vals"][bi])
                      if v >= 0.5]
            recalls05.append(len(set(strong) & got) / len(strong) if strong else 1.0)
    for bi in range(len(q_rows)):
        t0 = time.monotonic()
        query(hexes[bi])
        warm_lat.append(time.monotonic() - t0)
    stats = get_json(port, "/stats")
    lib = Path(args.dir) / f"rows{args.rows}.tfsim"
    n = data.count
    p50 = statistics.median(lat)
    record = {
        "metric": "northstar_server_path_p50_ms",
        "value": round(p50 * 1e3, 1),
        "unit": "ms",
        "rows": n,
        "fold": args.fold,
        "popless": True,
        "k": args.k,
        "full_width_gib": round(full.nbytes / GiB, 1),
        "device_gib": round(full.nbytes / args.fold / GiB, 2),
        "string_blob_gib": round(
            sum((lib / f).stat().st_size for f in ("smiles.blob", "ids.blob")) / GiB, 1),
        "exactness_checks_passed": f"{exact_ok}/{args.queries}",
        "fps_per_chip": round(n / p50, 1),
        "min_ms": round(min(lat) * 1e3, 1),
        "warm_p50_ms": round(statistics.median(warm_lat) * 1e3, 1),
        "server_load_s": round(load_s, 1),
        "compile_plus_first_s": round(compile_s, 1),
        "cold_start_s": round(load_s + compile_s, 1),
        "warmup_s": float(warmup.group(1)) if warmup else None,
        "prewarm_done_s": round(prewarm_s, 1),
        "library_build_s": round(build_s, 1),
        "path": "cli.server + HTTP",
    }
    if oracle is not None:
        record.update({
            "oracle": "full-width on-device (synth.virtual_full_topk)",
            "recall_at_k": round(float(np.mean(recalls)), 4),
            "recall_at_k_min": round(float(np.min(recalls)), 4),
            "recall_strong_ge_0.5": round(float(np.mean(recalls05)), 4),
            "oracle_s": oracle.get("oracle_s"),
        })
    record.update({
        "prewarm": prewarm_line.split("tpusimilarity INFO ")[-1],
        "kernel_launches": {
            name: k - stats0["kernel_launches"][name]
            for name, k in stats["kernel_launches"].items()
        },
        "card": card(args.cpu),
    })
    print(json.dumps(record), flush=True)
    return 0 if exact_ok == args.queries else 1


if __name__ == "__main__":
    sys.exit(main())
