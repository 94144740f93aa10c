"""A folded library served end to end through the port's real server (twin
of the repository's ``tools/flagship_server_bench.py``)::

    python -m gpusimilarity_tpu_torch.tools.flagship_server_bench --lib DIR.tfsim
        [--queries N] [--k 128] [--fold 8] [--port P] [--cpu_only]

The reference's headline configurations are 510M rows at fold 8 on 2x
1080Ti (481.8 ms) and 1.02B rows at fold 4 on 4x V100 (451.7 ms)
(presentation slides 12-13). This tool serves ``--lib`` with ``python -m
gpusimilarity_tpu_torch.cli.server --fold F --warmup_ks K --warmup_batch 1``
(the JAX tool's warm-up flags; the folded dense scan with the
k*fold*log2(2*fold) over-fetch and the exact full-width rescore from the
memory map) and queries it over HTTP. ``--lib`` is a ``.tfsim`` whose ids
are ``SYN`` and the row number (``tools/fold_scale --generate_only
--and_slabs 4`` writes one; a synthetic ``.tfsim``, whose rows are a
function of their index, with such ids serves as well).

Each query is a library row (``numpy`` seed 123), and each answer must lead
with that row at 1.0, every score must equal the full-width ``scores_np`` of
the row its id names, and the scores must descend. Runs on the card
(``--cpu_only``: the plain versions on the host). Prints one JSON line:
server load seconds, p50/p99 and a second, warm pass's p50, and exits 1
unless every answer is exact.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from ..ops.scan import scores_np
from ..utils.tfsim import load_native
from .loadtest import card, free_port, get_json, post_search, server_process

GiB = 1 << 30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", required=True, help="the .tfsim library to serve")
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--fold", type=int, default=8)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--cpu_only", action="store_true",
                    help="serve with the plain versions on the host")
    args = ap.parse_args(argv)

    data = load_native(args.lib)
    full = data.packed_words()  # a memory map, or VirtualWords for a synthetic file
    n = data.count
    dbname = Path(args.lib).name
    for suffix in (".tfsim", ".fsim"):
        dbname = dbname.removesuffix(suffix)
    # the JAX tool's warm-up: its one benched k, single queries
    server_args = ["--fold", str(args.fold), "--warmup_ks", str(args.k),
                   "--warmup_batch", "1"] + (["--cpu_only"] if args.cpu_only else [])
    rng = np.random.default_rng(123)
    q_rows = rng.choice(n, size=args.queries, replace=False)

    with server_process(args.lib, args.port or free_port(), server_args) as (port, load_s):
        stats0 = get_json(port, "/stats")

        def query(qi):
            return post_search(port, {
                "fp_hex": np.array(full[qi]).tobytes().hex(),
                "return_count": args.k, "similarity_cutoff": 0,
                "dbnames": dbname, "dbkeys": data.dbkey,
            }, timeout=3600)

        t0 = time.monotonic()
        query(int(q_rows[0]))
        first_s = time.monotonic() - t0
        lat, warm_lat, exact_ok = [], [], 0
        for qi in map(int, q_rows):
            t0 = time.monotonic()
            r = query(qi)
            lat.append(time.monotonic() - t0)
            scores = [row[2] for row in r["results"]]
            rows = np.array([int(row[0][3:]) for row in r["results"]])  # SYN%010d
            oracle = scores_np(np.array(full[rows]), np.array(full[qi])[None, :])[0]
            if (len(rows) and rows[0] == qi and scores[0] == 1.0
                    and np.array_equal(np.asarray(scores, np.float32), oracle)
                    and scores == sorted(scores, reverse=True)):
                exact_ok += 1
            else:
                print(f"query row {qi}: not exact (top {r['results'][:2]})",
                      file=sys.stderr)
        for qi in map(int, q_rows):
            t0 = time.monotonic()
            query(qi)
            warm_lat.append(time.monotonic() - t0)
        stats = get_json(port, "/stats")
    lat_sorted = sorted(lat)
    p50 = statistics.median(lat)
    db_stats = stats["databases"][dbname]
    print(json.dumps({
        "metric": "flagship_server_path_p50_ms",
        "value": round(p50 * 1e3, 3),
        "unit": "ms",
        "rows": n,
        "fold": db_stats["fold_factor"],
        "scan_mode": db_stats["scan_mode"],
        "k": args.k,
        "library_gib": round(n * data.bitcount / 8 / GiB, 1),
        "device_gib": round(db_stats["device_bytes"] / GiB, 1),
        "exactness_checks_passed": f"{exact_ok}/{args.queries}",
        "fps_per_chip": round(n / p50, 1),
        "min_ms": round(lat_sorted[0] * 1e3, 3),
        "p99_ms": round(lat_sorted[int(len(lat) * 0.99)] * 1e3, 3),
        "samples": len(lat),
        "warm_p50_ms": round(statistics.median(warm_lat) * 1e3, 3),
        "server_load_s": round(load_s, 1),
        "first_query_s": round(first_s, 2),
        "cold_start_s": round(load_s + first_s, 1),
        "kernel_launches": {
            name: k - stats0["kernel_launches"][name]
            for name, k in stats["kernel_launches"].items()
        },
        "path": "cli.server + HTTP",
        "card": card(args.cpu_only),
    }), flush=True)
    return 0 if exact_ok == args.queries else 1


if __name__ == "__main__":
    sys.exit(main())
