"""Load an unfolded virtual library near the card's capacity and search it::

    python -m gpusimilarity_tpu_torch.tools.scale_bitplane [--rows N] [--seed S]

The default is 453,341,072 rows of 1024 bits (Enamine REAL 8/12, the
reference's largest unfolded configuration): 58.0 GB of fingerprints, which
``auto`` resolves to fold 1 and the bitplane scan on an 80 GB card. The
library is a synthetic ``.tfsim`` (rows a function of their index), loaded
through :meth:`~..models.registry.DatabaseRegistry.from_fsim_files` with no
fold or mode given, so the store is built by the engine's streamed upload.
Prints one JSON line: the resolved fold and mode, the store's bytes, the build
seconds, the peak of ``torch.cuda.max_memory_allocated()`` over the build, one
B=1 search's host-clock ms, and whether its answer is exact against a plain
full scan of the same rows (top-k scores, the >= cutoff count, every returned
index carrying its score, the query's own row first at 1.0). Exits 1 if it is
not. The card is the default and the run raises without one; ``--cpu_only``
runs the plain versions on the host at a small ``--rows``, for the tests (no
device memory to report there).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..models.registry import DatabaseRegistry
from ..parallel.mesh import select_device
from ..ops.scan import popcount_rows, score_batch, scores_np
from ..ops.topk import topk_lowest_index
from ..utils.fsim import FingerprintData
from ..utils.strings import ConstantStringTable
from ..utils.synth import (
    VirtualFingerprints,
    pick_query_rows,
    virtual_rows,
    virtual_rows_np,
)
from ..utils.tfsim import save_native
from .probe_b1 import card_line


def full_scan(n_rows, query, k, cutoff, seed, device, chunk=1 << 22):
    """Plain full scan of the virtual library, rows made on the card chunk by
    chunk: ``(top-k scores f32 (k,), count of rows scoring >= cutoff)``."""
    q = torch.from_numpy(query.view(np.int32)).to(device)[None, :]
    qp = popcount_rows(q)
    best = torch.empty(0, dtype=torch.float32, device=device)
    count = 0
    for lo in range(0, n_rows, chunk):
        rows = virtual_rows(lo, min(n_rows, lo + chunk) - lo, 32, seed, device)
        s = score_batch(rows, popcount_rows(rows), q, qp)[0]
        count += int((s >= cutoff).sum())
        both = torch.cat([best, s])
        best, _ = topk_lowest_index(both, min(k, both.shape[0]))
    return best, count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=453_341_072)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--cutoff", type=float, default=0.3)
    ap.add_argument("--cpu_only", action="store_true",
                    help="run the plain versions on the host (tests only)")
    args = ap.parse_args(argv)
    dev = select_device(cpu_only=args.cpu_only)
    on_card = dev.type == "cuda"
    n = args.rows
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "scale.tfsim"
        save_native(path, FingerprintData(
            dbkey="scale", bitcount=1024,
            fingerprints=VirtualFingerprints(n, 1024, args.seed),
            smiles=ConstantStringTable(b"C", n), ids=ConstantStringTable(b"S", n),
        ))
        free0 = peak = None
        if on_card:
            free0, _total = torch.cuda.mem_get_info(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        reg = DatabaseRegistry.from_fsim_files([str(path)], dev)
        if on_card:
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
        build_s = time.monotonic() - t0
    db = reg.get("scale")
    row = int(pick_query_rows(1, n, db.fold_factor, seed=args.seed)[0])
    query = virtual_rows_np(np.array([row]), seed=args.seed)[0]
    db.search(query, args.k, args.cutoff, "scale")  # on the card: builds the kernel
    t0 = time.perf_counter()
    res = db.search(query, args.k, args.cutoff, "scale", return_indices=True)
    search_ms = (time.perf_counter() - t0) * 1e3

    cut = np.float32(args.cutoff)
    want, count = full_scan(n, query, args.k, cut, args.seed, dev)
    want = want[want >= cut].cpu().numpy()
    got = np.asarray(res.scores, np.float32)
    carried = scores_np(virtual_rows_np(np.array(res.indices), seed=args.seed), query)
    exact = bool(
        np.array_equal(got, want) and res.approximate_count == count
        and np.array_equal(got, carried) and res.indices[0] == row and got[0] == 1.0
    )
    print(json.dumps({
        "card": card_line() if on_card else "cpu", "rows": n, "fold_factor": db.fold_factor,
        "scan_mode": db.scan_mode, "store_bytes": db.store.nbytes,
        "free_bytes_before": free0, "build_s": round(build_s, 2),
        "max_memory_allocated": peak, "search_ms_b1": round(search_ms, 3),
        "k": args.k, "cutoff": args.cutoff, "results": len(got),
        "approximate_count": res.approximate_count, "exact_against_full_scan": exact,
    }), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
