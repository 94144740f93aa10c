"""Where a batched folded bitplane search spends its device time (twin of the
repository's ``tools/probe_fold_batch.py``)::

    python -m gpusimilarity_tpu_torch.tools.probe_fold_batch [--rows N]
        [--fold F] [--batch B] [--k 128] [--repeats 5] [--seed 11] [--cpu_only]

The bench's default cell is a fold-4 bitplane search, and its time is not
split: kernel 1 against the selection after it and the host's part. This
probe builds a virtual library of ``--rows`` (default 369,098,752 = 352Mi)
rows on the card from ``--seed``, loaded through ``FingerprintDB`` at
``--fold`` in bitplane mode, picks ``--batch`` library rows as queries
(``synth.pick_query_rows``) and times, on the same store and queries:

1. kernel 1 alone (``ops/bitplane_phase1.bitplane_phase1_batched``);
2. the whole device search, ``parallel/sharded.bitplane_local_topk``: kernel
   1, then the block, word and column selection to the engine's fetch width
   (k x fold x log2(2 x fold), rounded up to a power of two);
3. the engine's ``search_batch`` of the full-width queries: the query fold
   and plane lists on the host, (2), the candidates' copy to the host and
   their exact full-width rescore there.

Each is the median of ``--repeats`` calls between CUDA events (the host
work of (3) lies between them), beside a same-run floor (one trivial
launch) and the byte bound of kernel 1 (``probe_mxu.bitplane_bound``: each
plane the batch reads, once, over 3.35 TB/s), the least any of the three
could take. One JSON line per stage, then one with the split and the
kernels' launches. ``--cpu_only`` runs the plain versions on the host (host
times, for the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ..models.fingerprint_db import FingerprintDB, _k_bucket
from ..ops import bitplane_phase1 as ph1
from ..ops import fold as fold_ops
from ..ops.bitplane import query_plane_indices
from ..ops.scan import popcount_rows_np
from ..parallel import sharded
from ..parallel.mesh import select_device
from ..utils import kernels, synth
from ..utils.fsim import FingerprintData
from ..utils.strings import ConstantStringTable
from .loadtest import card
from .probe_mxu import bitplane_bound, time_ms
from .probe_phase1 import floor_ms


def parse_args(argv, description: str):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--rows", type=int, default=352 * 1024 * 1024)
    ap.add_argument("--fold", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--cpu_only", action="store_true",
                    help="run the plain versions on the host (tests only)")
    return ap.parse_args(argv)


def folded_search_setup(args) -> SimpleNamespace:
    """The probes' library, queries and search arguments: ``db`` (the
    engine), ``store`` (its one shard), ``full_q`` (full-width queries),
    ``plane_idx`` (numpy) and the device tensors ``idx``, ``qpops``,
    ``cutoffs`` and ``ab``, the fetch width ``k_fetch``, kernel 1's
    ``bound_ms`` and ``bound_by``, and ``floor_ms``."""
    device = select_device(args.cpu_only)
    rows = synth.aligned_virtual_rows(args.rows, 1)
    data = FingerprintData(
        dbkey="probe", bitcount=1024,
        fingerprints=synth.VirtualFingerprints(rows, 1024, args.seed),
        smiles=ConstantStringTable(b"C", rows), ids=ConstantStringTable(b"P", rows),
    )
    db = FingerprintDB(data, device=device, fold_factor=args.fold,
                       scan_mode="bitplane")
    store = db.store.shards[0]
    q_rows = synth.pick_query_rows(args.batch, rows, args.fold, seed=args.seed)
    full_q = synth.virtual_rows_np(q_rows, seed=args.seed)
    folded_q = np.ascontiguousarray(fold_ops.fold_words(full_q, args.fold))
    plane_idx, _bucket = query_plane_indices(folded_q, store.bitcount)
    b = args.batch
    bound, bound_by = bitplane_bound(plane_idx, store.planes.shape[1], b)
    return SimpleNamespace(
        device=device, rows=rows, db=db, store=store, full_q=full_q,
        plane_idx=plane_idx,
        idx=torch.from_numpy(plane_idx).to(device),
        qpops=torch.from_numpy(popcount_rows_np(folded_q).astype(np.int32)).to(device),
        cutoffs=torch.zeros(b, dtype=torch.float32, device=device),
        ab=torch.ones(2, dtype=torch.float32, device=device),
        k_fetch=_k_bucket(fold_ops.overfetch_count(args.k, args.fold), rows),
        bound_ms=bound, bound_by=bound_by, floor_ms=floor_ms(device, args.repeats),
        card=card(args.cpu_only),
    )


def stage_line(s, args, stage: str, fn, bound=None) -> float:
    """Time ``fn`` (its first call untimed), print its JSON line beside
    ``bound`` (``(ms, by)``; kernel 1's by default), return ms."""
    bound_ms, bound_by = bound or (s.bound_ms, s.bound_by)
    fn()
    ms = time_ms(fn, s.device, args.repeats)
    print(json.dumps({
        "stage": stage, "rows": s.rows, "fold": args.fold, "batch": args.batch,
        "k": args.k, "k_fetch": s.k_fetch, "bucket": s.plane_idx.shape[1],
        "ms": round(ms, 4), "floor_ms": round(s.floor_ms, 4),
        "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
        "share": round(bound_ms / ms, 3), "device": str(s.device), "card": s.card,
    }), flush=True)
    return ms


def main(argv=None) -> int:
    args = parse_args(argv, __doc__.splitlines()[0])
    s = folded_search_setup(args)
    kernels.reset_launches()
    p1 = stage_line(s, args, "phase1", lambda: ph1.bitplane_phase1_batched(
        s.store.planes, s.store.popcounts, s.idx, s.qpops, s.cutoffs, s.ab,
        s.store.n_valid))
    local = stage_line(s, args, "bitplane_local_topk", lambda: sharded.bitplane_local_topk(
        s.store, s.idx, s.qpops, s.cutoffs, s.k_fetch))
    engine = stage_line(s, args, "search_batch", lambda: s.db.search_batch(
        s.full_q, k=args.k, dbkey="probe"))
    print(json.dumps({
        "probe": "probe_fold_batch", "rows": s.rows, "fold": args.fold,
        "batch": args.batch, "phase1_ms": round(p1, 4),
        "selection_ms": round(local - p1, 4),
        "host_and_rescore_ms": round(engine - local, 4),
        "kernel_bound_ms": round(s.bound_ms, 4),
        "kernel_launches": kernels.launch_counts(kernels.PASS_KERNELS["bitplane"]),
        "card": s.card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
