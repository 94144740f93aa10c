"""What bounds the bitplane phase-1 kernel (kernel 1) alone on one card (twin
of the repository's ``tools/probe_phase1.py``)::

    python -m gpusimilarity_tpu_torch.tools.probe_phase1 [--rows N]
        [--repeats R] [--cpu_only]

Times :func:`~..ops.bitplane_phase1.bitplane_phase1_batched` with no
selection after it on ``--rows`` (default 100,663,296) columns of random
planes made on the card (each bit set with probability 1/2; every column's
popcount is given as 1024, so the epilogue's ``common <= min(|q|, |db|)``
holds), over (batch, query popcount, plane bucket): batches 1, 8, 32 and
128 at 50 planes; at B=32 and B=128, 12 to 200 planes; 50 planes in the
256-plane bucket beside the 64-plane one; and B=128 of one repeated query,
whose planes are read once for the batch, beside 128 distinct ones. The
plane bucket (the kernel packs counts in 8-bit fields below 128 planes, in
16-bit ones above: 64 against 256 at 50 planes) replaces the JAX tool's
``mc8``, the width of the 8-sub-row interleave that the port does not have. If the time follows the planes the batch reads, the
kernel is bound by bytes; if it follows batch x popcount, by its adds.

Each configuration prints one JSON line: the median of ``--repeats`` launches
between CUDA events, a same-run floor (one trivial launch), the byte bound
(``probe_mxu.bitplane_bound``: each plane some query reads once, the
popcounts, the outputs, over 3.35 TB/s) and the share bound / time; a last
line counts the kernel's launches. ``--cpu_only`` runs the plain version on
the host (host times, for the tests).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import bitplane_phase1 as ph1
from ..ops.bitplane import plane_bucket_for
from ..parallel.mesh import select_device
from ..utils import kernels
from .loadtest import card
from .probe_mxu import bitplane_bound, random_words, time_ms

N_ROWS = 100_663_296
BITCOUNT = 1024
# (batch, query popcount, plane bucket or None for the smallest, one query
# repeated over the batch)
CONFIGS = (
    (1, 50, None, False), (8, 50, None, False), (32, 50, None, False),
    (128, 50, None, False),
    (32, 12, None, False), (32, 25, None, False), (32, 100, None, False),
    (32, 200, None, False),
    (128, 12, None, False), (128, 25, None, False), (128, 100, None, False),
    (128, 200, None, False),
    (32, 50, 256, False), (128, 50, 256, False),
    (128, 50, None, True),
)


def floor_ms(device: torch.device, repeats: int) -> float:
    """Same-run floor: the median time of one trivial launch (8 floats)."""
    x = torch.zeros(8, device=device)
    return time_ms(lambda: x + 1, device, max(5, repeats))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N_ROWS)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cpu_only", action="store_true",
                    help="run the plain version on the host (tests only)")
    args = ap.parse_args(argv)
    device = select_device(args.cpu_only)
    m = -(-args.rows // 2048) * 64  # plane words, whole selection blocks
    kernels.reset_launches()
    gen = torch.Generator(device=device).manual_seed(0)
    planes = random_words((BITCOUNT + 1, m), device, gen)
    planes[BITCOUNT] = 0  # the sentinel plane
    pops = torch.full((32 * m,), BITCOUNT, dtype=torch.int16, device=device)
    ab = torch.ones(2, dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    floor = floor_ms(device, args.repeats)
    name = card(args.cpu_only)

    for b, qpop, bucket, repeated in CONFIGS:
        bucket = bucket or plane_bucket_for(qpop, BITCOUNT)
        idx = np.full((b, bucket), BITCOUNT, np.int32)
        for q in range(b):
            if q == 0 or not repeated:
                picked = np.sort(rng.choice(BITCOUNT, qpop, replace=False))
            idx[q, :qpop] = picked
        t_idx = torch.from_numpy(idx).to(device)
        t_qp = torch.full((b,), qpop, dtype=torch.int32, device=device)
        t_cut = torch.zeros(b, dtype=torch.float32, device=device)

        def run():
            return ph1.bitplane_phase1_batched(planes, pops, t_idx, t_qp, t_cut, ab,
                                               args.rows)

        run()  # first call: builds the kernel
        ms = time_ms(run, device, args.repeats)
        bound, by = bitplane_bound(idx, m, b)
        print(json.dumps({
            "kernel": ph1.KERNEL, "rows": args.rows, "batch": b,
            "qpop": qpop, "bucket": bucket, "repeated_query": repeated,
            "ms": round(ms, 4), "floor_ms": round(floor, 4),
            "bound_ms": round(bound, 4), "bound_by": by,
            "share": round(bound / ms, 3), "device": str(device), "card": name,
        }), flush=True)
    print(json.dumps({"probe": "probe_phase1", "configurations": len(CONFIGS),
                      "kernel_launches": kernels.launch_counts([ph1.KERNEL]),
                      "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
