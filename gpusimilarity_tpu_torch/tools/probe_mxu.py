"""Measure the matrix-product scan (kernel 3) against the popcount kernels
on one card (twin of ``tools/probe_mxu.py``)::

    python -m gpusimilarity_tpu_torch.tools.probe_mxu [--rows N] [--batches 1,32,64,128]

Does the tensor-core reformulation ``popcount(a & b) = <bits(a), bits(b)>``
pay? The probe builds an unfolded dense store of ``--rows`` random 1024-bit
rows on the card and times, per batch size, :func:`~..ops.mxu_phase1.
mxu_phase1` (up to 128 queries a pass over the store) and the dense popcount
scan :func:`~..ops.dense_phase1.dense_phase1` (32 queries a pass) on the same
store; then frees it,
builds a bitplane store of the same row count and times
:func:`~..ops.bitplane_phase1.bitplane_phase1_batched` for queries of
``--qpop`` set bits. The two stores are different layouts, so the comparison
is the cost of one batch, not of one byte.

Times are medians of ``--repeats`` calls, each between two CUDA events;
the first call (which builds the kernel) is timed apart as ``compile_s``.
Each configuration prints one JSON line, with the least time the card could
take (``bound_ms``: the larger of the bytes over 3.35 TB/s, an H100 SXM's
data-sheet rate at 700 W, and the bit operations of the binary tensor-core
product over the rate ``tools/probe_b1.py`` measured: both kernels' work done
the card's best way). The card is the default; without one
the probe raises. ``--cpu_only`` runs the plain versions on the host, for
the tests: its times are host times of the plain code, not a device's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..ops.bitplane import plane_bucket_for
from ..ops.bitplane_phase1 import bitplane_phase1_batched
from ..ops.dense_phase1 import dense_phase1
from ..ops.mxu_phase1 import WORDS, mxu_phase1, query_bits
from ..ops.scan import TANIMOTO, popcount_rows_np
from ..parallel.mesh import select_device
from ..parallel.sharded import DENSE_BLOCK_COLS, build_bitplane_store, build_store

# Enamine REAL 2/12, the reference's unfolded configuration
DEFAULT_ROWS = 113_335_291
# NVIDIA H100 SXM data sheet, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
# The binary tensor-core product (mma.sync m16n8k256 b1 and.popc), the one
# product the kernels issue, has no rate in the data sheet. This one is
# MEASURED: tools/probe_b1.py on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, 1.40e11 warp-wide products a second over 132 SMs, 2 * 16 * 8 * 256 bit
# operations each.
PEAK_OPS_PER_S = {"b1": 9.19e15}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=DEFAULT_ROWS)
    ap.add_argument("--batches", type=str, default="1,32,64,128")
    ap.add_argument("--bw", type=int, default=DENSE_BLOCK_COLS,
                    help="selection block width of the dense scans")
    ap.add_argument("--qpop", type=int, default=50,
                    help="set bits of each bitplane query")
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--skip_bitplane", action="store_true")
    ap.add_argument("--cpu_only", action="store_true",
                    help="run the plain versions on the host (tests only)")
    return ap.parse_args(argv)


def bound(bytes_moved: float, b1_ops: float = 0.0):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and ``b1_ops`` bit operations over the measured rate of the binary
    tensor-core product (named ``"b1 operations"`` in ``bound_by``)."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = b1_ops / PEAK_OPS_PER_S["b1"]
    if by_ops > by_bytes:
        return by_ops * 1e3, "b1 operations"
    return by_bytes * 1e3, "bytes"


def mxu_bound(n: int, b: int, block: int):
    """Kernel 3 over ``n`` columns: 128 B of words and a 2-byte popcount
    per column, the query bits, metadata and outputs once; 2 * b * 1024 bit
    operations per column over the measured rate of the binary tensor-core
    product, the card's best way to this product (the int8 product the TPU
    kernel uses would take 4.6 times as long here)."""
    moved = n * (WORDS * 4 + 2) + b * (WORDS * 32 + 12) + b * (n // block) * 4 + b * 8
    return bound(moved, 2.0 * b * WORDS * 32 * n)


def dense_bound(n: int, wf: int, b: int, block: int):
    """Kernel 2 over ``n`` columns of ``wf`` words with popcounts: its
    bytes, or its AND-popcount work (2 bit operations per query, column and
    bit) over the measured rate of the binary tensor-core product."""
    moved = n * (wf * 4 + 2) + b * (wf * 4 + 12)
    ops = 2.0 * b * 32 * wf * n
    return bound(moved + b * (n // block) * 4 + b * 8, ops)


def bitplane_bound(plane_idx: np.ndarray, m: int, b: int):
    """Kernel 1 over ``m`` plane words: each plane some query reads, once,
    the column popcounts, and the per-word maxima it writes."""
    planes_read = len(np.unique(plane_idx))
    moved = planes_read * m * 4 + 32 * m * 2 + plane_idx.size * 4 + b * 12
    return bound(moved + b * m * 4 + b * 4)


def timed(fn, device: torch.device):
    """One call of ``fn``: ``(its result, ms)``, between two CUDA events on
    a card, by the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Median ms of ``reps`` calls, each timed by :func:`timed`."""
    return statistics.median(timed(fn, device)[1] for _ in range(reps))


def _first_call_s(fn, device) -> float:
    t0 = time.monotonic()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.monotonic() - t0


def random_words(shape, device, gen) -> torch.Tensor:
    """Uniform random int32 words (every bit set with probability 1/2)."""
    raw = torch.randint(0, 256, (*shape, 4), dtype=torch.uint8, device=device,
                        generator=gen)
    return raw.view(torch.int32).squeeze(-1)


def _record(kernel, device, n, b, p50, first_s, bound_ms_by, **extra):
    return {
        "kernel": kernel, **extra, "batch": b, "rows": n, "device": device,
        "p50_ms": round(p50, 4), "fps_per_chip": round(n * b / (p50 / 1e3), 1),
        "compile_s": round(first_s, 3), "bound_ms": round(bound_ms_by[0], 4),
        "bound_by": bound_ms_by[1],
    }


def probe_dense(args, device, name):
    """Kernel 3 and kernel 2 on one unfolded dense store, per batch; yields
    one record per configuration."""
    n = args.rows
    gen = torch.Generator(device=device).manual_seed(0)
    store = build_store(random_words((n, WORDS), device, gen))
    words, pops = store.words, store.popcounts
    batches = [int(x) for x in args.batches.split(",")]
    rng = np.random.default_rng(7)
    queries = rng.integers(0, 2**32, (max(batches), WORDS), dtype=np.uint64)
    queries = np.ascontiguousarray(queries.astype(np.uint32))
    qt = torch.from_numpy(queries.view(np.int32)).to(device)
    qbits = query_bits(qt)
    qpops = torch.from_numpy(popcount_rows_np(queries)).to(device)
    ab = torch.ones(2, dtype=torch.float32, device=device)
    bw = args.bw
    for b in batches:
        cut = torch.zeros(b, dtype=torch.float32, device=device)

        def run():
            return mxu_phase1(words, pops, qbits[:b], qpops[:b], cut, ab, 0, bw,
                              n, TANIMOTO)

        first = _first_call_s(run, device)
        yield _record("mxu", name, n, b, time_ms(run, device, args.repeats),
                      first, mxu_bound(words.shape[1], b, bw), bw=bw)

        def run_dense():
            return dense_phase1(words, pops, qt[:b], qpops[:b], cut, ab, n, bw)

        first = _first_call_s(run_dense, device)
        yield _record("dense", name, n, b, time_ms(run_dense, device, args.repeats),
                      first, dense_bound(words.shape[1], WORDS, b, bw), bw=bw)


def probe_bitplane(args, device, name):
    """Kernel 1 on a bitplane store of the same row count, queries of
    ``--qpop`` set planes at their bucket; yields one record per batch."""
    n = args.rows
    gen = torch.Generator(device=device).manual_seed(1)
    store = build_bitplane_store(random_words((n, WORDS), device, gen))
    rng = np.random.default_rng(7)
    bitcount = store.bitcount
    bucket = plane_bucket_for(args.qpop, bitcount)
    m = store.planes.shape[1]
    ab = torch.ones(2, dtype=torch.float32, device=device)
    for b in (int(x) for x in args.batches.split(",")):
        plane_idx = np.full((b, bucket), bitcount, dtype=np.int32)
        for q in range(b):
            plane_idx[q, :args.qpop] = np.sort(
                rng.choice(bitcount, size=args.qpop, replace=False)
            )
        idx_t = torch.from_numpy(plane_idx).to(device)
        qp = torch.full((b,), args.qpop, dtype=torch.int32, device=device)
        cut = torch.zeros(b, dtype=torch.float32, device=device)

        def run():
            return bitplane_phase1_batched(store.planes, store.popcounts, idx_t,
                                           qp, cut, ab, store.n_valid)

        first = _first_call_s(run, device)
        yield _record("bitplane", name, n, b, time_ms(run, device, args.repeats),
                      first, bitplane_bound(plane_idx, m, b), qpop=args.qpop,
                      bucket=bucket)


def run(args, device):
    """Every configuration's record, in order: per batch kernel 3 then
    kernel 2, then kernel 1 per batch. The dense store is freed
    before the bitplane store is built."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    yield from probe_dense(args, device, name)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not args.skip_bitplane:
        yield from probe_bitplane(args, device, name)


def main(argv=None):
    args = parse_args(argv)
    device = select_device(cpu_only=args.cpu_only)
    for record in run(args, device):
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
