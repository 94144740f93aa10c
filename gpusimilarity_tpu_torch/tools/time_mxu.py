"""Check and time the matrix-product phase-1 kernel (kernel 3) on one card::

    python -m gpusimilarity_tpu_torch.tools.time_mxu [--rows N] [--batches 1,32,64,128]

Builds an unfolded dense store of ``--rows`` random 1024-bit rows (each bit
set with probability 1/16, about the density of a Morgan fingerprint) on the
card. First it holds :func:`~..ops.mxu_phase1.mxu_phase1` against its plain
version, bit for bit, on a column prefix where the kernel's code forks (batch
sizes on and off a 16-row tile, every block width, ``n_valid`` off a block
boundary, a shard offset, a strided prefix, an unaligned one, Tversky, mixed
cutoffs, a zero query). Then it times, per batch size, one launch of kernel 3
and one of the dense kernel (kernel 2) on the same store, in turns, median of
``--repeats`` launches between CUDA events. One JSON line per configuration
with the card's name and power limit and the kernel's bound
(:func:`~.probe_mxu.mxu_bound`, :func:`~.probe_mxu.dense_bound`). A quick look
at a change to ``csrc/mxu_phase1.cu`` without the full-size library of
``chip_smoke.py``; needs the card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import dense_phase1 as ph2
from ..ops import mxu_phase1 as ph3
from ..ops.scan import TANIMOTO, TVERSKY, popcount_rows
from ..parallel.sharded import DENSE_BLOCK_COLS, build_store
from ..utils import kernels
from .probe_b1 import card_line
from .probe_mxu import dense_bound, mxu_bound, random_words, time_ms

# name -> (queries, block, columns off the prefix's start, columns, n_valid
# short of the columns, shard offset, similarity)
CHECKS = {
    "b1": (1, 256, 0, 1 << 20, 0, 0, TANIMOTO),
    "b8": (8, 256, 0, 1 << 20, 77, 0, TANIMOTO),
    "b9_block128": (9, 128, 0, 1 << 20, 77, 0, TANIMOTO),
    "b32_block64_offset": (32, 64, 0, 1 << 20, 77, 4096, TANIMOTO),
    "b64": (64, 256, 0, 1 << 20, 0, 0, TANIMOTO),
    "b100_block64": (100, 64, 0, (1 << 20) + 64, 77, 0, TANIMOTO),
    "b128_ragged_tile": (128, 128, 0, (1 << 20) + 128, 300, 0, TANIMOTO),
    "b128_unaligned": (128, 256, 3, 1 << 18, 5, 0, TANIMOTO),
    "b33_tversky": (33, 256, 0, 1 << 20, 77, 0, TVERSKY),
    "b200_two_launches": (200, 256, 0, 1 << 18, 77, 0, TANIMOTO),
}


def sparse_words(shape, device, gen, chunk_rows: int = 1 << 22) -> torch.Tensor:
    """Random int32 words ``(rows, words)``, every bit set with probability
    1/16, made in row chunks so the temporaries stay small beside the result."""
    out = torch.empty(shape, dtype=torch.int32, device=device)
    for lo in range(0, shape[0], chunk_rows):
        part = out[lo:lo + chunk_rows]
        part.copy_(random_words(part.shape, device, gen))
        for _ in range(3):
            part &= random_words(part.shape, device, gen)
    return out


def check_case(name, store, queries, dev) -> bool:
    """One case of :data:`CHECKS`: kernel 3 against its plain version and
    against kernel 2."""
    b, block, start, cols, short, offset, sim = CHECKS[name]
    words = store.words[:, start:start + cols]
    pops = store.popcounts[start:start + cols].contiguous()
    q = torch.cat([queries[:b - 1], torch.zeros_like(queries[:1])]) if b > 1 else queries[:1]
    q = q.contiguous()
    qp = popcount_rows(q)
    cut = torch.tensor([0.0, 0.12, 1.0, -0.5], device=dev).repeat(-(-b // 4))[:b].contiguous()
    ab = torch.tensor([0.7, 0.3] if sim == TVERSKY else [1.0, 1.0], device=dev)
    n_valid = offset + cols - short
    args = (words, pops, ph3.query_bits(q), qp, cut, ab, offset, block, n_valid, sim)
    bm, cnt = ph3.mxu_phase1(*args)
    pbm, pcnt = ph3.mxu_phase1_plain(*args)
    same = (torch.equal(bm.view(torch.int32), pbm.view(torch.int32))
            and torch.equal(cnt, pcnt))
    dbm, dcnt = ph2.dense_phase1(words, pops, q, qp, cut, ab, n_valid - offset,
                                 block, sim)
    same = (same and torch.equal(bm.view(torch.int32), dbm.view(torch.int32))
            and torch.equal(cnt, dcnt))
    torch.cuda.synchronize(dev)
    print(json.dumps({"check": name, "bit_identical": same,
                      "counts": cnt[:4].tolist()}), flush=True)
    return same


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=113_335_291)
    ap.add_argument("--batches", type=str, default="1,32,64,128")
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--skip_checks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the timing needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = card_line()
    for name in (ph3.KERNEL, ph2.KERNEL):
        build = kernels.load(name)
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    store = build_store(sparse_words((args.rows, ph3.WORDS), dev, gen))
    n = store.n_valid
    batches = [int(x) for x in args.batches.split(",")]
    queries = store.words[:, :max(max(batches), 256)].T.contiguous()

    ok = True
    if not args.skip_checks:
        for name in CHECKS:
            ok = check_case(name, store, queries, dev) and ok

    ab = torch.ones(2, dtype=torch.float32, device=dev)
    for b in batches:
        # a batch over 1 ends in a query with no set bits, as the checks' do
        q = queries[:b].clone()
        if b > 1:
            q[-1] = 0
        qp, qbits = popcount_rows(q), ph3.query_bits(q)
        for cutoff in (0.0, 0.12):
            cut = torch.full((b,), cutoff, dtype=torch.float32, device=dev)

            def run3():
                return ph3.mxu_phase1(store.words, store.popcounts, qbits, qp, cut,
                                      ab, 0, DENSE_BLOCK_COLS, n)

            def run2():
                return ph2.dense_phase1(store.words, store.popcounts, q, qp, cut, ab,
                                        n, DENSE_BLOCK_COLS)

            run3(), run2()
            torch.cuda.synchronize(dev)
            ms3 = [time_ms(run3, dev, args.repeats)]
            ms2 = [time_ms(run2, dev, args.repeats)]
            ms2.append(time_ms(run2, dev, args.repeats))
            ms3.append(time_ms(run3, dev, args.repeats))
            bound3 = mxu_bound(store.n_padded, b, DENSE_BLOCK_COLS)
            bound2 = dense_bound(store.n_padded, ph3.WORDS, b, DENSE_BLOCK_COLS)
            print(json.dumps({
                "card": card, "rows": n, "batch": b, "cutoff": cutoff,
                "mxu_ms": [round(x, 4) for x in ms3],
                "dense_ms": [round(x, 4) for x in ms2],
                "mxu_bound_ms": round(bound3[0], 4), "mxu_bound_by": bound3[1],
                "dense_bound_ms": round(bound2[0], 4), "dense_bound_by": bound2[1],
            }), flush=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
