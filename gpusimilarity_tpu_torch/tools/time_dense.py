"""Time the dense phase-1 kernel on one card::

    python -m gpusimilarity_tpu_torch.tools.time_dense [--rows N] [--words W]

Builds a dense store of ``--rows`` random rows of ``--words`` packed words
(each bit set with probability 1/8, about the density of a fold-4 Morgan
fingerprint) on the card and times one launch of
:func:`~..ops.dense_phase1.dense_phase1` per batch size and cutoff, then one
popless and one Tversky launch, median of ``--repeats`` launches between CUDA
events. It then holds the kernel against the plain version on a column prefix.
One JSON line per configuration, with the card's name and power limit and
the kernel's bound (:func:`~.probe_mxu.dense_bound`). A quick look at a
change to ``csrc/dense_phase1.cu`` without the full-size library of
``chip_smoke.py``; needs the card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import dense_phase1 as ph2
from ..ops.scan import TANIMOTO, TVERSKY, popcount_rows_np
from ..parallel.sharded import DENSE_BLOCK_COLS, build_store
from .probe_b1 import card_line
from .probe_mxu import dense_bound, random_words, time_ms


def sparse_words(shape, device, gen) -> torch.Tensor:
    """Random int32 words, every bit set with probability 1/8."""
    return (random_words(shape, device, gen) & random_words(shape, device, gen)
            & random_words(shape, device, gen))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 28)
    ap.add_argument("--words", type=int, default=8)
    ap.add_argument("--batches", type=str, default="1,16,32")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--check_cols", type=int, default=1 << 24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the timing needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    store = build_store(sparse_words((args.rows, args.words), dev, gen))
    batches = [int(x) for x in args.batches.split(",")]
    q = sparse_words((max(batches), args.words), dev, gen)
    qp = torch.from_numpy(popcount_rows_np(q.cpu().numpy().view(np.uint32))).to(dev)
    ab = torch.ones(2, dtype=torch.float32, device=dev)
    n = store.n_valid

    def record(b, cutoff, pops, similarity):
        cut = torch.full((b,), cutoff, dtype=torch.float32, device=dev)

        def run():
            return ph2.dense_phase1(store.words, pops, q[:b], qp[:b], cut, ab,
                                    n, DENSE_BLOCK_COLS, similarity)

        run()
        torch.cuda.synchronize(dev)
        bound_ms, bound_by = dense_bound(store.n_padded, args.words, b, DENSE_BLOCK_COLS)
        print(json.dumps({
            "card": card, "rows": n, "words": args.words, "batch": b,
            "cutoff": cutoff, "similarity": similarity,
            "popless": pops is None, "ms": round(time_ms(run, dev, args.repeats), 4),
            "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
        }), flush=True)

    for b in batches:
        for cutoff in (0.0, 0.12):
            record(b, cutoff, store.popcounts, TANIMOTO)
    record(max(batches), 0.12, None, TANIMOTO)
    record(max(batches), 0.12, store.popcounts, TVERSKY)

    cols = min(args.check_cols, store.n_padded) // DENSE_BLOCK_COLS * DENSE_BLOCK_COLS
    b = max(batches)
    check = (store.words[:, :cols], store.popcounts[:cols], q[:b], qp[:b],
             torch.full((b,), 0.12, dtype=torch.float32, device=dev), ab, cols - 5,
             DENSE_BLOCK_COLS, TANIMOTO)
    bm, cnt = ph2.dense_phase1(*check)
    pbm, pcnt = ph2.dense_phase1_plain(*check)
    same = (torch.equal(bm.view(torch.int32), pbm.view(torch.int32))
            and torch.equal(cnt, pcnt))
    print(json.dumps({"check_cols": cols, "bit_identical_to_plain": same}), flush=True)
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
