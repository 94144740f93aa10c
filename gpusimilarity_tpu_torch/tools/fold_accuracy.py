"""Fold-accuracy study: how exact is folded search at each fold factor?
(twin of the repository's ``tools/fold_accuracy.py``)::

    python -m gpusimilarity_tpu_torch.tools.fold_accuracy [--rows N]
        [--queries Q] [--k K] [--folds 2,4,8] [--data clustered|random]
        [--cpu_only]

Reproduces the reference's published accuracy experiment (RDKit UGM 2018
presentation slide 11: top-20 x 100 searches over a 17M library -> fold 2:
0% mismatches, fold 4: 0.1%, fold 8: 1.45%, with the k*fold*log2(2*fold)
over-fetch of ``fingerprintdb_cuda.cu:284-287``).

The engine rescores its candidates exactly, so the only possible error is a
true top-k row missing from the folded scan's over-fetched candidates. For
Q queries over an N-row synthetic Morgan-like library (the same numpy
generator and seed as the root tool), the study compares the port's folded
search, ``FingerprintDB(data, fold_factor=f)`` in the scan mode ``auto``
resolves to (dense when folded: kernel 2 on the card), against the exact
full-width top-k of ``scores_np`` and counts the missed rows. Ties at the
k-th score are interchangeable, not misses.

Runs on the card unless ``--cpu_only`` (the plain versions on the host);
both give the same line but ``wall_s``. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..models.fingerprint_db import FingerprintDB
from ..models.registry import resolve_scan_mode
from ..ops.scan import scores_np
from ..parallel.mesh import select_device
from ..utils.fsim import FingerprintData


def make_library(n: int, data_kind: str, rng: np.random.Generator) -> np.ndarray:
    """Packed rows ``uint8 (n, 128)``: ``clustered`` (scaffolds with member
    mutations, like an analog series) or ``random`` (sparse, no structure:
    the adversarial case), drawn as the root tool draws them."""
    if data_kind == "random":
        packed = np.frombuffer(rng.bytes(n * 128), np.uint8).reshape(n, 128)
        for _ in range(3):
            packed = packed & np.frombuffer(rng.bytes(n * 128), np.uint8).reshape(n, 128)
        return packed.copy()
    n_scaffolds = max(1, n // 200)
    scaff_bits = rng.random((n_scaffolds, 1024)) < 0.05
    member = rng.integers(0, n_scaffolds, size=n)
    bits = scaff_bits[member]
    drop = rng.random(bits.shape) < 0.10  # lose 10% of the scaffold's bits
    extra = rng.random(bits.shape) < (8 / 1024)  # ~8 decoration bits
    bits = (bits & ~drop) | extra
    return np.packbits(bits, axis=1, bitorder="little")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--folds", default="2,4,8")
    ap.add_argument("--data", default="clustered", choices=("clustered", "random"))
    ap.add_argument("--cpu_only", action="store_true",
                    help="run the plain versions on the host")
    args = ap.parse_args(argv)
    device = select_device(args.cpu_only)

    rng = np.random.default_rng(17)
    n, q, k = args.rows, args.queries, args.k
    packed = make_library(n, args.data, rng)
    data = FingerprintData(
        fingerprints=packed, smiles=[b"C"] * n,
        ids=[str(i).encode() for i in range(n)],
    )
    words = data.packed_words()
    q_rows = rng.choice(n, size=q, replace=False)

    t0 = time.monotonic()
    # the oracle depends only on the query: one full-width scan per query
    oracle = {}
    for qi in q_rows:
        s = scores_np(words, np.array(words[qi])[None, :])[0]
        oracle[int(qi)] = (set(np.lexsort((np.arange(n), -s))[:k].tolist()), s)
    results = {}
    for fold in (int(f) for f in args.folds.split(",")):
        db = FingerprintDB(data, device=device, fold_factor=fold,
                           scan_mode=resolve_scan_mode("auto", fold))
        mism = 0
        worst = 0.0
        for qi in q_rows:
            r = db.search(np.array(words[qi]), k=k, return_indices=True)
            want, s = oracle[int(qi)]
            missing = want - set(r.indices)
            if missing:
                kth = sorted((s[i] for i in want), reverse=True)[k - 1]
                missing = {i for i in missing if s[i] > kth}
            mism += len(missing)
            for i in missing:
                worst = max(worst, float(s[i]))
        del db
        results[f"fold{fold}_mismatch_pct"] = round(100 * mism / (q * k), 3)
        results[f"fold{fold}_worst_missed_score"] = round(worst, 3)
        print(f"  fold {fold}: {mism}/{q * k} mismatched rows "
              f"({100 * mism / (q * k):.2f}%)", file=sys.stderr)
    print(json.dumps({
        "metric": "fold_accuracy_study",
        "data": args.data,
        "rows": n,
        "queries": q,
        "k": k,
        "reference_slide11_pct": {"fold2": 0.0, "fold4": 0.1, "fold8": 1.45},
        **results,
        "wall_s": round(time.monotonic() - t0, 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
