"""Fold-factor rules (numpy twins of ``gpusimilarity_tpu/ops/fold.py``).

The port serves unfolded libraries only: the engine rounds the requested
fold with :func:`round_fold_factor` and raises on anything above 1. The
over-fetch rule stays because the fetch width ``_k_bucket`` picks depends
on it.
"""

from __future__ import annotations

import math


def round_fold_factor(word_count: int, fold_factor: int) -> int:
    """Round ``fold_factor`` up to the next divisor of ``word_count``
    (reference ``fingerprintdb_cuda.cu:171-173``, in words)."""
    if fold_factor < 1:
        raise ValueError("fold factor must be >= 1")
    while word_count % fold_factor != 0:
        fold_factor += 1
    return fold_factor


def overfetch_count(k: int, fold_factor: int) -> int:
    """Candidates to pull from a folded scan before exact rescoring: the
    reference's ``k * fold * log2(2 * fold)``; ``k`` at fold 1."""
    if fold_factor == 1:
        return k
    return int(math.ceil(k * fold_factor * math.log2(2 * fold_factor)))
