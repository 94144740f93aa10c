"""Fingerprint folding (twin of ``gpusimilarity_tpu/ops/fold.py``).

A library larger than the card is served folded: bit ``p`` ORs into
``p % (bitcount / fold)``. With the fold rounded up to a divisor of the word
count (:func:`round_fold_factor`) that is a word-level OR-reduce,
``folded[w] = OR_g unfolded[g * (W // fold) + w]`` (:func:`fold_words`).
The folded scan fetches ``k * fold * log2(2 * fold)`` candidates
(:func:`overfetch_count`), which the engine rescores exactly against the
full-width rows on the host.
"""

from __future__ import annotations

import math

import numpy as np


def round_fold_factor(word_count: int, fold_factor: int) -> int:
    """Round ``fold_factor`` up to the next divisor of ``word_count``
    (reference ``fingerprintdb_cuda.cu:171-173``, in words)."""
    if fold_factor < 1:
        raise ValueError("fold factor must be >= 1")
    while word_count % fold_factor != 0:
        fold_factor += 1
    return fold_factor


def fold_words(words, fold_factor: int):
    """OR-fold packed rows ``(..., W)`` by ``fold_factor`` along the word
    axis: numpy ``uint32`` (through ``native.fold_rows`` when the native
    library is built) or int32 tensors on any device. Identity at fold 1."""
    if fold_factor == 1:
        return words
    w = words.shape[-1]
    if w % fold_factor != 0:
        raise ValueError(f"fold factor {fold_factor} does not divide {w} words")
    if isinstance(words, np.ndarray) and words.ndim == 2 and len(words) >= 1024:
        from gpusimilarity_tpu.utils import native

        if native.available():
            return native.fold_rows(words, fold_factor)
    grouped = words.reshape(*words.shape[:-1], fold_factor, w // fold_factor)
    if isinstance(grouped, np.ndarray):
        return np.bitwise_or.reduce(grouped, axis=-2)
    out = grouped[..., 0, :]
    for g in range(1, fold_factor):
        out = out | grouped[..., g, :]
    return out


def overfetch_count(k: int, fold_factor: int) -> int:
    """Candidates to pull from a folded scan before exact rescoring: the
    reference's ``k * fold * log2(2 * fold)``; ``k`` at fold 1."""
    if fold_factor == 1:
        return k
    return int(math.ceil(k * fold_factor * math.log2(2 * fold_factor)))
