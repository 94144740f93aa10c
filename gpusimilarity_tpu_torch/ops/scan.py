"""Similarity scoring over packed fingerprint words (twin of
``gpusimilarity_tpu/ops/scan.py``).

Words are held as ``int32`` views of the ``uint32`` packed data: PyTorch
has no unsigned 32-bit arithmetic (``>>`` on ``torch.uint32`` raises), its
``int32 >>`` is an arithmetic shift, and it has no popcount op. So
popcounts here split each word into two 16-bit halves (non-negative, so
every shift and subtraction stays in range) and count them by SWAR.

IEEE f32 ``/`` is correctly rounded on the CPU and on CUDA (without fast
math), so the JAX package's ``exact_div`` — a repair for the TPU's
reciprocal-multiply divide — has no twin: a plain ``/`` gives the same
bits (``tests/test_torch_scan.py`` checks the whole operand grid).
"""

from __future__ import annotations

import numpy as np
import torch

TANIMOTO = "tanimoto"
TVERSKY = "tversky"

_POPCOUNT_TABLE = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.int32)


def popcount_rows_np(words: np.ndarray) -> np.ndarray:
    """Host-side popcount of packed rows: ``uint32[N, W] -> int32[N]``:
    ``np.bitwise_count`` of the 32-bit words where numpy has it (numpy 2), a
    byte table otherwise; the same counts either way."""
    words = np.ascontiguousarray(words)
    if hasattr(np, "bitwise_count") and words.dtype.itemsize == 4:
        return np.bitwise_count(words.view(np.uint32)).sum(axis=-1, dtype=np.int32)
    return _POPCOUNT_TABLE[words.view(np.uint8)].sum(axis=-1, dtype=np.int32)


def scores_np(
    db_words: np.ndarray,
    query_words: np.ndarray,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> np.ndarray:
    """Numpy scores of packed rows against packed queries (twin of the JAX
    package's ``scores_np``): ``(N, W), (..., W) -> f32 (..., N)``,
    computed in float64 and rounded once to float32. The host rescore of
    folded-scan candidates when the native library is absent."""
    c = popcount_rows_np(db_words & query_words[..., None, :])
    dp = popcount_rows_np(db_words).astype(np.float64)
    qp = popcount_rows_np(query_words.reshape(-1, query_words.shape[-1]))
    qp = qp.reshape(query_words.shape[:-1])[..., None].astype(np.float64)
    if similarity == TANIMOTO:
        denom = qp + dp - c
    elif similarity == TVERSKY:
        denom = alpha * (qp - c) + beta * (dp - c) + c
    else:
        raise ValueError(f"unknown similarity {similarity!r}")
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(denom > 0, c / denom, 0.0)
    return out.astype(np.float32)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32-viewed ``uint32`` words (same shape)."""
    return _popcount16(words & 0xFFFF) + _popcount16((words >> 16) & 0xFFFF)


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of packed rows: ``int32[..., W] -> int32[...]``."""
    return popcount_words(words).sum(dim=-1, dtype=torch.int32)


def common_bits(db_words: torch.Tensor, query_words: torch.Tensor) -> torch.Tensor:
    """Popcount of the AND: ``(N, W) & (B, W) -> int32 (B, N)``."""
    return popcount_rows(db_words[None, :, :] & query_words[:, None, :])


def similarity_from_counts(
    common: torch.Tensor,
    db_popcounts: torch.Tensor,
    query_popcounts: torch.Tensor,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> torch.Tensor:
    """Turn intersection counts into float32 scores, with the JAX semantics
    (``gpusimilarity_tpu/ops/scan.py::similarity_from_counts``).

    Tanimoto ``c / (|q| + |db| - c)``; Tversky
    ``c / (alpha*(|q|-c) + beta*(|db|-c) + c)``, evaluated in that order,
    one rounded op at a time, as the CUDA kernel does. A zero denominator
    scores 0 and ``c == denom > 0`` is pinned to 1.0. ``query_popcounts``
    broadcasts against the last axis of ``common``.
    """
    c = common.to(torch.float32)
    qp = query_popcounts.to(torch.float32)[..., None]
    dp = db_popcounts.to(torch.float32)
    if similarity == TANIMOTO:
        denom = qp + dp - c
        # denom == 0 only when c == 0; the clamp keeps the unused branch
        # free of 0/0 and never changes a real score
        score = torch.where(denom > 0, c / denom.clamp(min=1.0), 0.0)
    elif similarity == TVERSKY:
        # alpha/beta round to f32 first, as the kernel receives them
        a = float(np.float32(alpha))
        b = float(np.float32(beta))
        denom = a * (qp - c) + b * (dp - c) + c
        score = torch.where(denom > 0, c / denom.clamp(min=1e-30), 0.0)
    else:
        raise ValueError(f"unknown similarity {similarity!r}")
    return torch.where((c == denom) & (denom > 0), 1.0, score)


def score_batch(
    db_words: torch.Tensor,
    db_popcounts: torch.Tensor,
    query_words: torch.Tensor,
    query_popcounts: torch.Tensor,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> torch.Tensor:
    """Plain dense scores of a query batch against packed rows:
    ``(N, W), (B, W) -> f32 (B, N)``. The test and smoke oracle."""
    c = common_bits(db_words, query_words)
    return similarity_from_counts(
        c, db_popcounts, query_popcounts, similarity, alpha, beta
    )


def score_columns(
    cols: torch.Tensor,
    col_pops: torch.Tensor | None,
    queries: torch.Tensor,
    query_popcounts: torch.Tensor,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> torch.Tensor:
    """Plain scores of planar columns (twin of the JAX ``_score_columns``):
    ``cols (Wf, C)`` shared by the batch, or ``(Wf, B, C)`` per query,
    against ``queries (B, Wf)`` -> f32 ``(B, C)``. ``col_pops=None`` (a
    popless store) recomputes the column popcounts from ``cols``."""
    common = popcount_words(cols[0] & queries[:, 0, None])
    for i in range(1, cols.shape[0]):
        common += popcount_words(cols[i] & queries[:, i, None])
    if col_pops is None:
        col_pops = popcount_words(cols).sum(dim=0, dtype=torch.int32)
    return similarity_from_counts(
        common, col_pops, query_popcounts, similarity, alpha, beta
    )


def full_scan_topk(
    db_words: torch.Tensor,
    db_popcounts: torch.Tensor,
    query_words: torch.Tensor,
    k: int,
    cutoffs: torch.Tensor,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
    chunk_rows: int = 1 << 22,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain dense full scan with exact top-k and >=cutoff counts.

    Scores every row of ``db_words (N, W)`` against each query in chunks of
    ``chunk_rows`` (so it fits beside a full library on the card) and
    returns ``(values f32 (B, k), indices int64 (B, k), counts int64 (B,))``
    with the lowest index first among equal scores.
    """
    from .topk import topk_lowest_index

    n = db_words.shape[0]
    qpops = popcount_rows(query_words)
    vals, idx, counts = [], [], []
    for qi in range(query_words.shape[0]):
        best_v = best_i = None
        cnt = torch.zeros((), dtype=torch.int64, device=db_words.device)
        for lo in range(0, n, chunk_rows):
            hi = min(n, lo + chunk_rows)
            s = score_batch(
                db_words[lo:hi], db_popcounts[lo:hi], query_words[qi:qi + 1],
                qpops[qi:qi + 1], similarity, alpha, beta,
            )[0]
            cnt += (s >= cutoffs[qi]).sum()
            v, i = topk_lowest_index(s, min(k, hi - lo))
            i = i + lo
            if best_v is not None:
                v, i = torch.cat([best_v, v]), torch.cat([best_i, i])
                # candidates stay in ascending-index order per chunk, so a
                # stable merge keeps the lowest-index tie rule
                v, pos = topk_lowest_index(v, min(k, v.shape[0]), i)
                i = i[pos]
            best_v, best_i = v, i
        vals.append(best_v)
        idx.append(best_i)
        counts.append(cnt)
    return torch.stack(vals), torch.stack(idx), torch.stack(counts)
