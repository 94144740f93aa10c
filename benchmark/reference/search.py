"""The plain reference: the answers a served search must give, worked out
again from the seed.

For each checked query the reference scans every row of the library,
regenerated by :mod:`.rows`, in blocks on the given device (plain PyTorch:
the rows unpacked to 0/1 half-precision bits, intersection counts by one
matrix product, exact for counts up to 2048), keeps the best candidates by
``(score desc, index asc)``, then finishes on the host in numpy float32:

* unfolded (fold 1): the top ``k`` of the exact full-width Tanimoto scores;
* folded (fold ``f`` > 1): the top ``k_fetch(k, f)`` rows by the folded
  score (bit ``p`` ORed into ``p % (bitcount / f)``, word-level), rescored
  exactly at full width, then the top ``k``. ``k_fetch`` is the reference
  server's overfetch, ``ceil(k * f * log2(2f))``, rounded up to a power of
  two with a floor of 128: the candidate count the configuration states.
  A server that rescored more candidates would rank at least as high.

Scores are ``c / (|q| + |r| - c)`` in float32 (0 where the denominator is
0), the count is the rows whose score (folded, when folded) is at least the
cutoff. Ties go to the lower row index.

Two controls put the reference in the server's place with one guarantee
broken: ``half_scores`` divides in float16 instead of float32, and
``no_rescore`` (folded libraries) returns the folded candidates with their
folded scores, skipping the exact rescore.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .rows import M32, fold_np, fold_torch, popcount_np, rows_np, rows_torch

CONTROLS = ("half_scores", "no_rescore")
# candidates kept per query beyond the count needed, so that a boundary
# decided on the device is decided again on the host
MARGIN = 16


@dataclass
class Answer:
    """One query's answer: row indices in rank order, their float32 scores
    and the count of rows at or above the cutoff."""

    idx: np.ndarray
    scores: np.ndarray
    count: int


def k_fetch(k: int, fold: int, n_rows: int) -> int:
    """Candidates a folded search rescores for a top ``k``."""
    want = k if fold == 1 else math.ceil(k * fold * math.log2(2 * fold))
    return min(max(128, 1 << (max(want, 1) - 1).bit_length()), n_rows)


def tanimoto_np(common, qpop, rpop, dtype=np.float32) -> np.ndarray:
    """``c / (q + r - c)`` rounded once to ``dtype`` (0 where the
    denominator is 0), returned as float32."""
    c = np.asarray(common, np.int64)
    d = np.asarray(qpop, np.int64) + np.asarray(rpop, np.int64) - c
    out = np.zeros(np.broadcast(c, d).shape, dtype)
    ok = d > 0
    out[ok] = (c[ok].astype(dtype) / d[ok].astype(dtype)).astype(dtype)
    return out.astype(np.float32)


def rank(idx: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Positions of ``idx`` ordered by (score desc, index asc)."""
    return np.lexsort((idx, -scores))


def _unpack(words: torch.Tensor, dtype) -> torch.Tensor:
    """int32 ``(n, W)`` rows -> 0/1 ``(n, 32W)`` in ``dtype``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(len(words), -1).to(dtype)


def scan_candidates(n_rows: int, words: int, fold: int, seed: int,
                    queries_folded: np.ndarray, cutoffs: np.ndarray,
                    keep: int, device, block_rows: int | None = None):
    """One pass over every row: for each query the ``keep`` best rows by
    folded score (the full score at fold 1) and the count at or above its
    cutoff. Returns numpy ``(idx int64 (S, keep), counts int64 (S,))``."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    dtype = torch.float16 if on_card else torch.float32
    s = len(queries_folded)
    bits = 32 * (words // fold)
    if block_rows is None:
        # about 2 GiB of unpacked bits a block
        block_rows = max(256, (1 << 30) // bits)
    qw = torch.from_numpy(np.ascontiguousarray(queries_folded).view(np.int32)).to(device)
    q = torch.cat([_unpack(qw, dtype), torch.ones((1, bits), dtype=dtype, device=device)])
    qpop = q[:s].float().sum(1, keepdim=True)
    cut = torch.from_numpy(np.asarray(cutoffs, np.float32)).to(device)[:, None]
    counts = torch.zeros(s, dtype=torch.int64, device=device)
    best = torch.empty((s, 0), dtype=torch.int64, device=device)
    for lo in range(0, n_rows, block_rows):
        m = min(block_rows, n_rows - lo)
        rows = fold_torch(rows_torch(lo, m, words, seed, device), fold)
        prod = (q @ _unpack(rows, dtype).T).float()
        del rows
        common, rpop = prod[:s], prod[s:]
        denom = qpop + rpop - common
        score = torch.where(denom > 0, common / denom.clamp(min=1.0), 0.0)
        del prod, common, rpop, denom
        counts += (score >= cut).sum(1)
        ridx = torch.arange(lo, lo + m, dtype=torch.int64, device=device)
        key = (score.view(torch.int32).to(torch.int64) << 32) | (M32 - ridx)
        del score
        top = key.topk(min(keep, m), dim=1).values
        del key
        best = torch.cat([best, top], 1)
        best = best.topk(min(keep, best.shape[1]), dim=1).values
    idx = M32 - (best & M32)
    return idx.cpu().numpy(), counts.cpu().numpy()


def reference_answers(n_rows: int, words: int, fold: int, seed: int,
                      query_rows: np.ndarray, ks, cutoffs, device,
                      controls=(), block_rows: int | None = None):
    """The reference's answers for library rows ``query_rows`` used as
    queries, and those of each named control. Returns ``(answers,
    {control: answers})``."""
    for c in controls:
        if c not in CONTROLS:
            raise ValueError(f"unknown control {c!r}")
    ks = np.asarray(ks, np.int64)
    cutoffs = np.asarray(cutoffs, np.float32)
    qfull = rows_np(query_rows, words, seed)
    qfold = fold_np(qfull, fold)
    qpop_full, qpop_fold = popcount_np(qfull), popcount_np(qfold)
    need = int(max(k_fetch(int(k), fold, n_rows) if fold > 1 else int(k) for k in ks))
    cand, counts = scan_candidates(n_rows, words, fold, seed, qfold, cutoffs,
                                   min(need + MARGIN, n_rows), device, block_rows)
    out = []
    ctl = {c: [] for c in controls}
    for i in range(len(query_rows)):
        k, cutoff = int(ks[i]), float(cutoffs[i])
        c = cand[i]
        full = rows_np(c, words, seed)
        if fold > 1:
            folded = fold_np(full, fold)
            fscore = tanimoto_np(popcount_np(folded & qfold[i]), qpop_fold[i],
                                 popcount_np(folded))
            pick = rank(c, fscore)[:k_fetch(k, fold, n_rows)]
            c, full, fscore = c[pick], full[pick], fscore[pick]
        common, rpop = popcount_np(full & qfull[i]), popcount_np(full)
        exact = tanimoto_np(common, qpop_full[i], rpop)

        def top(scores, idx=c):
            keep = scores >= cutoff if cutoff > 0 else np.ones(len(idx), bool)
            sel = rank(idx[keep], scores[keep])[:k]
            return idx[keep][sel], scores[keep][sel]

        a_idx, a_scores = top(exact)
        out.append(Answer(a_idx, a_scores, int(counts[i])))
        if "half_scores" in ctl:
            half = tanimoto_np(common, qpop_full[i], rpop, dtype=np.float16)
            ctl["half_scores"].append(Answer(*top(half), int(counts[i])))
        if "no_rescore" in ctl:
            scores = fscore if fold > 1 else exact
            ctl["no_rescore"].append(Answer(*top(scores), int(counts[i])))
    return out, ctl
