"""The least bytes a search pass must move, from the batch's queries and the
configuration, never from the kernels that ran: a change that fuses,
removes or replaces a kernel is read against the same work.

A pass reads each byte it needs once and writes its candidates once:

* bitplane store (``planes (bitcount + 1, n_padded / 32)`` int32 words and
  ``n_padded`` int16 popcounts): the plane words of the union of the batch's
  query bits, the popcounts, and ``k_fetch`` candidates per query (an int32
  score and an int64 index);
* dense store (``words (W / fold, n_padded)`` int32 and int16 popcounts):
  every folded word and popcount, and the candidates.

Divided by the H100 SXM data sheet's 3.35 TB/s, that is the least time the
pass could take; a share of it over the device time measured inside the
pass cannot pass 100% unless the trace misses device work.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
CANDIDATE_BYTES = 4 + 8


def padded_rows(n_rows: int, block: int = 256) -> int:
    """Row columns a store holds: the rows rounded up to a selection block
    (the least padding any layout of the store needs)."""
    return -(-n_rows // block) * block


def bitplane_pass_bytes(n_rows: int, union_bits: float, batch: float,
                        k_fetch: int) -> float:
    n = padded_rows(n_rows)
    return union_bits * (n // 32) * 4 + n * 2 + batch * k_fetch * CANDIDATE_BYTES


def dense_pass_bytes(n_rows: int, folded_words: int, batch: float,
                     k_fetch: int) -> float:
    n = padded_rows(n_rows)
    return n * folded_words * 4 + n * 2 + batch * k_fetch * CANDIDATE_BYTES


def expected_union_bits(query_bits: np.ndarray, batch: float, seed: int,
                        draws: int = 256) -> float:
    """The mean number of distinct set bits in a batch of ``batch`` queries
    drawn from ``query_bits`` (``(Q, bitcount)`` 0/1 rows of the queries the
    window sent), interpolated between whole batch sizes."""
    rng = np.random.default_rng([seed, 3])
    q = len(query_bits)

    def mean_union(b: int) -> float:
        if b <= 1:
            return float(query_bits.sum(1).mean())
        total = 0
        for _ in range(draws):
            pick = rng.choice(q, size=min(b, q), replace=False)
            total += int(query_bits[pick].any(0).sum())
        return total / draws

    lo = max(1, int(np.floor(batch)))
    frac = batch - lo
    u = mean_union(lo)
    return u if frac <= 0 else u + frac * (mean_union(lo + 1) - u)


def least_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
