"""Judge served answers against the reference's.

Every number here is a count of faults, held to the limit 0: the server
promises exact scores and a deterministic order, so any difference is a
fault and not a rounding. A served row is judged by what it says: its id
names a row (and its SMILES must be that row's), its score must equal the
exact float32 score of that row against the query, and its rank key
(exact score desc, index asc) must be at least the reference's at the same
rank. At fold 1 the reference's answer is the exact top ``k``, so the
served answer must equal it; at fold ``f`` > 1 it is the answer from the
stated candidate count, which a server may match or beat, never fall below.
"""

from __future__ import annotations

import numpy as np

from .rows import popcount_np, rows_np
from .search import Answer, tanimoto_np

# each number compared, with its limit (sound runs read 0 on every seed;
# the controls read hundreds: PERF.md)
LIMITS = {
    "unanswered": 0,
    "wrong_rows": 0,
    "misordered": 0,
    "short_ranks": 0,
    "wrong_counts": 0,
}


def _key(score: float, idx: int) -> tuple:
    return (score, -idx)


def judge(served: list, reference: list[Answer], query_rows: np.ndarray,
          words: int, seed: int, decode_id, smiles_of,
          unanswered: int) -> tuple[dict, list]:
    """Numbers for a list of served payloads (the parsed JSON of each
    checked request, or None where the request failed) against the
    reference's answers for the same queries. ``decode_id`` maps an id
    string to its row index (None when it names no row), ``smiles_of`` a row
    index to the SMILES the library holds for it. ``unanswered`` is the
    count of requests in the window that got no good reply. Returns the
    numbers and, for each answer, whether it added to any of them."""
    qfull = rows_np(query_rows, words, seed)
    qpop = popcount_np(qfull)
    n = {name: 0 for name in LIMITS}
    n["unanswered"] = int(unanswered)
    faulty = []
    for i, (payload, ref) in enumerate(zip(served, reference)):
        before = sum(n.values())
        if payload is None:
            n["short_ranks"] += max(1, len(ref.idx))
            faulty.append(True)
            continue
        rows = payload.get("results", [])
        idx = [decode_id(r[0]) if isinstance(r, list) and len(r) == 3 else None
               for r in rows]
        known = [j for j in idx if j is not None]
        exact = {}
        if known:
            full = rows_np(np.array(known, np.int64), words, seed)
            scores = tanimoto_np(popcount_np(full & qfull[i]), qpop[i], popcount_np(full))
            exact = dict(zip(known, scores.tolist()))
        keys = []
        for row, j in zip(rows, idx):
            if j is None:
                n["wrong_rows"] += 1
                keys.append((-np.inf, 0))
                continue
            _, smiles, score = row
            if (smiles != smiles_of(j) or not isinstance(score, (int, float))
                    or np.float32(score) != np.float32(exact[j])):
                n["wrong_rows"] += 1
            keys.append(_key(exact[j], j))
        n["misordered"] += sum(1 for a, b in zip(keys, keys[1:]) if not a > b)
        for r, (ri, rs) in enumerate(zip(ref.idx.tolist(), ref.scores.tolist())):
            if r >= len(keys) or keys[r] < _key(rs, ri):
                n["short_ranks"] += 1
        n["short_ranks"] += max(0, len(keys) - len(ref.idx))
        if payload.get("approximate_count") != ref.count:
            n["wrong_counts"] += 1
        faulty.append(sum(n.values()) > before)
    return n, faulty


def passes(numbers: dict) -> bool:
    return all(numbers[name] <= limit for name, limit in LIMITS.items())
