"""Top-k with the reference's tie rule (lowest index first among equal
scores), as ``jax.lax.top_k`` returns it.

``torch.topk`` promises no order among ties. Packing each float32 score's
order-preserving integer image into the high 32 bits of an int64 key and
the inverted index into the low 32 bits makes every key distinct, so a
top-k over the keys is fully determined: a higher score first, then a
lower index.
"""

from __future__ import annotations

import torch

_LOW32 = (1 << 32) - 1


def _sortable_bits(scores: torch.Tensor) -> torch.Tensor:
    """int32 whose signed order equals the float32 order of ``scores``."""
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    # negative floats order backwards in their bit pattern: flip magnitude
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def topk_lowest_index(
    scores: torch.Tensor, k: int, tiebreak: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis: ``(values, positions int64)``.

    Among equal scores the smaller ``tiebreak`` comes first; by default the
    tiebreak is the position itself. ``tiebreak`` must hold non-negative
    values below 2**32 and broadcast against ``scores``.
    """
    n = scores.shape[-1]
    if tiebreak is None:
        tiebreak = torch.arange(n, dtype=torch.int64, device=scores.device)
    key = (_sortable_bits(scores).to(torch.int64) << 32) | (
        _LOW32 - tiebreak.to(torch.int64)
    )
    _, pos = torch.topk(key, k, dim=-1)
    return torch.gather(scores, -1, pos), pos


def merge_topk(
    vals: torch.Tensor, idx: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard candidate lists into one top-k (twin of the JAX
    ``merge_topk``): ``vals``/``idx`` ``(..., S, k_s)`` with global indices
    become ``(..., k)``.

    Each shard's list is in (score descending, index ascending) order and
    the shards own contiguous row spans in ascending order, so among equal
    scores the lower flattened position is the lower global index: the
    merge takes the lowest position first, as ``jax.lax.top_k`` does, and
    dense ties still go to the lowest global index.
    """
    flat_vals = vals.reshape(*vals.shape[:-2], -1)
    flat_idx = idx.reshape(*idx.shape[:-2], -1)
    top, pos = topk_lowest_index(flat_vals, k)
    return top, torch.gather(flat_idx, -1, pos)
