"""The bitplane store and its exact top-k search on one device (twin of the
bitplane half of ``gpusimilarity_tpu/parallel/sharded.py``).

The library is one shard on one GPU. Planes are stored plain plane-major,
``int32 [(bitcount + 1), n_padded / 32]`` in global column order, with the
all-zero sentinel plane last; popcounts are a flat ``int16 [n_padded]``.

Left out on purpose:

* the JAX store's 8-sub-row interleave and its ``pops3`` popcount layout
  (``sharded.py:341-357``, ``pallas_bitplane.py:370-385``). They exist so a
  TPU plane read fills whole (8, 128) register tiles. On a GPU, neighbouring
  threads reading neighbouring words of one plain row are already coalesced,
  so the plain layout is the fast one and needs no second popcount copy;
* the JAX ``small`` path (``:1189-1198``) and the ``pallas_ok`` gate
  (``:1076-1084``), which bypass the kernel. Block and word selection stay
  exact when there are no more blocks than k (they then keep every block),
  so every search on a CUDA device goes through the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.bitplane import (
    counters_to_counts,
    planes_from_rows,
    wallace_popcount_planes,
)
from ..ops.bitplane_phase1 import BLOCK_WORDS, bitplane_phase1_batched
from ..ops.scan import TANIMOTO, popcount_rows, similarity_from_counts
from ..ops.topk import topk_lowest_index

# two-phase top-k granularity: candidate blocks of 2048 columns
SELECT_BLOCK_COLS = 32 * BLOCK_WORDS
NEG_INF = float("-inf")
_POP_CHUNK_ROWS = 1 << 22


@dataclass(frozen=True)
class BitplaneStore:
    """Bit-transposed fingerprints resident on one device."""

    planes: torch.Tensor  # int32 (bitcount + 1, n_padded // 32)
    popcounts: torch.Tensor  # int16 (n_padded,)
    n_valid: int  # real row count; padded tail columns are masked out
    bitcount: int

    @property
    def n_padded(self) -> int:
        return self.planes.shape[1] * 32

    @property
    def nbytes(self) -> int:
        return self.planes.numel() * 4 + self.popcounts.numel() * 2


def plan_bitplane_layout(n: int) -> int:
    """Padded column count for ``n`` rows: a multiple of the 2048-column
    selection block (at least one block)."""
    return -(-max(n, 1) // SELECT_BLOCK_COLS) * SELECT_BLOCK_COLS


def build_bitplane_store(
    packed_rows, device: torch.device | str = "cpu"
) -> BitplaneStore:
    """Build a store from packed rows: numpy ``uint32 (N, W)`` (uploaded
    to ``device``) or an int32 tensor already on the device. The
    transpose runs on the device."""
    if isinstance(packed_rows, np.ndarray):
        rows = torch.from_numpy(
            np.ascontiguousarray(packed_rows, dtype=np.uint32).view(np.int32)
        ).to(device)
    else:
        rows = packed_rows
        if rows.dtype != torch.int32 or rows.dim() != 2:
            raise ValueError("packed rows must be int32 (N, W)")
    n, w = rows.shape
    n_padded = plan_bitplane_layout(n)
    planes = planes_from_rows(rows, n_padded, extra_planes=1)
    pops = torch.zeros(n_padded, dtype=torch.int16, device=rows.device)
    for lo in range(0, n, _POP_CHUNK_ROWS):
        hi = min(n, lo + _POP_CHUNK_ROWS)
        pops[lo:hi] = popcount_rows(rows[lo:hi]).to(torch.int16)
    return BitplaneStore(planes=planes, popcounts=pops, n_valid=n, bitcount=32 * w)


def bitplane_local_topk(
    store: BitplaneStore,
    plane_idx: torch.Tensor,  # int32 (B, P), sentinel == bitcount
    query_pops: torch.Tensor,  # int32 (B,)
    cutoffs: torch.Tensor,  # f32 (B,)
    k: int,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bitplane scan and exact top-k: ``(values f32 (B, k), indices int64
    (B, k), counts int64 (B,))``. Entries past the matches are -inf / -1.

    Phase 1 (the kernel) gives per-word maxima. Selection then takes the
    top-k blocks by block maximum, the top-k words within them by word
    maximum, and rescores those k words' 32 columns exactly. Exactness is
    the two-phase argument twice: a word outside the top-k blocks is
    outranked by >= k block maxima, a column outside the top-k words by
    >= k word maxima, so the returned score multiset is exact (indices of
    equal-scoring boundary rows may differ from a dense scan's).
    """
    planes, pops = store.planes, store.popcounts
    dev = planes.device
    alpha_beta = torch.tensor([alpha, beta], dtype=torch.float32, device=dev)
    block_max, counts, colmax = bitplane_phase1_batched(
        planes, pops, plane_idx, query_pops, cutoffs, alpha_beta,
        store.n_valid, similarity,
    )
    b = plane_idx.shape[0]
    n_blocks = block_max.shape[1]
    k_blocks = min(k, n_blocks)
    _, selb = topk_lowest_index(block_max, k_blocks)
    selb = torch.sort(selb, dim=-1).values
    widx = (
        selb[:, :, None] * BLOCK_WORDS
        + torch.arange(BLOCK_WORDS, device=dev)
    ).reshape(b, -1)  # (B, k_blocks * 64) candidate words, ascending
    wmax = torch.gather(colmax, 1, widx)
    k_words = min(k, widx.shape[1])
    _, wpos = topk_lowest_index(wmax, k_words)
    w_sel = torch.gather(widx, 1, wpos)  # (B, k_words)

    # exact rescore of the selected words: (P, B, k_words) plane words
    pw = planes[plane_idx.to(torch.int64).T[:, :, None], w_sel[None, :, :]]
    common = counters_to_counts(wallace_popcount_planes(pw))  # (B, kw*32)
    cols = (
        w_sel[:, :, None] * 32 + torch.arange(32, device=dev)
    ).reshape(b, -1)
    s = similarity_from_counts(
        common, pops[cols], query_pops, similarity, alpha, beta
    )
    s = torch.where(cols < store.n_valid, s, NEG_INF)
    kc = min(k, s.shape[1])
    vals, pos = topk_lowest_index(s, kc, tiebreak=cols)
    idx = torch.gather(cols, 1, pos)
    if kc < k:
        vals = torch.cat(
            [vals, torch.full((b, k - kc), NEG_INF, device=dev)], dim=1
        )
        idx = torch.cat(
            [idx, torch.full((b, k - kc), -1, dtype=torch.int64, device=dev)],
            dim=1,
        )
    return vals, idx, counts.to(torch.int64)
