"""The device stores and their exact top-k searches on one device (twin of
``gpusimilarity_tpu/parallel/sharded.py``).

The library is one shard on one GPU. Two stores:

* :class:`BitplaneStore`: planes stored plain plane-major,
  ``int32 [(bitcount + 1), n_padded / 32]`` in global column order, with
  the all-zero sentinel plane last; popcounts a flat ``int16 [n_padded]``.
  Searched by :func:`bitplane_local_topk` (kernel 1).
* :class:`DenseStore`: the (folded) packed words planar,
  ``int32 [Wf, n_padded]``, column = row index; popcounts ``int16
  [n_padded]``, or None for a popless store. Searched by
  :func:`dense_local_topk` (kernel 2). Every folded library is served
  dense.

Left out on purpose:

* the JAX store's 8-sub-row interleave and its ``pops3`` popcount layout
  (``sharded.py:341-357``, ``pallas_bitplane.py:370-385``). They exist so a
  TPU plane read fills whole (8, 128) register tiles. On a GPU, neighbouring
  threads reading neighbouring words of one plain row are already coalesced,
  so the plain layout is the fast one and needs no second popcount copy;
* the JAX ``small`` paths (``:702-732``, ``:1189-1198``) and the
  ``dense_pallas_ok``/``pallas_ok`` gates (``:735``, ``:1076-1084``), which
  bypass the kernels. Selection stays exact when there are no more blocks
  than k (it then keeps every block), so every search on a CUDA device goes
  through a kernel;
* the dense two-level ``_select_candidate_blocks`` (``:820-856``). It bounds
  a TPU ``top_k`` and gives up lowest-index ties at ``k_blocks >= 512``;
  one direct lowest-index top-k over the block maxima keeps the
  reference's tie rule at every k.
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
from ..ops import fold as fold_ops
from ..ops.bitplane_phase1 import BLOCK_WORDS, bitplane_phase1_batched
from ..ops.dense_phase1 import dense_phase1
from ..ops.scan import (
    TANIMOTO,
    popcount_rows,
    popcount_words,
    score_columns,
    similarity_from_counts,
)
from ..ops.topk import topk_lowest_index
from .mesh import resolve_device

# two-phase top-k granularity: candidate blocks of 2048 columns
SELECT_BLOCK_COLS = 32 * BLOCK_WORDS
# dense selection block: 256 columns (the kernel header says why)
DENSE_BLOCK_COLS = 256
NEG_INF = float("-inf")
_POP_CHUNK_ROWS = 1 << 22
# dense upload slab: rows folded on the host and transposed on the device
_SLAB_ROWS = 1 << 21


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
    packed_rows, device: torch.device | str | None = None
) -> BitplaneStore:
    """Build a store from packed rows: numpy ``uint32 (N, W)`` (uploaded
    to ``device``, the card unless told otherwise) or an int32 tensor
    already on its device. The transpose runs on the device."""
    if isinstance(packed_rows, np.ndarray):
        rows = torch.from_numpy(
            np.ascontiguousarray(packed_rows, dtype=np.uint32).view(np.int32)
        ).to(resolve_device(device))
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
    vals, idx = _topk_padded(s, cols, k)
    return vals, idx, counts.to(torch.int64)


def _topk_padded(scores, cols, k):
    """Lowest-index top-k of candidate ``scores (B, M)`` at columns
    ``cols (B, M)``, padded with -inf / -1 to k entries."""
    b = scores.shape[0]
    dev = scores.device
    kc = min(k, scores.shape[1])
    vals, pos = topk_lowest_index(scores, kc, tiebreak=cols)
    idx = torch.gather(cols, 1, pos)
    if kc < k:
        vals = torch.cat(
            [vals, torch.full((b, k - kc), NEG_INF, device=dev)], dim=1
        )
        idx = torch.cat(
            [idx, torch.full((b, k - kc), -1, dtype=torch.int64, device=dev)],
            dim=1,
        )
    return vals, idx


# ------------------------------------------------------------------- dense


@dataclass(frozen=True)
class DenseStore:
    """(Folded) packed words resident on one device, planar."""

    words: torch.Tensor  # int32 (Wf, n_padded); column j is row j
    popcounts: torch.Tensor | None  # int16 (n_padded,), None when popless
    n_valid: int  # real row count; padded tail columns are masked out

    @property
    def n_padded(self) -> int:
        return self.words.shape[1]

    @property
    def word_count(self) -> int:
        return self.words.shape[0]

    @property
    def nbytes(self) -> int:
        pops = 0 if self.popcounts is None else self.popcounts.numel() * 2
        return self.words.numel() * 4 + pops


def plan_store_layout(n: int) -> int:
    """Padded column count of a dense store of ``n`` rows: a multiple of
    the 256-column selection block (at least one block)."""
    return -(-max(n, 1) // DENSE_BLOCK_COLS) * DENSE_BLOCK_COLS


def dense_popcounts(words: torch.Tensor) -> torch.Tensor:
    """Column popcounts ``int16 (N,)`` of planar words ``int32 (Wf, N)``."""
    n = words.shape[1]
    pops = torch.empty(n, dtype=torch.int16, device=words.device)
    for lo in range(0, n, _POP_CHUNK_ROWS):
        hi = min(n, lo + _POP_CHUNK_ROWS)
        pops[lo:hi] = popcount_words(words[:, lo:hi]).sum(dim=0).to(torch.int16)
    return pops


def build_store(
    packed_rows,
    device: torch.device | str | None = None,
    fold_factor: int = 1,
    popless: bool = False,
) -> DenseStore:
    """Build a planar dense store from packed rows ``(N, W)``: numpy
    ``uint32`` — an array, a memory map or a lazy
    :class:`~..utils.synth.VirtualWords` — uploaded to ``device`` (the card
    unless told otherwise), or an int32 tensor already on its device.

    Rows stream in slabs of 2Mi: each slab is read once, OR-folded
    (:func:`~..ops.fold.fold_words`, on the host for numpy rows), uploaded
    and transposed into its columns on the device, so neither the
    full-width source nor the folded matrix is ever materialised whole.
    Popcounts are computed on the device from the uploaded words; a
    popless store keeps none.
    """
    n, w = packed_rows.shape
    if w % fold_factor:
        raise ValueError(f"fold factor {fold_factor} does not divide {w} words")
    on_device = isinstance(packed_rows, torch.Tensor)
    if on_device:
        if packed_rows.dtype != torch.int32 or packed_rows.dim() != 2:
            raise ValueError("packed rows must be int32 (N, W)")
        device = packed_rows.device
    else:
        device = resolve_device(device)
    words = torch.zeros(
        (w // fold_factor, plan_store_layout(n)), dtype=torch.int32, device=device
    )
    for s in range(0, n, _SLAB_ROWS):
        e = min(n, s + _SLAB_ROWS)
        if on_device:
            folded = fold_ops.fold_words(packed_rows[s:e], fold_factor)
        else:
            rows = np.asarray(packed_rows[s:e], dtype=np.uint32)
            folded = np.ascontiguousarray(fold_ops.fold_words(rows, fold_factor))
            folded = torch.from_numpy(folded.view(np.int32)).to(device)
        words[:, s:e] = folded.T
    pops = None if popless else dense_popcounts(words)
    return DenseStore(words=words, popcounts=pops, n_valid=n)


def dense_local_topk(
    store: DenseStore,
    queries: torch.Tensor,  # int32 (B, Wf), folded like the store
    query_pops: torch.Tensor,  # int32 (B,)
    cutoffs: torch.Tensor,  # f32 (B,)
    k: int,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
    block: int = DENSE_BLOCK_COLS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense scan and exact top-k (twin of ``_local_scan_topk``):
    ``(values f32 (B, k), indices int64 (B, k), counts int64 (B,))``.
    Entries past the matches are -inf / -1.

    Phase 1 (the kernel) gives per-block maxima and counts. One direct
    lowest-index top-k picks the k best blocks, and phase 2 rescores their
    columns exactly with plain tensor ops. Exact, ties included: a column
    outside the selected blocks is outranked, in (score, lowest index)
    order, by each selected block's best column, and there are k of them.
    """
    words, pops = store.words, store.popcounts
    dev = words.device
    wf = words.shape[0]
    b = queries.shape[0]
    alpha_beta = torch.tensor([alpha, beta], dtype=torch.float32, device=dev)
    block_max, counts = dense_phase1(
        words, pops, queries, query_pops, cutoffs, alpha_beta, store.n_valid,
        block, similarity,
    )
    n_blocks = block_max.shape[1]
    k_blocks = min(k, n_blocks)
    _, selb = topk_lowest_index(block_max, k_blocks)
    selb = torch.sort(selb, dim=-1).values  # (B, k_blocks), ascending
    cand = words.view(wf, n_blocks, block)[:, selb].reshape(wf, b, -1)
    cand_pops = (
        None if pops is None else pops.view(n_blocks, block)[selb].reshape(b, -1)
    )
    s = score_columns(
        cand, cand_pops, queries, query_pops, similarity, alpha, beta
    )
    cols = (selb[:, :, None] * block + torch.arange(block, device=dev)).reshape(b, -1)
    s = torch.where(cols < store.n_valid, s, NEG_INF)
    vals, idx = _topk_padded(s, cols, k)
    return vals, idx, counts


def dense_full_scan_topk(
    store: DenseStore,
    queries: torch.Tensor,
    query_pops: torch.Tensor,
    cutoffs: torch.Tensor,
    k: int,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
    chunk_cols: int = 1 << 22,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain full scan of a dense store with no selection: the exact
    lowest-index top-k and the >= cutoff counts, as
    :func:`dense_local_topk` returns them. The test and smoke oracle."""
    words, pops = store.words, store.popcounts
    dev = words.device
    b = queries.shape[0]
    best_v = torch.empty((b, 0), dtype=torch.float32, device=dev)
    best_i = torch.empty((b, 0), dtype=torch.int64, device=dev)
    counts = torch.zeros(b, dtype=torch.int64, device=dev)
    for c0 in range(0, store.n_valid, chunk_cols):
        c1 = min(store.n_valid, c0 + chunk_cols)
        s = score_columns(
            words[:, c0:c1], None if pops is None else pops[c0:c1], queries,
            query_pops, similarity, alpha, beta,
        )
        counts += (s >= cutoffs[:, None]).sum(dim=-1)
        cols = torch.arange(c0, c1, device=dev).expand(b, -1)
        best_v, best_i = _topk_padded(
            torch.cat([best_v, s], dim=1), torch.cat([best_i, cols], dim=1),
            min(k, best_v.shape[1] + c1 - c0),
        )
    return (*_topk_padded(best_v, best_i, k), counts)
