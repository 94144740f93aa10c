"""The device stores, their exact top-k searches and the sharded library
(twin of ``gpusimilarity_tpu/parallel/sharded.py``).

A library is cut into contiguous row spans, one per shard of a
:class:`~.mesh.Mesh` (:func:`plan_shard_spans`), and each shard is an
ordinary single-device store (:class:`ShardedStore`). A search runs each
shard's store search (its kernel), offsets the shard's candidates to global
rows and merges them (:func:`sharded_local_topk`); the per-shard counts are
summed in int64. Two stores:

* :class:`BitplaneStore`: planes stored plain plane-major,
  ``int32 [(bitcount + 1), n_padded / 32]`` in global column order, with
  the all-zero sentinel plane last; popcounts a flat ``int16 [n_padded]``.
  Searched by :func:`bitplane_local_topk` (kernel 1, then the rescore
  kernel of selection stage 3).
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

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.bitplane import planes_from_rows
from ..ops import fold as fold_ops
from ..ops.bitplane_phase1 import BLOCK_WORDS, bitplane_phase1_batched
from ..ops.bitplane_rescore import bitplane_rescore
from ..ops.dense_phase1 import dense_phase1
from ..ops.scan import (
    TANIMOTO,
    popcount_rows,
    popcount_words,
    score_columns,
)
from ..ops.topk import merge_topk, topk_lowest_index
from .mesh import Mesh, resolve_device

# two-phase top-k granularity: candidate blocks of 2048 columns
SELECT_BLOCK_COLS = 32 * BLOCK_WORDS
# dense selection block: 256 columns (the kernel header says why)
DENSE_BLOCK_COLS = 256
NEG_INF = float("-inf")
_POP_CHUNK_ROWS = 1 << 22
# upload slab of both stores: rows folded on the host and transposed on the
# device (a multiple of 32, so a bitplane slab fills whole plane words)
_SLAB_ROWS = 1 << 21
# dense phase 2 rescores its candidate columns in (query, block) chunks whose
# gathered words stay under this many bytes (its temporaries are a few times
# the chunk's (queries, columns) int32, within the same order)
_PHASE2_CHUNK_BYTES = 1 << 30


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


def empty_bitplane_store(n: int, bitcount: int, device: torch.device) -> BitplaneStore:
    """A store of ``n`` rows with every plane and popcount zero, for
    :func:`fill_bitplane_slab` to fill."""
    n_padded = plan_bitplane_layout(n)
    return BitplaneStore(
        planes=torch.zeros((bitcount + 1, n_padded // 32), dtype=torch.int32,
                           device=device),
        popcounts=torch.zeros(n_padded, dtype=torch.int16, device=device),
        n_valid=n, bitcount=bitcount,
    )


def fill_bitplane_slab(store: BitplaneStore, row0: int, rows: torch.Tensor) -> None:
    """Write packed rows ``int32 (m, W)`` on the store's device into columns
    ``[row0, row0 + m)`` of ``store``, in place: their plane words (``row0``
    a multiple of 32; a slab that ends inside a word leaves that word's other
    bits zero, so only the last slab may) and their popcounts."""
    m, w = rows.shape
    if row0 % 32 or 32 * w != store.bitcount:
        raise ValueError("a slab starts on a plane word and has the store's width")
    words = -(-m // 32)
    store.planes[:32 * w, row0 // 32:row0 // 32 + words] = planes_from_rows(
        rows, 32 * words
    )
    store.popcounts[row0:row0 + m] = popcount_rows(rows).to(torch.int16)


def build_bitplane_store(
    packed_rows,
    device: torch.device | str | None = None,
    fold_factor: int = 1,
) -> BitplaneStore:
    """Build a store from packed rows ``(N, W)``: numpy ``uint32`` (an
    array, a memory map or a lazy :class:`~..utils.synth.VirtualWords`)
    uploaded to ``device`` (the card unless told otherwise), or an int32
    tensor on a device (the store's, unless ``device`` names another).

    Rows stream in slabs of 2Mi: the planes are allocated once, then each
    slab is read, OR-folded (:func:`~..ops.fold.fold_words`, on the host for
    numpy rows), uploaded, transposed into its plane words on the device and
    dropped, so the device never holds the rows beside the planes and the
    host never copies a memory map whole."""
    n, w = packed_rows.shape
    if w % fold_factor:
        raise ValueError(f"fold factor {fold_factor} does not divide {w} words")
    if isinstance(packed_rows, torch.Tensor):
        if packed_rows.dtype != torch.int32 or packed_rows.dim() != 2:
            raise ValueError("packed rows must be int32 (N, W)")
        device = packed_rows.device if device is None else torch.device(device)
    else:
        device = resolve_device(device)
    store = empty_bitplane_store(n, 32 * (w // fold_factor), device)
    for s in range(0, n, _SLAB_ROWS):
        fill_bitplane_slab(
            store, s, _folded_slab(packed_rows, s, min(n, s + _SLAB_ROWS),
                                   fold_factor, device),
        )
    return store


def _folded_slab(packed_rows, s: int, e: int, fold_factor: int, device) -> torch.Tensor:
    """Rows ``[s, e)`` of a store build's source, OR-folded, as int32 on
    ``device``: folded on the source's device when it is a tensor, on the
    host before the upload when it is numpy."""
    if isinstance(packed_rows, torch.Tensor):
        return fold_ops.fold_words(packed_rows[s:e], fold_factor).to(device)
    rows = np.asarray(packed_rows[s:e], dtype=np.uint32)
    folded = np.ascontiguousarray(fold_ops.fold_words(rows, fold_factor))
    if not folded.flags.writeable:  # a slab of a read-only memory map
        folded = folded.copy()
    return torch.from_numpy(folded.view(np.int32)).to(device)


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
    alpha_beta = torch.tensor([alpha, beta], dtype=torch.float32,
                              device=store.planes.device)
    block_max, counts, colmax = bitplane_phase1_batched(
        store.planes, store.popcounts, plane_idx, query_pops, cutoffs,
        alpha_beta, store.n_valid, similarity,
    )
    w_sel = select_words(colmax, select_blocks(block_max, k), k)
    vals, idx = rescore_words(store, plane_idx, query_pops, w_sel, k,
                              similarity, alpha, beta)
    return vals, idx, counts.to(torch.int64)


def select_blocks(block_max: torch.Tensor, k: int) -> torch.Tensor:
    """Selection stage 1: the top-k blocks of each query by block maximum,
    ascending, int64 ``(B, min(k, n_blocks))``."""
    _, selb = topk_lowest_index(block_max, min(k, block_max.shape[1]))
    return torch.sort(selb, dim=-1).values


def select_words(colmax: torch.Tensor, selb: torch.Tensor, k: int) -> torch.Tensor:
    """Selection stage 2: the top-k plane words by word maximum within the
    blocks ``selb``, int64 ``(B, k_words)``."""
    widx = (
        selb[:, :, None] * BLOCK_WORDS
        + torch.arange(BLOCK_WORDS, device=selb.device)
    ).reshape(selb.shape[0], -1)  # (B, k_blocks * 64) candidate words, ascending
    wmax = torch.gather(colmax, 1, widx)
    _, wpos = topk_lowest_index(wmax, min(k, widx.shape[1]))
    return torch.gather(widx, 1, wpos)


def rescore_words(
    store: BitplaneStore,
    plane_idx: torch.Tensor,
    query_pops: torch.Tensor,
    w_sel: torch.Tensor,
    k: int,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Selection stage 3: the exact scores of the 32 columns of each
    selected word (:func:`~..ops.bitplane_rescore.bitplane_rescore`: one
    kernel launch on a card, the carry-save chain on the host) and their
    lowest-index top-k, ``(values (B, k), indices (B, k))``."""
    s, cols = bitplane_rescore(
        store.planes, store.popcounts, plane_idx, query_pops, w_sel,
        store.n_valid, similarity, alpha, beta,
    )
    return _topk_padded(s, cols, k)


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
    unless told otherwise), or an int32 tensor on a device (the store's,
    unless ``device`` names another).

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
    if isinstance(packed_rows, torch.Tensor):
        if packed_rows.dtype != torch.int32 or packed_rows.dim() != 2:
            raise ValueError("packed rows must be int32 (N, W)")
        device = packed_rows.device if device is None else torch.device(device)
    else:
        device = resolve_device(device)
    words = torch.zeros(
        (w // fold_factor, plan_store_layout(n)), dtype=torch.int32, device=device
    )
    for s in range(0, n, _SLAB_ROWS):
        e = min(n, s + _SLAB_ROWS)
        words[:, s:e] = _folded_slab(packed_rows, s, e, fold_factor, device).T
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
    columns exactly with plain tensor ops, in chunks of bounded size.
    Exact, ties included: a column outside the selected blocks is
    outranked, in (score, lowest index) order, by each selected block's best
    column, and there are k of them.
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

    # Phase 2 in (query, block-group) chunks of at most `budget` blocks, so
    # the gathered words stay under _PHASE2_CHUNK_BYTES whatever B and k
    # (k = 131,072 blocks at B = 64 would gather 69 GB at once). Each chunk's
    # columns merge into the running per-query top-k; the keys of
    # topk_lowest_index are distinct, so the merge returns exactly the top-k
    # of all candidates at any chunk size. One chunk covers the batch at
    # serving shapes (B = 32, k = 2048: 0.5 GB).
    budget = max(1, _PHASE2_CHUNK_BYTES // (wf * block * 4))
    q_step = max(1, min(b, budget // k_blocks))
    kb_step = k_blocks if q_step * k_blocks <= budget else budget
    offsets = torch.arange(block, device=dev)
    out = []
    for q0 in range(0, b, q_step):
        q1 = min(b, q0 + q_step)
        best = None
        for j0 in range(0, k_blocks, kb_step):
            sel = selb[q0:q1, j0:j0 + kb_step]
            cand = words.view(wf, n_blocks, block)[:, sel].reshape(wf, q1 - q0, -1)
            cand_pops = (
                None if pops is None
                else pops.view(n_blocks, block)[sel].reshape(q1 - q0, -1)
            )
            s = score_columns(
                cand, cand_pops, queries[q0:q1], query_pops[q0:q1], similarity,
                alpha, beta,
            )
            cols = (sel[:, :, None] * block + offsets).reshape(q1 - q0, -1)
            s = torch.where(cols < store.n_valid, s, NEG_INF)
            if best is not None:
                s, cols = torch.cat([best[0], s], dim=1), torch.cat([best[1], cols], dim=1)
            last = j0 + kb_step >= k_blocks
            best = _topk_padded(s, cols, k if last else min(k, s.shape[1]))
        out.append(best)
    if len(out) == 1:
        return (*out[0], counts)
    return (torch.cat([v for v, _ in out]), torch.cat([i for _, i in out]), counts)


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


# ------------------------------------------------------------------ shards


@dataclass(frozen=True)
class ShardedStore:
    """A library cut into contiguous row spans over a mesh's shards: this
    process's shard stores in mesh order, each shard's first global row,
    and the global layout (every process derives the same one)."""

    shards: tuple  # this process's BitplaneStore or DenseStore per shard
    row0s: tuple[int, ...]  # first global row of each local shard
    n_valid: int  # global row count
    n_shards: int  # shards over every process
    per_shard: int  # rows of every shard's span in the padded layout
    mesh: Mesh

    @property
    def n_padded(self) -> int:
        return self.per_shard * self.n_shards

    @property
    def nbytes(self) -> int:
        """Device bytes of this process's shards."""
        return sum(s.nbytes for s in self.shards)

    @property
    def local_rows(self) -> int:
        """Library rows in this process's shards: the only rows it read."""
        return sum(s.n_valid for s in self.shards)


def shard_rows(n: int, n_shards: int, align: int) -> int:
    """Rows of every shard's span in the padded layout of ``n`` rows:
    ``ceil(n / n_shards)`` rounded up to ``align`` (at least ``align``)."""
    per = -(-max(n, 1) // n_shards)
    return -(-per // align) * align


def plan_shard_spans(n: int, n_shards: int, align: int) -> list[tuple[int, int]]:
    """Each shard's global row span ``[lo, hi)`` for ``n`` rows, in shard
    order: spans of :func:`shard_rows`, the last real one cut at ``n`` (the
    JAX ``plan_store_layout``). Every process derives the same spans without
    communicating. A shard past ``n`` holds only padding: ``lo == hi``, and
    its search returns -inf / -1 and a count of 0."""
    per = shard_rows(n, n_shards, align)
    return [(s * per, max(s * per, min(n, (s + 1) * per))) for s in range(n_shards)]


def shard_align(scan_mode: str) -> int:
    """Rows a shard's span is a multiple of: the store's selection block, so
    every shard but the last holds whole blocks and no padding."""
    return SELECT_BLOCK_COLS if scan_mode == "bitplane" else DENSE_BLOCK_COLS


def build_sharded_store(
    packed_rows,
    mesh: Mesh,
    scan_mode: str = "bitplane",
    fold_factor: int = 1,
    popless: bool = False,
) -> ShardedStore:
    """Build this process's shards of a library from its packed rows
    ``(N, W)`` (numpy, a memory map, a tensor or a lazy
    :class:`~..utils.synth.VirtualWords`): each local shard's span streams
    through the slab builders (:func:`build_bitplane_store`,
    :func:`build_store`) onto its device, or a virtual library's span is
    generated there, so no device ever holds more than its shards and the
    process reads no row outside its shards' spans."""
    from ..utils import synth

    n, w = packed_rows.shape
    align = shard_align(scan_mode)
    spans = plan_shard_spans(n, mesh.n_shards, align)
    local = spans[mesh.first_shard:mesh.first_shard + len(mesh.devices)]
    virtual = isinstance(packed_rows, synth.VirtualWords)
    shards = []
    for dev, (lo, hi) in zip(mesh.devices, local):
        if virtual and scan_mode == "bitplane":
            shard = synth.build_virtual_bitplane_store(
                hi - lo, fold_factor, w, packed_rows.seed, device=dev, row0=lo)
        elif virtual:
            shard = synth.build_virtual_dense_store(
                hi - lo, fold_factor, w, packed_rows.seed, popless=popless,
                device=dev, row0=lo)
        elif scan_mode == "bitplane":
            shard = build_bitplane_store(packed_rows[lo:hi], dev, fold_factor)
        else:
            shard = build_store(packed_rows[lo:hi], dev, fold_factor, popless)
        shards.append(shard)
    return ShardedStore(
        shards=tuple(shards), row0s=tuple(lo for lo, _ in local), n_valid=n,
        n_shards=mesh.n_shards, per_shard=shard_rows(n, mesh.n_shards, align),
        mesh=mesh,
    )


def _global_rows(vals, idx, row0: int):
    """A shard's candidate indices as global rows: ``idx + row0``, and -1
    where the score is -inf (padding, or fewer matches than k). The local
    searches already pad to k (the JAX ``_pad_to_k``)."""
    return torch.where(vals > NEG_INF, idx + row0, -1)


def sharded_local_topk(
    store: ShardedStore,
    queries: np.ndarray,  # int32 (B, Wf) folded words, or (B, P) plane lists
    query_pops: np.ndarray,  # int32 (B,)
    cutoffs: np.ndarray,  # f32 (B,)
    k: int,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k over every shard: ``(values f32 (B, k), indices int64
    (B, k), counts int64 (S, B))``, host tensors, the same on every process.

    Each shard runs its store's search (:func:`bitplane_local_topk` or
    :func:`dense_local_topk`: its kernel on the card) for ``queries`` (the
    folded words of a dense store, the plane lists of a bitplane store); the
    shards of one device run in turn on one worker thread, the devices'
    threads at once, so cards overlap. Each shard's candidates are offset to
    global rows, gathered from every process
    (:func:`~.multihost.gather_shard_candidates`) and merged
    (:func:`~..ops.topk.merge_topk`). The counts travel un-summed, one row
    per shard: the caller sums them in int64 (an int32 sum overflows past
    2.1B rows). Inside a served pass (:mod:`~..serve.spans`) the time until
    every device's work is queued is its stage ``launch``, from then until
    the last copy back is done its stage ``wait``, and the merge its stage
    ``shard_merge``; each device's worker gives its spans ``card.launch``
    and ``card.wait``, and the spread of their ends the pass's card lag.
    """
    from ..serve import spans
    from . import multihost

    span = spans.current_pass()
    start = spans.now()

    mesh = store.mesh
    b = queries.shape[0]
    by_device: dict[torch.device, list[int]] = {}
    for j, dev in enumerate(mesh.devices):
        by_device.setdefault(dev, []).append(j)

    def search(dev):
        began = spans.now()
        # the kernel wrappers make each launch's device current themselves
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
        qp = torch.from_numpy(np.ascontiguousarray(query_pops)).to(dev)
        ct = torch.from_numpy(np.ascontiguousarray(cutoffs)).to(dev)
        parts = []
        for j in by_device[dev]:
            shard = store.shards[j]
            local = (bitplane_local_topk if isinstance(shard, BitplaneStore)
                     else dense_local_topk)
            v, i, c = local(shard, q, qp, ct, k, similarity, alpha, beta)
            parts.append((v, _global_rows(v, i, store.row0s[j]), c))
        # one copy to the host per device, after every shard is queued: the
        # host launches a shard's ops while the card runs the last's
        stacked = [torch.stack([p[f] for p in parts]) for f in range(3)]
        queued = spans.now()
        v, i, c = (t.cpu() for t in stacked)
        card = (began, queued, spans.now(), threading.get_native_id())
        return {j: (v[n], i[n], c[n]) for n, j in enumerate(by_device[dev])}, card

    def run_all():
        if len(by_device) == 1:
            results = [search(mesh.devices[0])]
        else:
            # a thread of its own for each device: a pool may hand a second
            # device to a worker that finished its first, running them in turn
            results = [None] * len(by_device)

            def work(n, dev):
                try:
                    results[n] = search(dev)
                except BaseException as exc:  # re-raised on the pass's thread
                    results[n] = exc

            threads = [threading.Thread(target=work, args=(n, dev))
                       for n, dev in enumerate(by_device)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for r in results:
                if isinstance(r, BaseException):
                    raise r
        done, cards = {}, []
        for part, card in results:
            done.update(part)
            cards.append(card)
        queued = max(c[1] for c in cards)
        span.stage(spans.LAUNCH, start, queued)
        waited = span.stage(spans.PASS_WAIT, queued)
        span.card_spans(cards)
        return done, waited

    try:
        (done, waited), failure = run_all(), None
    except Exception as exc:  # re-raised below, after the collective
        if mesh.n_processes == 1:
            raise
        # a process whose shard search fails still joins the gather, with
        # counts of -1, so every process raises instead of waiting
        failure, waited = exc, spans.now()
        done = {j: (torch.full((b, k), NEG_INF), torch.full((b, k), -1),
                    torch.full((b,), -1)) for j in range(len(mesh.devices))}
    parts = [done[j] for j in range(len(mesh.devices))]
    vals, idx, counts = (torch.stack([p[f] for p in parts]) for f in range(3))
    vals, idx, counts = multihost.gather_shard_candidates(vals, idx, counts, mesh)
    if failure is not None:
        raise failure
    if bool((counts < 0).any()):
        raise RuntimeError("a shard search failed on another process")
    vals, idx = merge_topk(vals.transpose(0, 1), idx.transpose(0, 1), k)
    span.stage(spans.SHARD_MERGE, waited)
    return vals, idx, counts
