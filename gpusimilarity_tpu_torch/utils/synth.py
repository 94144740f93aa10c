"""Deterministic virtual fingerprint libraries (twin of
``gpusimilarity_tpu/utils/synth.py``).

A virtual library row is a pure function of its index through the
``lowbias32`` counter mixer, so the card can generate a 10^9-row library in
place while the host recomputes only the few rows a folded search rescores.
Rows come in 256-row clusters sharing a sparse core pattern, each row
keeping ~75% of the core's bits plus its own: ~40 of 1024 bits set, like a
real Morgan fingerprint, with graded neighbours for every query.

The host half (:func:`virtual_rows_np`, :class:`VirtualWords`,
:class:`VirtualFingerprints`, what a synthetic ``.tfsim`` holds) is the
port's copy of the JAX package's numpy code, in uint32. The device half
runs the same mixer in PyTorch, which has no unsigned 32-bit arithmetic, on
int32 views: addition, multiplication and left shifts wrap modulo 2**32 the
same way on either view, ``^ & |`` are bitwise, and the logical right shift
is :func:`~..ops.bitplane.shr`. ``tests/test_torch_synth.py`` pins the two
halves to each other and to the JAX package's, including rows past 2**31.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fold as fold_ops
from ..ops.bitplane import shr, wrap_int32
from ..ops.scan import (
    TANIMOTO,
    popcount_rows,
    popcount_rows_np,
    scores_np,
    similarity_from_counts,
)
from ..ops.topk import topk_lowest_index
from ..parallel.mesh import resolve_device
from ..parallel.sharded import (
    SELECT_BLOCK_COLS,
    BitplaneStore,
    DenseStore,
    empty_bitplane_store,
    fill_bitplane_slab,
    plan_store_layout,
)

#: rows per cluster (shared sparse core pattern)
CLUSTER_ROWS = 256
#: mixer draws per 32-bit word: one (a, b) pair each for cluster and row
NUM_DRAWS = 2

_GOLD = 0x9E3779B9  # 2^32 / golden ratio: decorrelates sequential counters

# rows generated per step on the device (a multiple of CLUSTER_ROWS)
_GEN_ROWS = 1 << 20


def _seed_consts(seed: int):
    s_row = np.uint32((seed * _GOLD + 0x85EBCA6B) & 0xFFFFFFFF)
    s_clu = np.uint32((seed * _GOLD + 0xC2B2AE35) & 0xFFFFFFFF)
    return s_row, s_clu


# ------------------------------------------------------------- host (numpy)


def _mix32_np(h):
    """lowbias32 on uint32 arrays (constants dtype-pinned so numpy does not
    upcast)."""
    c1, c2 = np.uint32(0x7FEB352D), np.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    h = h * c1
    h = h ^ (h >> 15)
    h = h * c2
    return h ^ (h >> 16)


def _ror_np(x, r: int):
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


def _combine_words(ca, cb, ra, rb):
    """Sparse words from two cluster and two row draws::

        core  = ca & ror(ca,7) & ror(ca,15) & cb & ror(cb,11)   (~3.1%)
        keep  = ra | ror(ra,13)                                  (75%)
        indiv = rb & ror(rb,3) & ror(rb,6) & ror(rb,12)
                   & ror(rb,17) & ror(rb,24)                     (~1.6%)
        word  = (core & keep) | indiv                            (~3.9%)
    """
    core = ca & _ror_np(ca, 7) & _ror_np(ca, 15) & cb & _ror_np(cb, 11)
    keep = ra | _ror_np(ra, 13)
    indiv = (
        rb & _ror_np(rb, 3) & _ror_np(rb, 6) & _ror_np(rb, 12)
        & _ror_np(rb, 17) & _ror_np(rb, 24)
    )
    return (core & keep) | indiv


def virtual_rows_np(idx, word_count: int = 32, seed: int = 0) -> np.ndarray:
    """Full-width packed words ``uint32 (K, word_count)`` of rows ``idx``.

    Per word ``w`` of row ``i`` (cluster ``c = i >> 8``), draws
    ``a = mix32(h + 2w * GOLD)``, ``b = mix32(h + (2w+1) * GOLD)`` over the
    per-row base ``mix32(i ^ s_row)`` and the per-cluster base
    ``mix32(c ^ s_clu)``, combined by :func:`_combine_words`. The native
    twin is ``tsn_synth_rescore`` (``native/tpusim_native.cpp``).
    """
    idx = np.asarray(idx)
    if idx.ndim != 1:
        raise ValueError("idx must be 1-D")
    idx = idx.astype(np.uint32)
    s_row, s_clu = _seed_consts(seed)
    hr = _mix32_np(idx ^ s_row)[:, None]
    hc = _mix32_np((idx >> 8) ^ s_clu)[:, None]
    k = idx.shape[0]
    wd = np.arange(word_count * NUM_DRAWS, dtype=np.uint32) * np.uint32(_GOLD)
    dc = _mix32_np(hc + wd[None, :]).reshape(k, word_count, NUM_DRAWS)
    dr = _mix32_np(hr + wd[None, :]).reshape(k, word_count, NUM_DRAWS)
    return _combine_words(dc[..., 0], dc[..., 1], dr[..., 0], dr[..., 1])


class VirtualWords:
    """Lazy ``uint32 (count, W)`` face of a virtual library: the engine's
    host-side full-width rows (the folded search's rescore source), which
    materialise on demand from their indices, so a 10^9-row library needs
    no storage. Supports ``shape``/``nbytes``/``dtype`` and ``__getitem__``
    with an int, a slice or a 1-D index array."""

    __slots__ = ("shape", "seed")
    dtype = np.dtype(np.uint32)

    def __init__(self, count: int, word_count: int = 32, seed: int = 0):
        self.shape = (int(count), int(word_count))
        self.seed = int(seed)

    @property
    def nbytes(self) -> int:
        return self.shape[0] * self.shape[1] * 4

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        n, w = self.shape
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(f"row {key} out of range [0, {n})")
            return virtual_rows_np(np.array([i]), word_count=w, seed=self.seed)[0]
        if isinstance(key, slice):
            idx = np.arange(*key.indices(n), dtype=np.int64)
        else:
            idx = np.asarray(key)
            if idx.ndim != 1:
                raise TypeError(
                    "VirtualWords supports int / slice / 1-D index arrays"
                )
            if idx.size and (idx.min() < -n or idx.max() >= n):
                raise IndexError("row indices out of range")
            idx = np.where(idx < 0, idx + n, idx).astype(np.int64)
        return virtual_rows_np(idx, word_count=w, seed=self.seed)


class VirtualFingerprints:
    """Lazy ``uint8 (count, bitcount // 8)`` face of a virtual library —
    what a synthetic-kind ``.tfsim`` exposes as ``FingerprintData.
    fingerprints``, with the ``shape``/``nbytes`` the loaders and the
    registry's fold arithmetic read; bulk access goes through
    :attr:`words`."""

    __slots__ = ("words",)
    dtype = np.dtype(np.uint8)

    def __init__(self, count: int, bitcount: int = 1024, seed: int = 0):
        if bitcount % 32:
            raise ValueError(f"bitcount {bitcount} not divisible by 32")
        self.words = VirtualWords(count, bitcount // 32, seed)

    @property
    def shape(self) -> tuple:
        n, w = self.words.shape
        return (n, w * 4)

    @property
    def seed(self) -> int:
        return self.words.seed

    @property
    def nbytes(self) -> int:
        return self.words.nbytes

    def __len__(self) -> int:
        return self.words.shape[0]

    def __getitem__(self, key):
        rows = self.words[key]
        return np.ascontiguousarray(rows).view(np.uint8)


# ---------------------------------------------------------- device (torch)


def _i32(v: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


_C1, _C2 = _i32(0x7FEB352D), _i32(0x846CA68B)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int32-viewed uint32 words."""
    h = h ^ shr(h, 16)
    h = h * _C1
    h = h ^ shr(h, 15)
    h = h * _C2
    return h ^ shr(h, 16)


def _ror(x: torch.Tensor, r: int) -> torch.Tensor:
    return shr(x, r) | (x << (32 - r))


def _draws(base: torch.Tensor, word_count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The two mixer draws of every word over per-row bases ``(K,)``:
    ``a, b`` int32 ``(K, word_count)``."""
    wd = np.arange(word_count * NUM_DRAWS, dtype=np.uint32) * np.uint32(_GOLD)
    wd = torch.from_numpy(wd.view(np.int32)).to(base.device)
    d = _mix32(base[:, None] + wd[None, :]).view(-1, word_count, NUM_DRAWS)
    return d[..., 0], d[..., 1]


def virtual_rows(
    row0: int, n: int, word_count: int = 32, seed: int = 0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Full-width rows ``[row0, row0 + n)`` as int32 ``(n, word_count)`` on
    ``device``: the same bits as ``virtual_rows_np(arange(row0, row0 + n))``
    (torch twin of ``_virtual_rows_jnp`` / ``_virtual_words``).

    The cluster draws are computed once per 256-row cluster and shared by
    its rows; the row draws once per row. The words are combined as in
    ``_combine_words``.
    """
    if not 0 <= row0 <= row0 + n <= 1 << 32:
        raise ValueError("rows must lie in [0, 2**32)")
    device = resolve_device(device)
    s_row, s_clu = (_i32(int(v)) for v in _seed_consts(seed))
    idx = wrap_int32(torch.arange(row0, row0 + n, device=device))
    c0 = row0 // CLUSTER_ROWS
    clusters = torch.arange(
        c0, (row0 + n - 1) // CLUSTER_ROWS + 1, dtype=torch.int32, device=device
    )
    ca, cb = _draws(_mix32(clusters ^ s_clu), word_count)
    core = ca & _ror(ca, 7) & _ror(ca, 15) & cb & _ror(cb, 11)
    ra, rb = _draws(_mix32(idx ^ s_row), word_count)
    keep = ra | _ror(ra, 13)
    indiv = (
        rb & _ror(rb, 3) & _ror(rb, 6) & _ror(rb, 12) & _ror(rb, 17)
        & _ror(rb, 24)
    )
    return (core[(shr(idx, 8) - c0).long()] & keep) | indiv


def virtual_folded_rows(
    n_rows: int, fold_factor: int, word_count: int = 32, seed: int = 0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """The first ``n_rows`` virtual rows OR-folded, int32 ``(n_rows,
    word_count // fold)`` on ``device``, generated in steps of 1Mi rows so
    the full width never exists whole: the folded library as plain rows,
    for the oracles of the tests and the smoke run (the stores generate
    their slabs themselves)."""
    wf = word_count // fold_factor
    device = resolve_device(device)
    out = torch.empty((n_rows, wf), dtype=torch.int32, device=device)
    for lo in range(0, n_rows, _GEN_ROWS):
        hi = min(n_rows, lo + _GEN_ROWS)
        out[lo:hi] = fold_ops.fold_words(
            virtual_rows(lo, hi - lo, word_count, seed, device), fold_factor
        )
    return out


def build_virtual_dense_store(
    n_rows: int,
    fold_factor: int,
    word_count: int = 32,
    seed: int = 0,
    popless: bool = True,
    device: torch.device | str | None = None,
    row0: int = 0,
) -> DenseStore:
    """Generate rows ``[row0, row0 + n_rows)`` of the folded virtual library
    directly on the device as a dense store (twin of
    ``build_virtual_dense_store``; a shard passes its span, so a sharded
    virtual library holds the same bits as an unsharded one): each step
    makes 1Mi full-width rows, OR-folds them and writes their columns (and
    popcounts, unless ``popless``) in place. Peak transient memory is a few
    hundred MB at any library size. Padding columns stay zero; the scan's
    ``n_valid`` mask excludes them.
    """
    if word_count % fold_factor:
        raise ValueError("fold factor must divide the word count")
    wf = word_count // fold_factor
    n_padded = plan_store_layout(n_rows)
    device = resolve_device(device)
    words = torch.zeros((wf, n_padded), dtype=torch.int32, device=device)
    pops = None if popless else torch.zeros(n_padded, dtype=torch.int16, device=device)
    for lo in range(0, n_rows, _GEN_ROWS):
        hi = min(n_rows, lo + _GEN_ROWS)
        folded = fold_ops.fold_words(
            virtual_rows(row0 + lo, hi - lo, word_count, seed, device), fold_factor
        )
        words[:, lo:hi] = folded.T
        if pops is not None:
            pops[lo:hi] = popcount_rows(folded).to(torch.int16)
    return DenseStore(words=words, popcounts=pops, n_valid=n_rows)


def build_virtual_bitplane_store(
    n_rows: int,
    fold_factor: int,
    word_count: int = 32,
    seed: int = 0,
    device: torch.device | str | None = None,
    row0: int = 0,
) -> BitplaneStore:
    """Generate rows ``[row0, row0 + n_rows)`` of the folded virtual library
    directly on the device as a bitplane store (twin of
    ``build_virtual_bitplane_store``): the planes are allocated once, then
    each step makes 1Mi full-width rows, OR-folds them, transposes them into
    their plane words and drops them, so the rows never exist whole beside
    the planes."""
    if word_count % fold_factor:
        raise ValueError("fold factor must divide the word count")
    device = resolve_device(device)
    store = empty_bitplane_store(n_rows, 32 * (word_count // fold_factor), device)
    for lo in range(0, n_rows, _GEN_ROWS):
        hi = min(n_rows, lo + _GEN_ROWS)
        fill_bitplane_slab(store, lo, fold_ops.fold_words(
            virtual_rows(row0 + lo, hi - lo, word_count, seed, device), fold_factor
        ))
    return store


def aligned_virtual_rows(n: int, n_shards: int) -> int:
    """Largest row count <= ``n`` (at least one span) whose shard spans are
    all full: a multiple of the bitplane selection block per shard (twin of
    ``aligned_virtual_rows``; the port's stores pad any count, so this only
    keeps every shard of a test library non-empty and equal)."""
    align = SELECT_BLOCK_COLS * n_shards
    return max(align, n // align * align)


def pick_query_rows(
    count: int,
    n_rows: int,
    fold_factor: int,
    word_count: int = 32,
    seed: int = 0,
    max_planes: int = 64,
    rng_seed: int = 123,
) -> np.ndarray:
    """Library rows usable as queries: rows whose folded popcount is at
    most ``max_planes``, drawn as the JAX ``pick_query_rows`` draws them
    (same rows for the same arguments). Each is a cluster member, so it
    has graded neighbours in the library."""
    rng = np.random.default_rng(rng_seed)
    picked: list[int] = []
    while len(picked) < count:
        cand = rng.choice(n_rows, size=4 * count, replace=False)
        rows = virtual_rows_np(cand, word_count=word_count, seed=seed)
        fp = popcount_rows_np(fold_ops.fold_words(rows, fold_factor))
        picked.extend(int(c) for c, p in zip(cand, fp) if p <= max_planes)
    return np.array(picked[:count], dtype=np.int64)



def virtual_full_topk(
    n_rows: int,
    queries_full: np.ndarray,
    k: int,
    seed: int = 0,
    word_count: int = 32,
    row_chunk: int = 1 << 16,
    cutoffs=(),
    device: torch.device | str | None = None,
):
    """Exact full-width top-k over the first ``n_rows`` virtual rows,
    computed on ``device`` (the card unless told otherwise; twin of the JAX
    ``virtual_full_topk``): the oracle of folded-search recall at sizes where
    no full-width matrix can be stored. Rows are made chunk by chunk with
    :func:`virtual_rows` and scored at full width, and only a running
    ``(B, k)`` top-k survives, with exact ``>= cutoff`` counts for every
    query against every cutoff. Ties go to the lowest index, across chunks
    too. Returns numpy ``(scores f32 (B, k), indices i64 (B, k), counts i64
    (B, len(cutoffs)))``; past the row count the entries are -inf / -1.

    Plain PyTorch, not a kernel: the intersection counts are a float32
    product of 0/1 bit matrices, exact because the sums stay <= the
    bitcount.
    """
    q = np.ascontiguousarray(queries_full, dtype=np.uint32)
    if q.ndim == 1:
        q = q[None, :]
    b, w = q.shape
    if w != word_count:
        raise ValueError(f"queries have {w} words, library has {word_count}")
    device = resolve_device(device)
    chunk = min(row_chunk, max(128, n_rows))
    shifts = torch.arange(32, dtype=torch.int32, device=device)

    def bits(words):
        return ((words[:, :, None] >> shifts) & 1).reshape(len(words), -1).float()

    qt = torch.from_numpy(q.view(np.int32)).to(device)
    qbits, qpops = bits(qt), popcount_rows(qt)
    cut = torch.tensor(np.asarray(cutoffs, np.float32).reshape(-1), device=device)
    best_v = torch.full((b, 0), float("-inf"), device=device)
    best_i = torch.full((b, 0), -1, dtype=torch.int64, device=device)
    counts = torch.zeros((b, len(cut)), dtype=torch.int64, device=device)
    for lo in range(0, n_rows, chunk):
        hi = min(n_rows, lo + chunk)
        rows = virtual_rows(lo, hi - lo, word_count, seed, device)
        common = (qbits @ bits(rows).T).to(torch.int32)  # (B, rows)
        s = similarity_from_counts(common, popcount_rows(rows), qpops)
        counts += (s[:, None, :] >= cut[None, :, None]).sum(dim=-1)
        v = torch.cat([best_v, s], dim=1)
        i = torch.cat([best_i, torch.arange(lo, hi, device=device).expand(b, -1)], dim=1)
        best_v, pos = topk_lowest_index(v, min(k, v.shape[1]), tiebreak=i)
        best_i = torch.gather(i, 1, pos)
    pad = k - best_v.shape[1]
    vals = np.concatenate(
        [best_v.cpu().numpy(), np.full((b, pad), -np.inf, np.float32)], axis=1)
    idx = np.concatenate(
        [best_i.cpu().numpy(), np.full((b, pad), -1, np.int64)], axis=1)
    return vals, idx, counts.cpu().numpy()


def virtual_matrix(n_rows: int, word_count: int = 32, seed: int = 0) -> np.ndarray:
    """Full-width matrix ``uint32 (n_rows, word_count)`` of the first
    ``n_rows`` virtual rows in host RAM (twin of the JAX
    ``virtual_matrix``): the native fill when the library is built, numpy
    slabs otherwise."""
    from . import native

    try:
        return native.synth_fill(n_rows, word_count=word_count, seed=seed)
    except ImportError:
        out = np.empty((n_rows, word_count), np.uint32)
        for lo in range(0, n_rows, _GEN_ROWS):
            hi = min(lo + _GEN_ROWS, n_rows)
            out[lo:hi] = virtual_rows_np(np.arange(lo, hi), word_count, seed)
        return out


def rescore_candidates_np(
    indices: np.ndarray,
    query_full: np.ndarray,
    k: int,
    n_rows: int,
    seed: int = 0,
    similarity: str = TANIMOTO,
    alpha: float = 1.0,
    beta: float = 1.0,
):
    """Exact full-width rescore of folded-scan candidates on the host (twin
    of the JAX ``rescore_candidates_np``): the candidates' rows are
    recomputed from the mixer (``native.synth_rescore`` when the library is
    built, :func:`virtual_rows_np` and :func:`~..ops.scan.scores_np`
    otherwise), scored against the full-width query and ordered by
    ``(-score, index)``. Returns ``(scores, indices)`` cut to ``k``."""
    from . import native

    indices = np.asarray(indices)
    keep = (indices >= 0) & (indices < n_rows)
    indices = np.sort(indices[keep].astype(np.int64))
    try:
        scores = native.synth_rescore(
            indices, np.asarray(query_full, np.uint32), seed=seed,
            alpha=alpha, beta=beta, tversky=similarity != TANIMOTO,
        )
    except ImportError:
        rows = virtual_rows_np(indices, word_count=len(query_full), seed=seed)
        scores = scores_np(rows, query_full[None, :], similarity, alpha, beta)[0]
    order = np.lexsort((indices, -scores))[:k]
    return scores[order], indices[order]
