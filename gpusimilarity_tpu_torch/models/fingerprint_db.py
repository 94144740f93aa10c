"""FingerprintDB — the search engine over one device-resident library (twin
of ``gpusimilarity_tpu/models/fingerprint_db.py``).

Ported: construction and upload of the bitplane and dense stores (with or
without popcounts, folded or not, from packed rows or generated on the
device for a synthetic library), ``search``, ``search_batch`` (a ``(B, W)``
batch with per-query k and cutoff in one kernel launch), ``_assemble`` with
the exact full-width rescore of folded-scan candidates, and the fetch-width
rule ``_k_bucket``.

Not ported, because PyTorch runs eagerly and has no compile latency to
hide: ahead-of-time precompiles, serving-time k promotion, background
compiles, warmup pins and batch-size buckets. Not ported because a card
holds the library whole: the page-cache prewarm of memory-mapped rescore
sources and the multi-host feed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import fold as fold_ops
from ..ops.bitplane import query_plane_indices
from ..ops.bitplane_phase1 import KERNEL_MAX_PLANES
from ..ops.dense_phase1 import KERNEL_MAX_WORDS
from ..ops.scan import TANIMOTO, popcount_rows_np, scores_np
from ..parallel import sharded
from ..parallel.mesh import resolve_device
from ..utils import native, synth
from ..utils.fsim import FingerprintData
from .results import SearchResult


def _k_bucket(k_fetch: int, count: int) -> int:
    """Candidate fetch width: ``k_fetch`` rounded up to a power of two with
    a floor of 128, capped at the row count (kept from the JAX engine, whose
    result sets depend on it)."""
    bucket = max(128, 1 << (max(k_fetch, 1) - 1).bit_length())
    return min(bucket, count)


def rescore_rows(full_words, idx, query, similarity=TANIMOTO, alpha=1.0,
                 beta=1.0) -> np.ndarray:
    """Exact full-width scores of rows ``idx`` (index-sorted) of
    ``full_words`` — an array, a memory map or a lazy ``VirtualWords`` —
    against one packed query: the fold path's host rescore.

    With the native library built it runs :func:`~..utils.native.rescore`
    or :func:`~..utils.native.synth_rescore`; otherwise the candidates' rows
    (recomputed from the mixer for a virtual library) go through
    :func:`~..ops.scan.scores_np`. A virtual library is never materialised
    beyond its candidates.
    """
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    query = np.ascontiguousarray(query, dtype=np.uint32)
    virtual = isinstance(full_words, synth.VirtualWords)
    if native.available():
        tversky = similarity != TANIMOTO
        if virtual:
            return native.synth_rescore(
                idx, query, full_words.seed, alpha, beta, tversky
            )
        return native.rescore(full_words, idx, query, alpha, beta, tversky)
    if virtual:
        rows = synth.virtual_rows_np(idx, full_words.shape[1], full_words.seed)
    else:
        rows = np.asarray(full_words[idx])
    return scores_np(rows, query[None, :], similarity, alpha, beta)[0]


def check_kernel_width(device_type: str, scan_mode: str, device_bitcount: int) -> None:
    """Refuse at load a library no kernel takes. On a CUDA device every
    search launches a kernel and never falls back, so a row wider (after
    folding) than the kernel of ``scan_mode`` takes would load and then fail
    at its first search; raises ``ValueError`` naming the limit instead. The
    CPU path runs the plain versions, which take any width."""
    if device_type != "cuda":
        return
    if scan_mode == "dense" and device_bitcount > 32 * KERNEL_MAX_WORDS:
        raise ValueError(
            f"a dense library of {device_bitcount} bits a row on the device is "
            f"wider than the dense kernel takes ({32 * KERNEL_MAX_WORDS} bits): "
            "fold it further"
        )
    if scan_mode == "bitplane" and device_bitcount > KERNEL_MAX_PLANES:
        raise ValueError(
            f"a bitplane library of {device_bitcount} planes on the device is "
            f"more than the bitplane kernel takes ({KERNEL_MAX_PLANES} planes): "
            "fold it further"
        )


class FingerprintDB:
    """One fingerprint library resident on one device."""

    def __init__(
        self,
        data: FingerprintData,
        device: torch.device | str | None = None,
        fold_factor: int = 1,
        scan_mode: str = "bitplane",
        popless: bool = False,
    ):
        """``scan_mode``: ``"bitplane"`` stores the library bit-transposed
        and reads only each query's set-bit planes (kernel 1); ``"dense"``
        stores the packed words planar and reads every word (kernel 2).
        ``popless=True`` (dense only) keeps no popcount array on the card:
        the scan recomputes column popcounts from the words it reads.
        ``fold_factor`` is rounded up to a divisor of the word count; a
        folded library keeps ``data``'s full-width rows on the host for the
        exact rescore. ``device`` defaults to the card and raises without
        one; ``device="cpu"`` runs the plain versions on the host. On the
        card a library wider than its kernel takes is refused here
        (:func:`check_kernel_width`), before any upload."""
        data.validate()
        if scan_mode not in ("dense", "bitplane"):
            raise ValueError(f"unknown scan_mode {scan_mode!r}")
        if popless and scan_mode != "dense":
            raise ValueError(
                "popless stores are dense-only: the bitplane score needs "
                "stored popcounts"
            )
        self.device = resolve_device(device)
        self.scan_mode = scan_mode
        self.popless = popless
        self.dbkey = data.dbkey
        self.bitcount = data.bitcount
        self.generator = data.generator
        self._smiles = data.smiles
        self._ids = data.ids
        self._count = data.count
        self._full_words = data.packed_words()
        self.word_count = self._full_words.shape[1]
        self.fold_factor = fold_ops.round_fold_factor(
            self.word_count, int(fold_factor)
        )
        check_kernel_width(self.device.type, scan_mode, self.device_bitcount)
        self._store: sharded.BitplaneStore | sharded.DenseStore | None = None
        self.upload()

    def upload(self) -> None:
        """Build the device store: a virtual library is generated on the
        device, anything else is folded and transposed from its rows; either
        way slab by slab, so the library is never held twice."""
        if self._store is not None:
            return
        full, fold, dev = self._full_words, self.fold_factor, self.device
        virtual = isinstance(full, synth.VirtualWords)
        if self.scan_mode == "dense" and virtual:
            self._store = synth.build_virtual_dense_store(
                self._count, fold, self.word_count, full.seed,
                popless=self.popless, device=dev,
            )
        elif self.scan_mode == "dense":
            self._store = sharded.build_store(
                full, dev, fold_factor=fold, popless=self.popless
            )
        elif virtual:
            self._store = synth.build_virtual_bitplane_store(
                self._count, fold, self.word_count, full.seed, device=dev
            )
        else:
            self._store = sharded.build_bitplane_store(full, dev, fold_factor=fold)

    # ------------------------------------------------------------------ info

    @property
    def count(self) -> int:
        return self._count

    @property
    def device_bitcount(self) -> int:
        return self.bitcount // self.fold_factor

    @property
    def store(self) -> sharded.BitplaneStore | sharded.DenseStore:
        return self._store

    def get_smiles(self, index: int) -> str:
        return self._smiles[index].decode("utf-8", "replace")

    def get_id(self, index: int) -> str:
        return self._ids[index].decode("utf-8", "replace")

    # ---------------------------------------------------------------- search

    def search(
        self,
        query: np.ndarray,
        k: int = 20,
        cutoff: float = 0.0,
        dbkey: str = "",
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
        return_indices: bool = False,
    ) -> SearchResult:
        """Search one full-width packed query; returns the top
        ``min(k, matches)``. A dbkey mismatch yields an empty result
        (reference ``fingerprintdb_cuda.cu:349-352``)."""
        [result] = self.search_batch(
            query[None, :], k, cutoff, dbkey, similarity, alpha, beta,
            return_indices=return_indices,
        )
        return result

    def search_batch(
        self,
        queries: np.ndarray,
        k: int | Sequence[int] = 20,
        cutoff: float | Sequence[float] = 0.0,
        dbkey: str = "",
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
        return_indices: bool = False,
    ) -> list[SearchResult]:
        """Search a ``(B, W)`` batch of full-width packed queries in one
        device pass; ``k`` and ``cutoff`` may be scalars or per-query
        sequences. The queries are folded like the store."""
        queries = np.asarray(queries, dtype=np.uint32)
        if queries.ndim != 2 or queries.shape[1] != self.word_count:
            raise ValueError(
                f"queries must be (B, {self.word_count}) packed uint32 words"
            )
        b = queries.shape[0]
        ks = np.broadcast_to(np.asarray(k, dtype=np.int64), (b,))
        cutoffs = np.broadcast_to(np.asarray(cutoff, dtype=np.float32), (b,))
        if dbkey != self.dbkey or self.count == 0:
            return [SearchResult() for _ in range(b)]

        ks = np.minimum(ks, self.count)
        k_fetch = _k_bucket(
            fold_ops.overfetch_count(int(ks.max()), self.fold_factor),
            self.count,
        )
        folded = np.ascontiguousarray(fold_ops.fold_words(queries, self.fold_factor))
        dev = self.device
        query_pops = torch.from_numpy(popcount_rows_np(folded)).to(dev)
        cut_t = torch.from_numpy(np.array(cutoffs)).to(dev)
        if self.scan_mode == "dense":
            vals, idx, approx = sharded.dense_local_topk(
                self._store, torch.from_numpy(folded.view(np.int32)).to(dev),
                query_pops, cut_t, k_fetch, similarity, alpha, beta,
            )
        else:
            plane_idx, _bucket = query_plane_indices(folded, self.device_bitcount)
            vals, idx, approx = sharded.bitplane_local_topk(
                self._store, torch.from_numpy(plane_idx).to(dev), query_pops,
                cut_t, k_fetch, similarity, alpha, beta,
            )
        vals, idx, approx = vals.cpu().numpy(), idx.cpu().numpy(), approx.cpu().numpy()

        results = []
        for qi in range(b):
            svals, sidx = self._assemble(
                queries[qi], vals[qi], idx[qi], int(ks[qi]), float(cutoffs[qi]),
                similarity, alpha, beta,
            )
            result = SearchResult(
                smiles=[self.get_smiles(int(i)) for i in sidx],
                ids=[self.get_id(int(i)) for i in sidx],
                scores=[float(v) for v in svals],
                approximate_count=int(approx[qi]),
            )
            if return_indices:
                result.indices = sidx.tolist()
            results.append(result)
        return results

    def _assemble(self, query, vals, idx, k, cutoff, similarity=TANIMOTO,
                  alpha=1.0, beta=1.0) -> tuple[np.ndarray, np.ndarray]:
        """Drop padding; at fold > 1 rescore the candidates exactly at full
        width (reference ``fingerprintdb_cuda.cu:307-331``), visiting them
        in index order; apply the cutoff, order by (-score, index), cut to
        k."""
        keep = (vals > -np.inf) & (idx >= 0) & (idx < self.count)
        vals, idx = vals[keep], idx[keep]
        if self.fold_factor > 1:
            idx = np.sort(idx)
            vals = rescore_rows(
                self._full_words, idx, query, similarity, alpha, beta
            )
        if cutoff > 0:
            keep = vals >= cutoff
            vals, idx = vals[keep], idx[keep]
        order = np.lexsort((idx, -vals))[:k]
        return vals[order], idx[order]
