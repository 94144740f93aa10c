"""FingerprintDB — the search engine over one device-resident library (twin
of ``gpusimilarity_tpu/models/fingerprint_db.py``).

Ported: construction and upload of the unfolded bitplane store, ``search``,
``search_batch`` (a ``(B, W)`` batch with per-query k and cutoff in one
kernel launch), ``_assemble`` and the fetch-width rule ``_k_bucket``.

Not ported, because PyTorch runs eagerly and has no compile latency to
hide: ahead-of-time precompiles, serving-time k promotion, background
compiles, warmup pins and batch-size buckets. Not ported yet, and raising
``NotImplementedError`` instead of falling back to anything: the dense
scan, popless stores and folded libraries (``ROADMAP.md`` Queue 1 #8 and
#9), and synthetic (virtual) libraries (Queue 1 #9).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gpusimilarity_tpu.utils.fsim import FingerprintData

from ..ops import fold as fold_ops
from ..ops.bitplane import query_plane_indices
from ..ops.scan import TANIMOTO, popcount_rows_np
from ..parallel import sharded
from .results import SearchResult

_DENSE_TODO = (
    "the dense scan and popless stores are not ported yet "
    "(ROADMAP.md Queue 1 #8: dense store, torch dense path and kernel 2)"
)
_FOLD_TODO = (
    "folded libraries are not ported yet (ROADMAP.md Queue 1 #9: folding "
    "with exact full-width rescore, and virtual libraries)"
)


def _k_bucket(k_fetch: int, count: int) -> int:
    """Candidate fetch width: ``k_fetch`` rounded up to a power of two with
    a floor of 128, capped at the row count (kept from the JAX engine, whose
    result sets depend on it)."""
    bucket = max(128, 1 << (max(k_fetch, 1) - 1).bit_length())
    return min(bucket, count)


class FingerprintDB:
    """One fingerprint library resident on one device."""

    def __init__(
        self,
        data: FingerprintData,
        device: torch.device | str = "cpu",
        fold_factor: int = 1,
        scan_mode: str = "bitplane",
        popless: bool = False,
    ):
        data.validate()
        if scan_mode not in ("dense", "bitplane"):
            raise ValueError(f"unknown scan_mode {scan_mode!r}")
        if scan_mode == "dense" or popless:
            raise NotImplementedError(_DENSE_TODO)
        from gpusimilarity_tpu.utils import synth

        if isinstance(data.fingerprints, synth.VirtualFingerprints):
            raise NotImplementedError(_FOLD_TODO)
        self.device = torch.device(device)
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
        if self.fold_factor > 1:
            raise NotImplementedError(_FOLD_TODO)
        self._store: sharded.BitplaneStore | None = None
        self.upload()

    def upload(self) -> None:
        """Transpose the library into a bitplane store on the device."""
        if self._store is None:
            self._store = sharded.build_bitplane_store(
                self._full_words, self.device
            )

    # ------------------------------------------------------------------ info

    @property
    def count(self) -> int:
        return self._count

    @property
    def device_bitcount(self) -> int:
        return self.bitcount // self.fold_factor

    @property
    def store(self) -> sharded.BitplaneStore:
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
        """Search one packed query; returns the top ``min(k, matches)``. A
        dbkey mismatch yields an empty result (reference
        ``fingerprintdb_cuda.cu:349-352``)."""
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
        """Search a ``(B, W)`` batch of packed queries in one device pass;
        ``k`` and ``cutoff`` may be scalars or per-query sequences."""
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
        plane_idx, _bucket = query_plane_indices(queries, self.device_bitcount)
        dev = self.device
        vals, idx, approx = sharded.bitplane_local_topk(
            self._store,
            torch.from_numpy(plane_idx).to(dev),
            torch.from_numpy(popcount_rows_np(queries)).to(dev),
            torch.from_numpy(np.array(cutoffs)).to(dev),
            k_fetch, similarity, alpha, beta,
        )
        vals, idx, approx = vals.cpu().numpy(), idx.cpu().numpy(), approx.cpu().numpy()

        results = []
        for qi in range(b):
            svals, sidx = self._assemble(
                vals[qi], idx[qi], int(ks[qi]), float(cutoffs[qi])
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

    def _assemble(self, vals, idx, k, cutoff) -> tuple[np.ndarray, np.ndarray]:
        """Drop padding, apply the cutoff, order by (-score, index), cut to k."""
        keep = (vals > -np.inf) & (idx >= 0) & (idx < self.count)
        vals, idx = vals[keep], idx[keep]
        if cutoff > 0:
            keep = vals >= cutoff
            vals, idx = vals[keep], idx[keep]
        order = np.lexsort((idx, -vals))[:k]
        return vals[order], idx[order]
