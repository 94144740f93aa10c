"""FingerprintDB — the search engine over one device-resident library (twin
of ``gpusimilarity_tpu/models/fingerprint_db.py``).

Ported: construction and upload of the bitplane and dense stores (with or
without popcounts, folded or not, from packed rows or generated on the
device for a synthetic library), sharded over a mesh of devices and of
processes (each process reads and uploads only its shards' rows, and string
tables held in RAM are cut to its span), ``search``, ``search_batch`` (a
``(B, W)`` batch with per-query k and cutoff in one kernel launch per
shard), ``_assemble`` with the exact full-width rescore of folded-scan
candidates, the fetch-width rule ``_k_bucket``, and the host page-cache
prewarm of memory-mapped rescore sources and string blobs after the upload
(``upload(async_prewarm=...)``, :meth:`FingerprintDB.join_prewarm`), and
the start-up warm-up (:meth:`FingerprintDB.warmup`): the same searches the
JAX engine runs before its server is ready, which here load each kernel
module on its first launch and grow the caching allocator and the pinned
host buffers to what a first request would otherwise pay for.

Not ported, because PyTorch compiles no program per shape: ahead-of-time
precompiles, serving-time k promotion, background compiles, warm-up pins
and the padding of a batch to a bucket.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..ops import fold as fold_ops
from ..ops.bitplane import PLANE_BUCKETS, plane_bucket_for, query_plane_indices
from ..ops.bitplane_phase1 import KERNEL_MAX_PLANES
from ..ops.dense_phase1 import KERNEL_MAX_WORDS
from ..ops.scan import TANIMOTO, popcount_rows_np, scores_np
from ..parallel import sharded
from ..parallel import multihost
from ..parallel.mesh import Mesh, resolve_mesh
from ..utils import native, synth
from ..utils.fsim import FingerprintData
from ..utils.strings import mmap_backing
from .results import SearchResult

log = logging.getLogger("tpusimilarity")
# the batch sizes the warm-up searches at: the JAX engine's batch buckets
# (the port pads no batch; these only pick the warm-up's shapes)
_WARMUP_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)
# the prewarm touches one byte a page, in slabs of this many bytes
_PREWARM_SLAB_BYTES = 64 << 20
_PAGE_BYTES = 4096


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

    A virtual library scores through :meth:`~..utils.synth.VirtualWords.
    rescore` and is never materialised beyond its candidates; stored rows
    through :func:`~..utils.native.rescore` when the native library is
    built, else :func:`~..ops.scan.scores_np`.
    """
    if isinstance(full_words, synth.VirtualWords):
        return full_words.rescore(idx, query, similarity, alpha, beta)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    query = np.ascontiguousarray(query, dtype=np.uint32)
    if native.available():
        return native.rescore(full_words, idx, query, alpha, beta,
                              similarity != TANIMOTO)
    rows = np.asarray(full_words[idx])
    return scores_np(rows, query[None, :], similarity, alpha, beta)[0]


def host_memory_bytes() -> int | None:
    """The host's total RAM (``MemTotal`` of ``/proc/meminfo``), or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    return int(line.split()[1]) * 1024
    except (ValueError, OSError):
        pass
    return None


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
    """One fingerprint library resident on a mesh of devices."""

    def __init__(
        self,
        data: FingerprintData,
        device: torch.device | str | None = None,
        fold_factor: int = 1,
        scan_mode: str = "bitplane",
        popless: bool = False,
        mesh: Mesh | None = None,
        keep_full_on_host: bool = True,
        async_prewarm: bool = False,
    ):
        """``scan_mode``: ``"bitplane"`` stores the library bit-transposed
        and reads only each query's set-bit planes (kernel 1); ``"dense"``
        stores the packed words planar and reads every word (kernel 2).
        ``popless=True`` (dense, one process) keeps no popcount array on the
        card: the scan recomputes column popcounts from the words it reads.
        ``fold_factor`` is rounded up to a divisor of the word count; a
        folded library keeps ``data``'s full-width rows on the host for the
        exact rescore. The library shards over ``mesh``, by default every
        visible card (raises without one); ``device`` is shorthand for a
        one-shard mesh, and ``device="cpu"`` runs the plain versions on the
        host. On the card a library wider than its kernel takes is refused
        here (:func:`check_kernel_width`), before any upload.
        ``keep_full_on_host=False`` drops the host rows once the store is
        built (an unfolded library needs them for nothing but
        :meth:`get_fingerprint`). ``async_prewarm`` is :meth:`upload`'s."""
        data.validate()
        if scan_mode not in ("dense", "bitplane"):
            raise ValueError(f"unknown scan_mode {scan_mode!r}")
        if popless and scan_mode != "dense":
            raise ValueError(
                "popless stores are dense-only: the bitplane score needs "
                "stored popcounts"
            )
        self.mesh = resolve_mesh(mesh, device)
        self.device = self.mesh.devices[0]
        self.scan_mode = scan_mode
        # the per-process feed builds popcounts with its slabs: popless is a
        # one-card memory squeeze, not a multi-process need
        self.popless = popless and self.mesh.n_processes == 1
        self.dbkey = data.dbkey
        self.bitcount = data.bitcount
        self.generator = data.generator
        self._smiles = data.smiles
        self._ids = data.ids
        # captured up front: host-sharded string tables hold only this
        # process's span
        self._count = data.count
        self._full_words = data.packed_words()
        self.word_count = self._full_words.shape[1]
        self.fold_factor = fold_ops.round_fold_factor(
            self.word_count, int(fold_factor)
        )
        if self.fold_factor > 1 and not keep_full_on_host:
            raise ValueError(
                "folded search needs a full-width rescore source; keep "
                "keep_full_on_host=True (free for .tfsim-mapped data: the "
                "'host copy' is a zero-copy view of the memory-mapped file)"
            )
        for device_type in {d.type for d in self.mesh.devices}:
            check_kernel_width(device_type, scan_mode, self.device_bitcount)
        # full-width fingerprint bytes this process read to build its shards
        self.loaded_fp_bytes: int | None = None
        self._store: sharded.ShardedStore | None = None
        self._prewarm_thread: threading.Thread | None = None
        if async_prewarm:
            self.upload(async_prewarm=True)
        else:
            self.upload()
        if not keep_full_on_host:
            self._full_words = None

    def upload(self, async_prewarm: bool = False) -> None:
        """Build this process's shards: each shard's span of the rows is
        folded and transposed onto its device slab by slab, or generated
        there for a virtual library, so the library is never held twice and
        the process reads no row outside its shards. In a multi-process job
        the string tables held in RAM are then cut to the process's span.

        Then the host's page cache is warmed for what every search reads
        from memory maps (:meth:`_prewarm_rescore_pages`): the full-width
        rows a folded search rescores and the string blobs every result row
        reads. ``async_prewarm=True`` (one process only; the server's
        start-up) warms on a daemon thread while the database already
        answers (:meth:`join_prewarm` waits for it); otherwise it is done
        before this returns."""
        if self._store is not None:
            return
        self._store = sharded.build_sharded_store(
            self._full_words, self.mesh, self.scan_mode, self.fold_factor,
            self.popless,
        )
        self.loaded_fp_bytes = self._store.local_rows * self.word_count * 4
        if self.mesh.n_processes > 1:
            self._shard_host_strings()
        if not self._rescore_maps():
            log.info("rescore prewarm not needed (unfolded or RAM-backed)")
        elif async_prewarm and self.mesh.n_processes == 1:
            self._prewarm_thread = threading.Thread(
                target=self._prewarm_rescore_pages, name="tpusim-prewarm",
                daemon=True,
            )
            self._prewarm_thread.start()
        else:
            self._prewarm_rescore_pages()

    def join_prewarm(self) -> None:
        """Block until a background page prewarm has finished."""
        if self._prewarm_thread is not None:
            self._prewarm_thread.join()

    def _rescore_maps(self) -> list[np.memmap]:
        """The memory maps a search reads: the full-width rows when the
        library is folded and they are mapped, and every mapped string blob,
        each file once (smiles and ids may be hardlinks of one blob). The
        gate walks the base chain (:func:`~..utils.strings.mmap_backing`),
        so a view of a map still counts."""
        maps = {}
        if self.fold_factor > 1 and self._full_words is not None:
            fp = mmap_backing(self._full_words)
            if fp is not None:
                maps[id(fp)] = fp
        for table in (self._smiles, self._ids):
            mm = mmap_backing(getattr(table, "_blob", None))
            if mm is None or not mm.size:
                continue
            try:
                st = os.stat(mm.filename)
                maps[(st.st_dev, st.st_ino)] = mm
            except (OSError, TypeError):
                maps[id(mm)] = mm
        return list(maps.values())

    def _prewarm_rescore_pages(self) -> None:
        """Touch one byte of every page of :meth:`_rescore_maps`, in order,
        64 MiB at a time, so the kernel's readahead streams the files into
        the page cache. Without it the store build evicts part of what it
        just read and every folded search's exact rescore, and every result
        row's strings, pay cold random page faults (the JAX package measured
        2-3 s a query cold against 150 ms warm at 768M rows, about 0.9 s of
        it in the string blobs). Skipped when the maps exceed 85% of the
        host's total RAM: they could not stay resident."""
        maps = self._rescore_maps()
        nbytes = sum(m.nbytes for m in maps)
        total = host_memory_bytes()
        if total is None:
            log.info("rescore prewarm skipped (no /proc/meminfo)")
            return
        # total RAM, not MemAvailable: the build's transient buffers are
        # still counted against it here, unlike at serve time
        if nbytes > total * 0.85:
            log.info(
                "rescore prewarm skipped (%d GiB of maps exceeds 85%% of RAM)",
                nbytes >> 30,
            )
            return
        t0 = time.monotonic()
        for mm in maps:
            flat = mm.reshape(-1).view(np.uint8)
            for lo in range(0, flat.size, _PREWARM_SLAB_BYTES):
                flat[lo:lo + _PREWARM_SLAB_BYTES:_PAGE_BYTES].max()
        log.info(
            "prewarmed %d GiB of rescore pages in %.1fs",
            nbytes >> 30, time.monotonic() - t0,
        )

    def _shard_host_strings(self) -> None:
        """The multi-process string policy. Memory-mapped tables
        (``.tfsim``) stay whole on every process: the page cache holds them
        and a lookup touches one page. Tables held in RAM (``.fsim`` loads,
        plain lists) are cut to this process's span
        (:class:`~..parallel.multihost.HostStrings`); results then resolve
        other processes' rows with one collective per batch."""
        lo, hi = multihost.process_row_span(self.mesh, self._store.n_padded)
        for attr in ("_smiles", "_ids"):
            table = getattr(self, attr)
            if multihost.needs_host_sharding(table):
                local = [bytes(s) for s in table[lo:min(hi, self._count)]]
                setattr(self, attr, multihost.HostStrings(local, lo, hi))

    def _lookup_strings_batch(self, idx_lists):
        """The smiles and ids of many result index arrays at once:
        ``(smiles_lists, ids_lists)``. Host-sharded tables resolve in one
        :func:`~..parallel.multihost.resolve_strings_many` call for the
        whole batch, the rest directly."""
        out = [[None] * len(idx_lists), [None] * len(idx_lists)]
        plans, pairs = [], []
        for fi, table in enumerate((self._smiles, self._ids)):
            if isinstance(table, multihost.HostStrings):
                for li, idx in enumerate(idx_lists):
                    plans.append((fi, li))
                    pairs.append((table, idx))
            else:
                for li, idx in enumerate(idx_lists):
                    out[fi][li] = [table[int(i)] for i in idx]
        if pairs:
            for (fi, li), raw in zip(plans, multihost.resolve_strings_many(pairs)):
                out[fi][li] = raw
        return tuple(
            [[s.decode("utf-8", "replace") for s in raw] for raw in field]
            for field in out
        )

    # ------------------------------------------------------------------ info

    @property
    def count(self) -> int:
        return self._count

    @property
    def device_bitcount(self) -> int:
        return self.bitcount // self.fold_factor

    @property
    def store(self) -> sharded.ShardedStore:
        return self._store

    def get_fingerprint(self, index: int) -> np.ndarray:
        """Full-width packed words of row ``index`` (reference
        ``FingerprintDB::getFingerprint``, ``fingerprintdb_cuda.cu:212-226``)."""
        if self._full_words is None:
            raise ValueError("full-width matrix not retained on host")
        return np.array(self._full_words[index])

    def get_smiles(self, index: int) -> str:
        return self._smiles[index].decode("utf-8", "replace")

    def get_id(self, index: int) -> str:
        return self._ids[index].decode("utf-8", "replace")

    # ---------------------------------------------------------------- warm-up

    def _synthetic_query(self, n_set: int) -> np.ndarray:
        """Full-width packed query with exactly ``n_set`` bits, all within
        the first ``device_bitcount`` positions so word-level folding keeps
        the count: the query lands in the plane bucket of ``n_set``."""
        rng = np.random.default_rng(n_set)
        n_set = max(1, min(n_set, self.device_bitcount))
        bits = np.zeros(self.bitcount, np.uint8)
        bits[rng.choice(self.device_bitcount, n_set, replace=False)] = 1
        return np.packbits(bits, bitorder="little").view(np.uint32)

    def _warmup_queries(self) -> list[np.ndarray]:
        """The JAX engine's warm-up queries: library row 0 (a 48-bit
        synthetic query without host rows), and for a bitplane store one
        query per plane bucket that live traffic is likely to hit: the
        buckets of the p50 and p95 of the folded row popcounts of a sample
        of up to 4096 rows, and one bucket of headroom above."""
        if self._full_words is not None:
            base = np.array(self._full_words[0])
        else:
            base = self._synthetic_query(min(48, self.device_bitcount))
        if self.scan_mode != "bitplane":
            return [base]  # the dense scan's work does not depend on the query

        sample_n = min(self.count, 4096)
        if self._full_words is not None:
            stride = max(1, self.count // sample_n)
            rows = np.asarray(self._full_words[::stride][:sample_n])
            pops = popcount_rows_np(fold_ops.fold_words(rows, self.fold_factor))
        else:
            pops = np.asarray([48])
        w = self.device_bitcount
        targets = {
            plane_bucket_for(int(np.percentile(pops, 50)), w),
            plane_bucket_for(int(np.percentile(pops, 95)), w),
        }
        # one bucket of headroom above the densest observed
        nxt = next((p for p in PLANE_BUCKETS if p > max(targets)), None)
        if nxt is not None and nxt <= w:
            targets.add(nxt)
        base_bucket = plane_bucket_for(
            int(popcount_rows_np(
                fold_ops.fold_words(base[None, :], self.fold_factor)
            )[0]), w,
        )
        queries = [base]
        for bucket in sorted(targets - {base_bucket}):
            queries.append(self._synthetic_query(bucket))
        return queries

    def warmup(self, ks: Sequence[int] = (20, 128), max_batch: int = 1) -> None:
        """Search each of :meth:`_warmup_queries` at every batch size of
        ``(1, 2, 4, 8, ...)`` up to ``max_batch`` and every k of ``ks``,
        through the real path, so the server's first requests do not pay
        for first use: the first launch of each kernel module (CUDA loads
        modules lazily), the caching allocator's growth for the scan's
        outputs, phase 2's chunks and the top-k buffers at each (B, plane
        bucket, k_fetch), and the first pinned host copies. In a
        multi-process job every process must call this in lockstep: the
        searches join collectives, so process 0's query list is shared and
        every process runs the same searches in the same order."""
        if self.count == 0:
            return
        queries = self._warmup_queries()
        if self.mesh.n_processes > 1:
            queries = multihost.all_gather_object(queries)[0]
        batches = [b for b in _WARMUP_BATCHES if b == 1 or b <= max_batch]
        for query in queries:
            for b in batches:
                for k in ks:
                    self.search_batch(
                        np.tile(query, (b, 1)), k=min(int(k), self.count),
                        dbkey=self.dbkey,
                    )

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
        if self.scan_mode == "dense":
            query_arg = folded.view(np.int32)
        else:
            query_arg, _bucket = query_plane_indices(folded, self.device_bitcount)
        vals, idx, counts = sharded.sharded_local_topk(
            self._store, query_arg, popcount_rows_np(folded),
            np.array(cutoffs), k_fetch, similarity, alpha, beta,
        )
        vals, idx = vals.numpy(), idx.numpy()
        # per-shard counts (S, B), summed in int64
        approx = counts.to(torch.int64).sum(dim=0).numpy()

        selected = [
            self._assemble(
                queries[qi], vals[qi], idx[qi], int(ks[qi]), float(cutoffs[qi]),
                similarity, alpha, beta,
            )
            for qi in range(b)
        ]
        # the whole batch's strings at once: one collective when host-sharded
        smiles_b, ids_b = self._lookup_strings_batch([i for _, i in selected])
        results = []
        for qi, (svals, sidx) in enumerate(selected):
            result = SearchResult(
                smiles=smiles_b[qi],
                ids=ids_b[qi],
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
