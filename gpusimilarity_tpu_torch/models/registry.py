"""DatabaseRegistry — multi-database loading, search dispatch and result
merge (twin of ``gpusimilarity_tpu/models/registry.py``).

Databases are keyed by file basename and share one mesh of devices, one
fold factor is derived from the total size against the mesh's free device
memory, and multi-database searches merge score-sorted results, dropping
duplicate SMILES and joining their IDs with ``";:;"`` (reference
``gpusim.cpp:87-166, 306-374``). In a multi-process job process 0's
searches go through a :class:`~..parallel.multihost.MultihostController`,
which runs :meth:`DatabaseRegistry._execute_batch` on every process.
Each batched pass is a :class:`~..serve.spans.PassSpan` whose stages add
into the registry's :attr:`~DatabaseRegistry.counters`, served in
:meth:`~DatabaseRegistry.stats` beside the pass counts.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..ops.scan import TANIMOTO
from ..parallel import multihost
from ..parallel.mesh import Mesh, auto_fold_factor, resolve_mesh
from ..serve import spans
from ..utils.fsim import FingerprintData
from ..utils.tfsim import load_any
from .fingerprint_db import FingerprintDB
from .results import SearchResult

log = logging.getLogger("tpusimilarity")

ID_JOIN = ";:;"  # reference's duplicate-compound ID separator (gpusim.cpp:354)


def resolve_scan_mode(
    scan_mode: str, effective_fold: int, popless: bool = False
) -> str:
    """The concrete scan mode for ``--scan_mode`` and the EFFECTIVE fold
    factor (after the registry's memory-based fold decision).

    ``auto`` resolves as the JAX package resolves it on an accelerator:
    ``bitplane`` for an unfolded library, ``dense`` for a folded one
    (folding densifies queries, which the bitplane scan pays for per set
    bit). The CPU resolves the same way, running the plain versions of the
    same paths. A popless store is dense-only, so ``popless`` forces
    ``dense``. A multi-process library resolves the same way: each process
    builds its own shards' planes, so bitplane stays available.
    """
    if scan_mode not in ("auto", "dense", "bitplane"):
        raise ValueError(f"unknown scan_mode {scan_mode!r}")
    if popless:
        return "dense"
    if scan_mode == "auto":
        return "dense" if int(effective_fold) > 1 else "bitplane"
    return scan_mode


class DatabaseRegistry:
    """A set of named FingerprintDBs sharing one mesh and fold factor."""

    def __init__(self, device: torch.device | str | None = None,
                 mesh: Mesh | None = None):
        """The databases shard over ``mesh``, by default every visible card
        (raises without one); ``device`` is shorthand for a one-shard mesh,
        and ``device="cpu"`` runs the plain versions on the host."""
        self.mesh = resolve_mesh(mesh, device)
        self.device = self.mesh.devices[0]
        self._dbs: dict[str, FingerprintDB] = {}
        self.search_count = 0
        self.batch_count = 0
        self.total_search_seconds = 0.0
        self._stats_lock = threading.Lock()
        # the served path's spans, by name (serve/spans.py)
        self.counters = spans.Counters()
        # set on process 0 of a multi-process job: fans each search out to
        # every process (parallel.multihost.MultihostController)
        self.multihost_controller = None

    @classmethod
    def from_fsim_files(
        cls,
        paths: Sequence[str],
        device: torch.device | str | None = None,
        device_bitcount: int = 0,
        fold_factor: int | None = None,
        scan_mode: str = "auto",
        popless: bool = False,
        mesh: Mesh | None = None,
        async_prewarm: bool = False,
        on_loaded=None,
    ) -> "DatabaseRegistry":
        """Load ``.fsim`` files or ``.tfsim`` directories; database names
        are file basenames (reference ``gpusim.cpp:114-116``).

        Unless ``fold_factor`` is given, one fold factor comes from the
        total size against the mesh's free device memory and
        ``device_bitcount`` (:meth:`_global_fold`). ``scan_mode`` (``auto``,
        ``dense`` or ``bitplane``) is resolved after it, from the effective
        fold (:func:`resolve_scan_mode`). Every process of a multi-process
        job calls this with the same arguments, in lockstep.
        ``async_prewarm=True`` (the one-process server) marks each database
        ready once it is uploaded and warms its memory-mapped pages on a
        background thread (``FingerprintDB.upload``); a multi-process job
        always warms before it returns. ``on_loaded()``, if given, is called
        once every library is loaded, before the first upload."""
        reg = cls(device=device, mesh=mesh)
        datas: list[tuple[str, FingerprintData]] = []
        for p in paths:
            name = os.path.basename(str(p).rstrip("/"))
            for suffix in (".fsim", ".tfsim"):
                if name.endswith(suffix):
                    name = name[: -len(suffix)]
            t0 = time.monotonic()
            data = load_any(p)
            log.info(
                "loaded %s: %d compounds, %d bits, dbkey=%r (%.2fs)",
                name, data.count, data.bitcount, data.dbkey,
                time.monotonic() - t0,
            )
            datas.append((name, data))
        if on_loaded is not None:
            on_loaded()

        fold = fold_factor if fold_factor is not None else cls._global_fold(
            datas, device_bitcount, reg.mesh
        )
        mode = resolve_scan_mode(scan_mode, fold, popless)
        log.info("scan mode %s (requested %s, effective fold %d%s)", mode,
                 scan_mode, fold, ", popless" if popless else "")
        async_prewarm = async_prewarm and reg.mesh.n_processes == 1
        for name, data in datas:
            t0 = time.monotonic()
            reg.add(name, data, fold_factor=fold, scan_mode=mode, popless=popless,
                    async_prewarm=async_prewarm)
            log.info(
                "uploaded %s to %d shards on %s (%.2fs%s)", name,
                reg.mesh.n_shards, ", ".join(map(str, reg.mesh.distinct_devices)),
                time.monotonic() - t0,
                "; page prewarm continues in background" if async_prewarm else "",
            )
        return reg

    @staticmethod
    def _global_fold(
        datas: Sequence[tuple[str, FingerprintData]],
        device_bitcount: int,
        mesh: Mesh,
    ) -> int:
        """One fold factor for all databases, from their total bytes against
        the mesh's free device memory, raised to what ``device_bitcount``
        asks for (reference ``gpusim.cpp:119-151``). Raises ``MemoryError``
        when that width cannot hold the data. In a multi-process job the
        processes take the largest of their folds (one collective), since
        each reads only its own cards' memory and they must agree."""
        fold = auto_fold_factor(
            sum(d.fingerprints.nbytes for _, d in datas), mesh
        )
        if mesh.n_processes > 1:
            fold = int(multihost.all_gather_array(np.array([fold])).max())
        if device_bitcount and datas:
            # the widest database decides (reference max_fp_bitcount)
            bitcount = max(d.bitcount for _, d in datas)
            requested = max(1, bitcount // device_bitcount)
            if requested < fold:
                raise MemoryError(
                    f"device_bitcount {device_bitcount} needs fold "
                    f"{requested}, but the data requires at least {fold} "
                    "to fit in device memory"
                )
            fold = requested
        if fold > 1:
            log.info("folding fingerprints by %d to fit device memory", fold)
        return fold

    def add(
        self,
        name: str,
        data: FingerprintData,
        fold_factor: int = 1,
        scan_mode: str = "bitplane",
        popless: bool = False,
        async_prewarm: bool = False,
    ) -> FingerprintDB:
        if name in self._dbs:
            raise ValueError(f"database name {name!r} already loaded")
        db = FingerprintDB(
            data, fold_factor=fold_factor, scan_mode=scan_mode,
            popless=popless, mesh=self.mesh, async_prewarm=async_prewarm,
        )
        self._dbs[name] = db
        return db

    # ----------------------------------------------------------------- access

    def names(self) -> list[str]:
        return sorted(self._dbs)

    def get(self, name: str) -> FingerprintDB:
        return self._dbs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._dbs

    def warmup(self, ks: Sequence[int] = (20, 128), max_batch: int = 1) -> None:
        """Warm each database's common search shapes
        (:meth:`FingerprintDB.warmup`), in name order; called at server
        start unless disabled, on every process of a multi-process job. The
        warm-up's searches are not counted in :meth:`stats`."""
        for name in self.names():
            t0 = time.monotonic()
            self._dbs[name].warmup(ks=ks, max_batch=max_batch)
            log.info("warmed up %s (%.2fs)", name, time.monotonic() - t0)

    def stats(self) -> dict:
        from ..ops import bitplane_phase1, dense_phase1

        with self._stats_lock:
            searches, batches = self.search_count, self.batch_count
            seconds = self.total_search_seconds
        served = self.counters.stats(seconds)
        return {
            "databases": {
                name: {
                    "count": db.count,
                    "bitcount": db.bitcount,
                    "device_bitcount": db.device_bitcount,
                    "fold_factor": db.fold_factor,
                    "scan_mode": db.scan_mode,
                    "popless": db.popless,
                    "shards": db.store.n_shards,
                    "device_bytes": db.store.nbytes,
                }
                for name, db in self._dbs.items()
            },
            "device": ", ".join(map(str, self.mesh.distinct_devices)),
            "processes": self.mesh.n_processes,
            "searches": searches,
            "batches": batches,
            "total_search_seconds": round(seconds, 6),
            "kernel_launches": {
                "bitplane_phase1": bitplane_phase1.launch_count(),
                "dense_phase1": dense_phase1.launch_count(),
            },
            **served,
        }

    # ----------------------------------------------------------------- search

    def search_databases(
        self,
        dbnames: Sequence[str],
        dbkeys: Sequence[str],
        query: np.ndarray,
        k: int = 20,
        cutoff: float = 0.0,
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
    ) -> SearchResult:
        """Search several databases and merge (reference ``searchDatabases``,
        ``gpusim.cpp:306-374``): sort all results descending by score, drop
        duplicate SMILES joining their IDs with ``";:;"``, truncate to k, and
        sum approximate counts."""
        [merged] = self.search_databases_batch(
            dbnames, dbkeys, np.asarray(query)[None, :], [k], [cutoff],
            similarity=similarity, alpha=alpha, beta=beta,
        )
        return merged

    def _execute_batch(
        self, dbnames, key_oks, queries, ks, cutoffs, similarity, alpha, beta
    ) -> list:
        """One device pass per database: the half of a search that every
        process of a multi-process job runs, identically (workers call it
        from ``MultihostController.serve_worker``). What could differ
        between processes (key checks, name resolution) is decided before
        and travels as ``key_oks``."""
        per_db = []
        for name, ok in zip(dbnames, key_oks):
            db = self._dbs[name]
            # a key mismatch takes the engine's empty-result path on every
            # process alike (no kernel runs)
            key = db.dbkey if ok else db.dbkey + "\x00mismatch"
            with spans.profiler_span(f"tpusim.search.{name}"):
                per_db.append(
                    db.search_batch(
                        queries, k=list(ks), cutoff=list(cutoffs), dbkey=key,
                        similarity=similarity, alpha=alpha, beta=beta,
                    )
                )
        return per_db

    def search_databases_batch(
        self,
        dbnames: Sequence[str],
        dbkeys: Sequence[str],
        queries: np.ndarray,
        ks: Sequence[int],
        cutoffs: Sequence[float],
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
        pass_span: spans.PassSpan | None = None,
    ) -> list[SearchResult]:
        """One device pass per database for the whole ``(B, W)`` batch,
        then a per-query cross-database merge. With a
        :attr:`multihost_controller` the pass runs on every process. The
        pass is ``pass_span`` (a new one by default): its time counts in
        ``total_search_seconds`` and its stages in :attr:`counters`."""
        pass_span = pass_span or spans.PassSpan()
        b = len(queries)
        with pass_span:
            for name in dbnames:
                if name not in self._dbs:
                    raise KeyError(f"unknown database {name!r}")
            key_oks = [
                key == self._dbs[name].dbkey for name, key in zip(dbnames, dbkeys)
            ]
            if self.multihost_controller is not None:
                per_db = self.multihost_controller.dispatch_batch(
                    list(dbnames), key_oks, queries, list(ks), list(cutoffs),
                    similarity, alpha, beta,
                )
            else:
                per_db = self._execute_batch(
                    dbnames, key_oks, queries, ks, cutoffs, similarity, alpha, beta
                )
            t = spans.now()
            merged = [
                merge_results([db_results[qi] for db_results in per_db], int(ks[qi]))
                for qi in range(b)
            ]
            pass_span.stage(spans.MERGE, t)
        elapsed = (pass_span.end - pass_span.start) / 1e9
        with self._stats_lock:
            self.search_count += b
            self.batch_count += 1
            self.total_search_seconds += elapsed
        pass_span.count(self.counters)
        log.debug(
            "batched search over %s: %d queries, %.1f ms",
            list(dbnames), b, elapsed * 1e3,
        )
        return merged


def merge_results(results: Sequence[SearchResult], k: int) -> SearchResult:
    """Score-sorted cross-database merge with SMILES dedup + ID joining."""
    rows = []
    for db_order, r in enumerate(results):
        for smi, cid, score in zip(r.smiles, r.ids, r.scores):
            rows.append((-score, db_order, cid, smi))
    rows.sort()

    seen: dict[str, int] = {}
    out = SearchResult(approximate_count=sum(r.approximate_count for r in results))
    for neg_score, _, cid, smi in rows:
        if smi in seen:
            out.ids[seen[smi]] += ID_JOIN + cid
            continue
        if len(out.scores) >= k:
            continue
        seen[smi] = len(out.scores)
        out.smiles.append(smi)
        out.ids.append(cid)
        out.scores.append(-neg_score)
    return out
