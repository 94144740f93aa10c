"""DatabaseRegistry — multi-database loading, search dispatch and result
merge (twin of ``gpusimilarity_tpu/models/registry.py``).

Databases are keyed by file basename, one fold factor is derived from the
total size against free device memory, and multi-database searches merge
score-sorted results, dropping duplicate SMILES and joining their IDs with
``";:;"`` (reference ``gpusim.cpp:87-166, 306-374``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Sequence

import numpy as np
import torch

from gpusimilarity_tpu.utils.fsim import FingerprintData

from ..ops.scan import TANIMOTO
from ..parallel.mesh import auto_fold_factor
from .fingerprint_db import FingerprintDB
from .results import SearchResult

log = logging.getLogger("tpusimilarity")

ID_JOIN = ";:;"  # reference's duplicate-compound ID separator (gpusim.cpp:354)


def resolve_scan_mode(effective_fold: int) -> str:
    """The ``auto`` scan mode for the EFFECTIVE fold factor.

    An unfolded library resolves to ``bitplane`` on CUDA and on the CPU
    alike (the CPU runs the plain versions of the same path). A folded one
    resolves to ``dense``, as in the JAX package — which the port does not
    serve yet, so the engine then raises ``NotImplementedError``.
    """
    return "dense" if int(effective_fold) > 1 else "bitplane"


class DatabaseRegistry:
    """A set of named FingerprintDBs sharing one device and fold factor."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self._dbs: dict[str, FingerprintDB] = {}
        self.search_count = 0
        self.total_search_seconds = 0.0
        self._stats_lock = threading.Lock()

    @classmethod
    def from_fsim_files(
        cls,
        paths: Sequence[str],
        device: torch.device | str = "cpu",
    ) -> "DatabaseRegistry":
        """Load ``.fsim`` files or ``.tfsim`` directories; database names
        are file basenames (reference ``gpusim.cpp:114-116``). The fold
        factor comes from the total size against free device memory, and the
        scan mode from the fold."""
        from gpusimilarity_tpu.utils.tfsim import load_any

        reg = cls(device=device)
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

        # one fold for all databases (reference gpusim.cpp:119-143)
        fold = auto_fold_factor(
            sum(d.fingerprints.nbytes for _, d in datas), reg.device
        )
        scan_mode = resolve_scan_mode(fold)
        for name, data in datas:
            t0 = time.monotonic()
            reg.add(name, data, fold_factor=fold, scan_mode=scan_mode)
            log.info(
                "uploaded %s to %s (%.2fs)", name, reg.device,
                time.monotonic() - t0,
            )
        return reg

    def add(
        self,
        name: str,
        data: FingerprintData,
        fold_factor: int = 1,
        scan_mode: str = "bitplane",
    ) -> FingerprintDB:
        if name in self._dbs:
            raise ValueError(f"database name {name!r} already loaded")
        db = FingerprintDB(
            data, device=self.device, fold_factor=fold_factor,
            scan_mode=scan_mode,
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

    def stats(self) -> dict:
        from ..ops.bitplane_phase1 import launch_count

        with self._stats_lock:
            searches, seconds = self.search_count, self.total_search_seconds
        return {
            "databases": {
                name: {
                    "count": db.count,
                    "bitcount": db.bitcount,
                    "device_bitcount": db.device_bitcount,
                    "fold_factor": db.fold_factor,
                    "shards": 1,  # one device holds the whole library
                    "device_bytes": db.store.nbytes,
                }
                for name, db in self._dbs.items()
            },
            "device": str(self.device),
            "searches": searches,
            "total_search_seconds": round(seconds, 6),
            "kernel_launches": {"bitplane_phase1": launch_count()},
        }

    # ----------------------------------------------------------------- search

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
    ) -> list[SearchResult]:
        """One device pass per database for the whole ``(B, W)`` batch,
        then a per-query cross-database merge."""
        t0 = time.monotonic()
        b = len(queries)
        for name in dbnames:
            if name not in self._dbs:
                raise KeyError(f"unknown database {name!r}")
        per_db = []
        for name, key in zip(dbnames, dbkeys):
            with torch.profiler.record_function(f"gpusim.search.{name}"):
                per_db.append(
                    self._dbs[name].search_batch(
                        queries, k=list(ks), cutoff=list(cutoffs), dbkey=key,
                        similarity=similarity, alpha=alpha, beta=beta,
                    )
                )
        merged = [
            merge_results([db_results[qi] for db_results in per_db], int(ks[qi]))
            for qi in range(b)
        ]
        elapsed = time.monotonic() - t0
        with self._stats_lock:
            self.search_count += b
            self.total_search_seconds += elapsed
        log.info(
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
