"""Query batching: coalesce concurrent requests into one kernel launch
(after ``gpusimilarity_tpu/serve/batching.py``, whose window always runs).

Concurrent requests that target the same database set and scoring mode
become one ``(B, P)`` search — one phase-1 kernel launch per database —
instead of B launches. When the batcher's drain wakes with no pass in
flight and the last pass answered a single caller, no other caller is
about to send, so it closes at once with the request that woke it and
whatever already sits in the queue (its passes are *idle passes*,
counted as ``idle_passes``). Otherwise it gathers for ``window_ms``
first: requests that arrive while the card is busy share the next pass,
and so do the callers of a pass of several, who send again together
(a closed loop of clients). Groups run on a small
thread pool within the same drain cycle; PyTorch launches from several
threads are safe and the card serialises them on its stream.

Each caller's request carries a :class:`~.spans.Request`: the batcher's
drain stamps it, the pass that answers it (a :class:`~.spans.PassSpan`)
gives it its pass id, and the caller counts its parse and its wait in the
registry's counters (:mod:`.spans`).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..models.registry import DatabaseRegistry
from ..models.results import SearchResult
from ..ops.scan import TANIMOTO
from . import spans

# how long a caller waits for its result: PyTorch compiles nothing at run
# time, so this covers a full-library search behind a queue of others
DEFAULT_RESULT_TIMEOUT_S = 300.0


@dataclass
class _Pending:
    dbnames: tuple[str, ...]
    dbkeys: tuple[str, ...]
    query: np.ndarray
    k: int
    cutoff: float
    similarity: str
    alpha: float
    beta: float
    request: spans.Request
    future: Future = field(default_factory=Future)
    pass_span: spans.PassSpan | None = None

    def group_key(self):
        return (self.dbnames, self.dbkeys, self.similarity, self.alpha, self.beta)


class BatchingSearcher:
    """Thread-safe search front end that batches concurrent callers.
    ``window_ms`` is how long a drain gathers while a pass is in flight,
    or after a pass that answered several callers."""

    def __init__(
        self,
        registry: DatabaseRegistry,
        max_batch: int = 64,
        window_ms: float = 2.0,
        result_timeout_s: float = DEFAULT_RESULT_TIMEOUT_S,
    ):
        self._registry = registry
        self._max_batch = max_batch
        self._window_s = window_ms / 1e3
        self._result_timeout_s = result_timeout_s
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # passes submitted whose results are not handed back yet, and the
        # requests of the last to end: a drain that finds none in flight
        # after a pass of one closes at once
        self._in_flight = 0
        self._last_pass_requests = 1
        self._in_flight_lock = threading.Lock()
        # groups run on a small pool, not inline in the drain loop, so one
        # slow group does not stall the others and all new arrivals
        self._pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="gpusim-scan"
        )
        self._worker = threading.Thread(
            target=self._run, name="gpusim-batcher", daemon=True
        )
        self._worker.start()

    @property
    def registry(self) -> DatabaseRegistry:
        return self._registry

    def search(
        self,
        dbnames,
        dbkeys,
        query: np.ndarray,
        k: int = 20,
        cutoff: float = 0.0,
        similarity: str = TANIMOTO,
        alpha: float = 1.0,
        beta: float = 1.0,
        timeout: float | None = None,  # None -> the searcher's default
        request: spans.Request | None = None,
    ) -> SearchResult:
        """Blocking search; may share a device pass with concurrent callers.
        ``request`` is the front end's, stamped since the request arrived;
        without one the request starts here."""
        if timeout is None:
            timeout = self._result_timeout_s
        request = request or spans.Request()
        item = _Pending(
            dbnames=tuple(dbnames),
            dbkeys=tuple(dbkeys),
            query=np.asarray(query, dtype=np.uint32),
            k=int(k),
            cutoff=float(cutoff),
            similarity=similarity,
            alpha=float(alpha),
            beta=float(beta),
            request=request,
        )
        request.enqueued = spans.now()
        self._queue.put(item)
        result = item.future.result(timeout=timeout)
        spans.served(self._registry.counters, request, item.pass_span)
        return result

    def close(self):
        self._stop.set()
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout=5)
        self._pool.shutdown(wait=False)

    # ------------------------------------------------------------- internals

    def _drain_batch(self) -> tuple[list[_Pending], bool]:
        """The next batch, and whether it was drained at once, without the
        window (no pass in flight, and the last answered one caller)."""
        first = self._queue.get()
        if first is None:
            return [], False
        opened = spans.now()
        batch = [first]
        # only this thread submits passes, so the count can fall but not
        # rise before this drain's own are submitted
        with self._in_flight_lock:
            idle = self._in_flight == 0 and self._last_pass_requests == 1
        deadline = None if idle else time.monotonic() + self._window_s
        while len(batch) < self._max_batch:
            try:
                if deadline is None:  # idle: only what is already queued
                    item = self._queue.get_nowait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        closed = spans.now()
        for item in batch:
            item.request.drained = closed
        spans.record(self._registry.counters, spans.WINDOW, opened, closed,
                     threading.get_native_id())
        return batch, idle

    def _run(self):
        while not self._stop.is_set():
            batch, idle = self._drain_batch()
            if not batch:
                continue
            groups: dict[tuple, list[_Pending]] = {}
            for item in batch:
                groups.setdefault(item.group_key(), []).append(item)
            for key, items in groups.items():
                with self._in_flight_lock:
                    self._in_flight += 1
                try:
                    self._pool.submit(self._run_group, key, items, idle)
                except RuntimeError:
                    # pool already shut down (close() raced a slow drain):
                    # run inline so no caller's future hangs for its full
                    # result() timeout
                    self._run_group(key, items, idle)
        # resolve anything still queued at shutdown instead of leaving the
        # callers blocked in future.result()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(
                    RuntimeError("server shutting down")
                )

    def _run_group(self, key, items, idle):
        dbnames, dbkeys, similarity, alpha, beta = key
        pass_span = spans.PassSpan(idle)
        for it in items:
            it.pass_span = pass_span
        failure = None
        try:
            queries = np.stack([it.query for it in items])
            results = self._registry.search_databases_batch(
                dbnames,
                dbkeys,
                queries,
                ks=[it.k for it in items],
                cutoffs=[it.cutoff for it in items],
                similarity=similarity,
                alpha=alpha,
                beta=beta,
                pass_span=pass_span,
            )
        except Exception as e:  # delivered to every caller below
            failure = e
        finally:
            # before any caller wakes: a closed-loop caller's next request
            # must not find its own finished pass still in flight
            with self._in_flight_lock:
                self._in_flight -= 1
                self._last_pass_requests = len(items)
        if failure is not None:
            for it in items:
                it.future.set_exception(failure)
            return
        for it, r in zip(items, results):
            it.future.set_result(r)
