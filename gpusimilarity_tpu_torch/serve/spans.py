"""Spans and counters of the served path, on one clock
(``time.monotonic_ns``).

A request's time splits into spans that follow it through the server:

* ``tpusim.front.parse`` (handler thread, HTTP or socket): the body read and
  form parse, ``fp_hex``/SMILES to words, up to the searcher;
* ``tpusim.batch.wait`` (the request's handler): enqueued until the pass
  that serves it starts, in two parts, ``window_part`` (until the batcher's
  drain closed) and ``pool_part`` (until a pool thread started the pass);
* ``tpusim.batch.window`` (batcher thread): the first item taken until the
  drain closes;
* on the pool thread, the pass's stages: ``tpusim.pass.prepare`` (key
  checks, query fold, plane lists, popcounts), ``tpusim.pass.launch``
  (every card's kernels and top-k queued, up to the copy back),
  ``tpusim.pass.wait`` (the host blocked in the copy back: the device's work
  it did not hide), ``tpusim.pass.shard_merge`` (the shards' candidates
  stacked, a multi-process job's gather and ``merge_topk``),
  ``tpusim.pass.assemble`` (``_assemble`` of every query, the fold > 1
  rescore included), ``tpusim.pass.strings`` (``_lookup_strings_batch``)
  and ``tpusim.pass.merge`` (``merge_results`` across databases);
* on the worker of each card (the pass's own thread when it has one card),
  beside the stages: ``tpusim.card.launch`` (the worker's start until its
  shards' work is queued) and ``tpusim.card.wait`` (from then until its
  copy back is done);
* ``tpusim.front.reply`` (the request's handler): from the end of its pass
  (so the handler's wake-up too) to the last byte written, JSON included.

What a pass spends outside its named stages is its stage ``other``, so the
stages add up to the pass, and parse + wait + pass + reply is the request's
time in the handler. The card spans overlap one another and the stages
``launch`` and ``wait``; the launches add up to ``card_launch_seconds``,
and each pass adds its last card's copy back done less its first's to
``card_lag_seconds`` (0 with one card).

Every span adds its nanoseconds to a :class:`Counters` of the registry
(``/stats``, always on: two clock reads and one add into a dict of the
calling thread's own, no lock). While a
:class:`~.profiler.ProfilerListener` exists, each span is also kept as a
record in a bounded ring (:data:`TRACE`) that the listener serves at
``GET /spans`` and merges into a capture's trace; the listener also opens
and closes the window in which the two ``torch.profiler`` spans
(``tpusim.request``, ``tpusim.search.<name>``) are entered at all
(:func:`profiler_span`).

:data:`STARTUP` holds the seconds from the process's start to each step of
the server's start-up.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

now = time.monotonic_ns

PARSE = "tpusim.front.parse"
WINDOW = "tpusim.batch.window"
WAIT = "tpusim.batch.wait"
PREPARE = "tpusim.pass.prepare"
LAUNCH = "tpusim.pass.launch"
PASS_WAIT = "tpusim.pass.wait"
SHARD_MERGE = "tpusim.pass.shard_merge"
ASSEMBLE = "tpusim.pass.assemble"
STRINGS = "tpusim.pass.strings"
MERGE = "tpusim.pass.merge"
REPLY = "tpusim.front.reply"
SPANS = (PARSE, WINDOW, WAIT, PREPARE, LAUNCH, PASS_WAIT, SHARD_MERGE, ASSEMBLE,
         STRINGS, MERGE, REPLY)
# a pass's spans on the worker of each card, beside its stages, and the
# counted spread of the cards' ends
CARD_LAUNCH = "tpusim.card.launch"
CARD_WAIT = "tpusim.card.wait"
CARD_SPANS = (CARD_LAUNCH, CARD_WAIT)
CARD_LAG = "card_lag"
# counted, never kept as records: the two parts of a request's wait, a
# pass's time outside its named stages, the requests answered, and the
# passes the batcher started at once, no pass being in flight
WINDOW_PART, POOL_PART, OTHER, REQUESTS = "window_part", "pool_part", "other", "requests"
IDLE_PASSES = "idle_passes"
STAGES = SPANS + (WINDOW_PART, POOL_PART, OTHER)
# the listener's marker at a capture's two ends: maps this clock onto the
# trace's
CLOCK_SPAN = "tpusim.clock"
RING_CAPACITY = 1 << 16
RECORD_FIELDS = ("seq", "name", "start_ns", "end_ns", "tid", "request", "pass",
                 "parent")

# ids of requests and passes, unique in the process
next_id = itertools.count(1).__next__


class Counters:
    """Cumulative nanoseconds (and counts) by name. Each thread adds into a
    dict of its own, so an add takes no lock; :meth:`totals` sums them and
    folds in the dicts of threads that have ended."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._threads: list[tuple[threading.Thread, dict]] = []
        self._ended: collections.Counter = collections.Counter()

    def add(self, name: str, value: int) -> None:
        try:
            mine = self._local.spent
        except AttributeError:
            mine = self._register()
        mine[name] = mine.get(name, 0) + value

    def _register(self) -> dict:
        mine = self._local.spent = {}
        with self._lock:
            self._fold_ended()
            self._threads.append((threading.current_thread(), mine))
        return mine

    def _fold_ended(self) -> None:
        alive = []
        for thread, spent in self._threads:
            if thread.is_alive():
                alive.append((thread, spent))
            else:
                self._ended.update(spent)
        self._threads = alive

    def totals(self) -> collections.Counter:
        with self._lock:
            self._fold_ended()
            out = collections.Counter(self._ended)
            for _, spent in self._threads:
                out.update(dict(spent))  # a copy: its thread may add meanwhile
        return out

    def stats(self, total_search_seconds: float) -> dict:
        """The ``/stats`` keys of these counters: ``requests``,
        ``idle_passes``, the seconds of the front end (parse and reply),
        the batch wait, the passes' copy-back wait and host time
        (``total_search_seconds`` less that wait), the card spans and the
        cards' lag, each stage's seconds, and :data:`STARTUP`'s steps."""
        spent = self.totals()

        def seconds(ns):
            return round(ns / 1e9, 6)

        pass_wait = seconds(spent[PASS_WAIT])
        return {
            "requests": spent[REQUESTS],
            "idle_passes": spent[IDLE_PASSES],
            "front_end_seconds": seconds(spent[PARSE] + spent[REPLY]),
            "queue_wait_seconds": seconds(spent[WAIT]),
            "pass_wait_seconds": pass_wait,
            "pass_host_seconds": round(total_search_seconds - pass_wait, 6),
            "card_launch_seconds": seconds(spent[CARD_LAUNCH]),
            "card_lag_seconds": seconds(spent[CARD_LAG]),
            "stages": {name: seconds(spent[name]) for name in STAGES},
            "startup": STARTUP.steps(),
        }


class _Trace:
    """What a :class:`~.profiler.ProfilerListener` turns on, process-wide
    as the profiler is: the ring of span records (while a listener exists)
    and the flag of a capture's open window."""

    def __init__(self):
        self.window_open = False
        self.ring: collections.deque | None = None
        self._seq = 0
        self._listeners = 0
        self._lock = threading.Lock()

    def attach(self) -> None:
        with self._lock:
            self._listeners += 1
            if self.ring is None:
                self.ring = collections.deque(maxlen=RING_CAPACITY)

    def detach(self) -> None:
        with self._lock:
            self._listeners -= 1
            if self._listeners == 0:
                self.ring = None

    def append(self, name, start, end, tid, request=None, pass_id=None,
               parent=None) -> None:
        if self.ring is None:
            return
        # numbered under the lock, so the ring's order is the numbers' and
        # a reader that asks for what follows a number misses nothing
        with self._lock:
            if self.ring is not None:
                self._seq += 1
                self.ring.append((self._seq, name, start, end, tid, request,
                                  pass_id, parent))

    def records(self, since: int = 0) -> list[tuple]:
        """The ring's records numbered above ``since``, oldest first."""
        with self._lock:
            ring = list(self.ring or ())
        return [r for r in ring if r[0] > since]

    def last_seq(self) -> int:
        return self._seq


TRACE = _Trace()
_NOTHING = contextlib.nullcontext()


def profiler_span(name: str):
    """``torch.profiler.record_function(name)`` while a capture's window is
    open; outside one, a span no profiler could record is not entered."""
    if not TRACE.window_open:
        return _NOTHING
    import torch

    return torch.profiler.record_function(name)


def record(counters: Counters, name: str, start: int, end: int, tid: int,
           request=None, pass_id=None, parent=None) -> None:
    counters.add(name, end - start)
    if TRACE.ring is not None:
        TRACE.append(name, start, end, tid, request, pass_id, parent)


class Request:
    """One request's stamps, from its front end to its reply."""

    __slots__ = ("id", "tid", "start", "enqueued", "drained", "pass_id",
                 "pass_end")

    def __init__(self, start: int | None = None):
        self.id = next_id()
        self.tid = threading.get_native_id()
        self.start = now() if start is None else start
        self.enqueued = self.drained = self.pass_id = self.pass_end = None


def served(counters: Counters, request: Request, pass_span: "PassSpan") -> None:
    """Count a request that ``pass_span`` answered: its parse, its wait in
    two parts, and one request (none if no pass was entered)."""
    if pass_span is None or pass_span.end is None:
        return
    request.pass_id, request.pass_end = pass_span.id, pass_span.end
    r, p, tid = request.id, pass_span.id, request.tid
    record(counters, PARSE, request.start, request.enqueued, tid, r, p, r)
    record(counters, WAIT, request.enqueued, pass_span.start, tid, r, p, r)
    counters.add(WINDOW_PART, request.drained - request.enqueued)
    counters.add(POOL_PART, pass_span.start - request.drained)
    counters.add(REQUESTS, 1)


def replied(counters: Counters, request: Request) -> None:
    """Count a request's reply, now written; a request that no pass
    answered (refused, failed or timed out) has none."""
    if request.pass_end is not None:
        record(counters, REPLY, request.pass_end, now(), request.tid,
               request.id, request.pass_id, request.id)


_local = threading.local()


class PassSpan:
    """One batched pass over the databases (the registry's
    ``search_databases_batch``): entered, it is the calling thread's
    :func:`current_pass`, into which the engine's stages record. ``idle``:
    the batcher started it at once, no pass being in flight."""

    __slots__ = ("id", "tid", "start", "end", "spent", "cards", "idle", "_outer")

    def __init__(self, idle: bool = False):
        self.id = next_id()
        self.idle = idle
        self.start = self.end = None
        self.spent: dict[str, int] = {}
        self.cards: dict[str, int] = {}

    def __enter__(self) -> "PassSpan":
        self.tid = threading.get_native_id()
        self._outer = getattr(_local, "current", None)
        _local.current = self
        self.start = now()
        return self

    def __exit__(self, *exc) -> None:
        self.end = now()
        _local.current = self._outer

    def stage(self, name: str, start: int, end: int | None = None) -> int:
        """Record stage ``name`` from ``start`` to ``end`` (now by
        default); returns ``end``, where the next stage starts."""
        end = now() if end is None else end
        self.spent[name] = self.spent.get(name, 0) + end - start
        if TRACE.ring is not None:
            TRACE.append(name, start, end, self.tid, None, self.id, self.id)
        return end

    def card_spans(self, cards) -> None:
        """Record each card's spans, ``cards`` holding one ``(began,
        queued, done, tid)`` per card from its worker, and the spread of
        their ``done``; called once the workers are joined."""
        for began, queued, done, tid in cards:
            self.cards[CARD_LAUNCH] = self.cards.get(CARD_LAUNCH, 0) + queued - began
            if TRACE.ring is not None:
                for name, start, end in ((CARD_LAUNCH, began, queued),
                                         (CARD_WAIT, queued, done)):
                    TRACE.append(name, start, end, tid, None, self.id, self.id)
        ends = [c[2] for c in cards]
        self.cards[CARD_LAG] = self.cards.get(CARD_LAG, 0) + max(ends) - min(ends)

    def count(self, counters: Counters) -> None:
        """Add this ended pass's stages to ``counters``, the rest of its
        time as ``other``, its card spans, and the pass to ``idle_passes``
        if idle (here, where the registry counts it in ``batches``, and not
        when its drain closed: the two counts then move together)."""
        for name, ns in (*self.spent.items(), *self.cards.items()):
            counters.add(name, ns)
        counters.add(OTHER, self.end - self.start - sum(self.spent.values()))
        if self.idle:
            counters.add(IDLE_PASSES, 1)


class _NoPass:
    """The pass of a search outside any served pass (warm-up, a direct
    engine call): its stages are timed by nobody."""

    @staticmethod
    def stage(name: str, start: int, end: int | None = None) -> int:
        return now() if end is None else end

    @staticmethod
    def card_spans(cards) -> None:
        pass


_NO_PASS = _NoPass()


def current_pass():
    """The calling thread's entered :class:`PassSpan`, or one that records
    nothing."""
    return getattr(_local, "current", None) or _NO_PASS


def chrome_events(records, clock, pid) -> list[dict]:
    """Records as Chrome trace events (``ph: X``, ``user_annotation``, on
    the thread that ran each) on a capture's clock: ``clock`` is two
    ``(monotonic_ns, trace_us)`` marks, and a record lying wholly between
    them is placed by the line through both."""
    (m0, t0), (m1, t1) = clock
    scale = (t1 - t0) / (m1 - m0) if m1 > m0 else 1e-3
    out = []
    for seq, name, start, end, tid, request, pass_id, parent in records:
        if start < m0 or end > m1:
            continue
        out.append({"ph": "X", "cat": "user_annotation", "name": name,
                    "pid": pid, "tid": tid, "ts": t0 + (start - m0) * scale,
                    "dur": (end - start) * scale,
                    "args": {"request": request, "pass": pass_id,
                             "parent": parent, "seq": seq}})
    return out


def process_age_s(pid="self") -> float:
    """Seconds since process ``pid`` started (``/proc/<pid>/stat``, to the
    kernel's clock tick)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


class Startup:
    """Seconds from this process's start to each step of the server's
    start-up, in the order they were reached."""

    def __init__(self):
        self._steps: dict[str, float] = {}

    def mark(self, step: str) -> None:
        try:
            age = process_age_s()
        except OSError:  # no /proc: from this module's import instead
            age = time.monotonic() - _IMPORTED
        self._steps[step] = round(age, 6)

    def steps(self) -> dict[str, float]:
        return dict(self._steps)


_IMPORTED = time.monotonic()
STARTUP = Startup()
