"""The one traffic generator: every mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads.

Keys of a mix:

* ``loop``: ``"open"`` (independent users: requests sent on a schedule,
  whatever the server's backlog) or ``"closed"`` (``clients`` callers, each
  sending its next request when its reply arrives);
* open loop: ``rate_qps`` and ``arrivals`` (``"poisson"``: exponential gaps)
  and ``senders`` (threads that carry the requests; each request is timed
  from the moment it was due, and how late it was sent is recorded);
* ``k``, ``cutoff``, ``similarity``: the form fields of each request;
* ``query_pool``: how many distinct library rows, drawn uniformly from the
  seed, the requests take as queries (``fp_hex``), in turn;
* ``warm_s``: seconds of the mix's own traffic before the window, counted
  in set-up and not measured;
* ``check_sample``: how many of the window's answers the reference checks;
* ``server_flags``: the server flags the mix needs (its warm-up shapes).

Every seed gets the same set of gaps, the exponential distribution's
quantiles, in an order drawn from the seed: the warm traffic and the window
each as a stream of its own, so the window holds the same number of
requests, at the same mean rate, for every seed.
"""

from __future__ import annotations

import http.client
import math
import queue
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

import numpy as np

PATH = "/similarity_search_json"
HEADERS = {"Content-Type": "application/x-www-form-urlencoded"}
REQUEST_TIMEOUT_S = 120.0
# what a failed request adds to its latency, so that it lies over any limit
FAILED_PENALTY_S = 600.0


def query_pool(n_rows: int, size: int, seed: int) -> np.ndarray:
    """Distinct library rows, uniformly drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    size = min(size, n_rows)
    if n_rows <= 4 * size:
        return rng.permutation(n_rows)[:size].astype(np.int64)
    picked = np.unique(rng.integers(0, n_rows, size=2 * size))
    return rng.permutation(picked)[:size].astype(np.int64)


def poisson_gaps(rate: float, duration_s: float, seed: int, stream: int = 2) -> np.ndarray:
    """Gaps of a Poisson stream of ``rate`` over ``duration_s``: the
    quantiles of the exponential distribution, ``round(rate * duration_s)``
    of them summing to ``duration_s``, the same set for every seed, in the
    seed's order."""
    n = max(1, round(rate * duration_s))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= duration_s / gaps.sum()
    return np.random.default_rng([seed, stream]).permutation(gaps)


def poisson_offsets(rate: float, duration_s: float, seed: int,
                    stream: int = 2) -> np.ndarray:
    """Due times (seconds from the start) of the stream over ``duration_s``:
    the first at 0, each later one a gap after the one before."""
    gaps = poisson_gaps(rate, duration_s, seed, stream)
    return np.cumsum(gaps) - gaps


def request_body(hex_query: str, mix: dict, dbname: str) -> bytes:
    return urllib.parse.urlencode({
        "fp_hex": hex_query,
        "return_count": mix["k"],
        "similarity_cutoff": mix.get("cutoff", 0),
        "similarity": mix.get("similarity", "tanimoto"),
        "dbnames": dbname,
    }).encode()


class Client:
    """One keep-alive connection; a dropped one is reopened once."""

    def __init__(self, port: int):
        self.port = port
        self.conn = None

    def post(self, body: bytes) -> tuple[int, bytes]:
        for attempt in range(2):
            try:
                if self.conn is None:
                    self.conn = http.client.HTTPConnection(
                        "localhost", self.port, timeout=REQUEST_TIMEOUT_S)
                self.conn.request("POST", PATH, body, HEADERS)
                r = self.conn.getresponse()
                return r.status, r.read()
            except (OSError, http.client.HTTPException):
                if self.conn is not None:
                    self.conn.close()
                self.conn = None
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()


@dataclass
class Record:
    """One request: its query (an index into the pool), when it was due
    (open loop; the send time in a closed loop), sent and answered
    (``time.monotonic``), the HTTP status (0: no reply) and the body."""

    query: int
    due: float
    sent: float = math.nan
    done: float = math.nan
    status: int = 0
    body: bytes = b""

    @property
    def ok(self) -> bool:
        return self.status == 200

    @property
    def latency(self) -> float:
        if not self.ok or math.isnan(self.done):
            end = self.done if not math.isnan(self.done) else self.due
            return end - self.due + FAILED_PENALTY_S
        return self.done - self.due


@dataclass
class Load:
    """What one stretch of traffic did: every request, and the clock of the
    window inside it."""

    records: list
    t0: float
    t1: float
    extra: dict = field(default_factory=dict)

    def in_window(self) -> list:
        return [r for r in self.records if self.t0 <= r.due < self.t1]


def _send(client: Client, body: bytes, rec: Record) -> None:
    rec.sent = time.monotonic()
    try:
        rec.status, rec.body = client.post(body)
    except (OSError, http.client.HTTPException):
        rec.status = 0
    rec.done = time.monotonic()


def run_open(port: int, bodies: list, rate: float, start: float, warm_s: float,
             seconds: float, senders: int, seed: int, on_window=None) -> Load:
    """Send at the due times of a Poisson stream from ``start`` (a
    ``time.monotonic`` value) for ``warm_s + seconds``; ``on_window(t0,
    t1)`` is called from a thread of its own at the window's start."""
    offsets = np.concatenate([poisson_offsets(rate, warm_s, seed, stream=5) if warm_s > 0
                              else np.zeros(0),
                              warm_s + poisson_offsets(rate, seconds, seed)])
    records = [Record(query=i % len(bodies), due=start + off)
               for i, off in enumerate(offsets)]
    pending: queue.SimpleQueue = queue.SimpleQueue()

    def worker():
        client = Client(port)
        try:
            while (rec := pending.get()) is not None:
                _send(client, bodies[rec.query], rec)
        finally:
            client.close()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(senders)]
    for t in threads:
        t.start()
    t0, t1 = start + warm_s, start + warm_s + seconds
    watcher = _window_watcher(t0, t1, on_window)
    for rec in records:
        wait = rec.due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        pending.put(rec)
    for _ in threads:
        pending.put(None)
    for t in threads:
        t.join(REQUEST_TIMEOUT_S * 2)
    if watcher is not None:
        watcher.join(REQUEST_TIMEOUT_S)
    late = [r.sent - r.due for r in records if t0 <= r.due < t1 and not math.isnan(r.sent)]
    return Load(records, t0, t1, {
        "late_p50_ms": float(np.percentile(late, 50) * 1e3) if late else None,
        "late_max_ms": float(max(late) * 1e3) if late else None,
    })


def run_closed(port: int, bodies: list, clients: int, start: float,
               warm_s: float, seconds: float, on_window=None) -> Load:
    """``clients`` callers, each sending its next request when the last one
    is answered, from ``start`` until the window's end."""
    t0, t1 = start + warm_s, start + warm_s + seconds
    lock = threading.Lock()
    counter = iter(range(1 << 62))
    per_client: list[list] = [[] for _ in range(clients)]

    def caller(c: int):
        client = Client(port)
        try:
            while True:
                with lock:
                    i = next(counter)
                now = time.monotonic()
                if now >= t1:
                    return
                rec = Record(query=i % len(bodies), due=now)
                per_client[c].append(rec)
                _send(client, bodies[rec.query], rec)
        finally:
            client.close()

    wait = start - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    threads = [threading.Thread(target=caller, args=(c,), daemon=True)
               for c in range(clients)]
    watcher = _window_watcher(t0, t1, on_window)
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + warm_s + REQUEST_TIMEOUT_S * 2)
    if watcher is not None:
        watcher.join(REQUEST_TIMEOUT_S)
    records = sorted((r for rs in per_client for r in rs), key=lambda r: r.due)
    return Load(records, t0, t1)


def _window_watcher(t0: float, t1: float, on_window):
    if on_window is None:
        return None

    def watch():
        wait = t0 - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        on_window(t0, t1)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    return t


def run(port: int, mix: dict, bodies: list, start: float, seconds: float,
        seed: int, on_window=None, rate: float | None = None) -> Load:
    """The mix's loop over ``bodies`` (one request body per pool row), with
    a :class:`StallProbe` beside it."""
    warm_s = float(mix.get("warm_s", 0))
    probe = StallProbe()
    try:
        if mix["loop"] == "open":
            if mix.get("arrivals", "poisson") != "poisson":
                raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
            load = run_open(port, bodies, rate or float(mix["rate_qps"]), start, warm_s,
                            seconds, int(mix["senders"]), seed, on_window)
        elif mix["loop"] == "closed":
            load = run_closed(port, bodies, int(mix["clients"]), start, warm_s,
                              seconds, on_window)
        else:
            raise ValueError(f"unknown loop {mix['loop']!r}")
    finally:
        probe.stop()
    load.extra.update(probe.summary(load))
    return load


class StallProbe:
    """A thread of the generator's own process that wakes every ``TICK_S``
    and keeps each wake that came ``LATE_S`` or more late: the moments the
    generator's process (its threads, its interpreter lock, its share of
    the cores) stalled. A slow request that overlaps no stall of the
    generator was slow in the server or the socket between them."""

    TICK_S = 0.005
    LATE_S = 0.002
    STALL_S = 0.020
    SLOW_S = 0.050

    def __init__(self):
        self.late: list[tuple[float, float]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._tick, daemon=True)
        self._thread.start()

    def _tick(self) -> None:
        while not self._stop.is_set():
            due = time.monotonic() + self.TICK_S
            time.sleep(self.TICK_S)
            now = time.monotonic()
            if now - due >= self.LATE_S:
                self.late.append((due, now))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(1.0)

    def summary(self, load: Load) -> dict:
        """Over the window: the longest stall of the generator (ms; under
        ``LATE_S`` reads 0), the requests slower than ``SLOW_S`` and how
        many of them overlap a stall of ``STALL_S`` or more."""
        late = [(a, b) for a, b in self.late if b > load.t0 and a < load.t1]
        stalls = [(a, b) for a, b in late if b - a >= self.STALL_S]
        slow = [r for r in load.in_window()
                if r.ok and r.done - r.due > self.SLOW_S]
        return {
            "harness_stall_max_ms": 1e3 * max((b - a for a, b in late), default=0.0),
            "slow_requests": len(slow),
            "slow_requests_in_harness_stall": sum(
                1 for r in slow if any(a < r.done and b > r.due for a, b in stalls)),
        }
