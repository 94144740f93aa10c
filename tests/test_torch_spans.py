"""PyTorch port: the served path's spans and counters (``serve/spans.py``),
on the CPU.

Pinned here:

* the ``/stats`` identities: the wait's window and pool parts add up to
  ``queue_wait_seconds``, the pass stages (``other`` included) to
  ``total_search_seconds``, host and copy-back wait to the same, and parse
  plus reply to ``front_end_seconds``; every POST and socket request counts
  once, warm-up and direct engine calls not at all;
* the links: each request records the pass that held its query, and a
  request queued behind another caller's pass counts that time as its wait
  (its pool part), not as its pass;
* the idle pass: with no pass in flight after a pass of one, a drain
  closes at once, with what is already queued, and its passes count in
  ``idle_passes``; requests that arrive while a pass is in flight still
  share one pass after the window, and so do the callers of a closed loop,
  who come back together from a pass of several; a failed pass leaves
  nothing in flight;
* ``GET /spans``: its shape, ``since``, the ring's bound;
* the shared clock: in a capture, each merged span lies inside its
  ``tpusim.request`` or ``tpusim.search.<name>`` event, within 200 us at
  either end, and a request's parse-to-reply time nearly fills that event;
  the capture still holds one ``tpusim.request`` per POST and one
  ``tpusim.search.lib`` per pass; a clock marker whose exit another thread
  delays is entered again, and the mapping runs through the chosen ones;
* the off path: with no listener no ``record_function`` is entered and no
  record kept;
* the listener primes the profiler at start and writes no file doing so;
* a server's start-up steps come in order, ``ready`` no later than its
  ready line.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import random_fingerprint_data
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.serve import profiler, spans
from gpusimilarity_tpu_torch.serve.batching import BatchingSearcher
from gpusimilarity_tpu_torch.serve.server import SimilarityServer
from gpusimilarity_tpu_torch.serve.socket_server import SocketProtocolServer
from gpusimilarity_tpu_torch.utils.convert import fingerprint_data_from_jax
from gpusimilarity_tpu_torch.utils.fsim import write_fsim
from gpusimilarity_tpu_torch.utils.qtstream import QtStreamWriter

REPO = Path(__file__).resolve().parents[1]
N_ROWS = 2000
CLIENTS, PER_CLIENT = 4, 6
PASS_STAGES = (spans.PREPARE, spans.LAUNCH, spans.PASS_WAIT, spans.SHARD_MERGE,
               spans.ASSEMBLE, spans.STRINGS, spans.MERGE, spans.OTHER)
# a merged span and its profiler event: the two clocks agree this closely
CLOCK_US = 200.0


@pytest.fixture(scope="module")
def data():
    return fingerprint_data_from_jax(
        random_fingerprint_data(np.random.default_rng(17), count=N_ROWS))


@pytest.fixture
def served(data):
    """An in-process server over a fresh CPU registry."""
    reg = DatabaseRegistry(device="cpu")
    reg.add("lib", data)
    server = SimilarityServer(reg, port=0, window_ms=1.0)
    server.start_background()
    yield server
    server.close()


@pytest.fixture
def no_listener():
    assert spans.TRACE.ring is None, "a listener of another test is still open"


def _search(port, row_hex):
    body = urllib.parse.urlencode({
        "fp_hex": row_hex, "return_count": 5, "dbnames": "lib"}).encode()
    with urllib.request.urlopen(
            f"http://localhost:{port}/similarity_search_json", data=body,
            timeout=60) as r:
        return json.loads(r.read())


def _rows(data, n):
    return [data.fingerprints[i].tobytes().hex() for i in range(0, 7 * n, 7)]


def _clients(port, rows):
    """Every row searched once, by ``CLIENTS`` threads at once."""
    with ThreadPoolExecutor(CLIENTS) as pool:
        return list(pool.map(lambda q: _search(port, q), rows))


def _get(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


# ------------------------------------------------------------- the counters


def test_stats_identities(served, data, no_listener):
    rows = _rows(data, CLIENTS * PER_CLIENT)
    _clients(served.port, rows)
    stats = _get(served.port, "/stats")
    stages = stats["stages"]
    assert stats["requests"] == stats["searches"] == len(rows)
    assert 0 < stats["batches"] <= len(rows)
    assert stages["window_part"] + stages["pool_part"] == pytest.approx(
        stats["queue_wait_seconds"], abs=2e-6)
    assert stages[spans.WAIT] == stats["queue_wait_seconds"]
    assert sum(stages[s] for s in PASS_STAGES) == pytest.approx(
        stats["total_search_seconds"], rel=0.01)
    assert stats["pass_host_seconds"] + stats["pass_wait_seconds"] == pytest.approx(
        stats["total_search_seconds"], abs=2e-6)
    assert stages[spans.PASS_WAIT] == stats["pass_wait_seconds"]
    assert stages[spans.PARSE] + stages[spans.REPLY] == pytest.approx(
        stats["front_end_seconds"], abs=2e-6)
    # every stage of the served path ran (a 1 ms window closes each drain
    # that found a pass in flight)
    for name in spans.SPANS:
        assert stages[name] > 0, name
    assert 0 <= stats["idle_passes"] <= stats["batches"]
    assert stages[spans.WINDOW] >= 0.001 * (stats["batches"] - stats["idle_passes"]) * 0.5


def test_socket_requests_count_as_http_ones(data, tmp_path, no_listener):
    reg = DatabaseRegistry(device="cpu")
    reg.add("lib", data)
    searcher = BatchingSearcher(reg, window_ms=1.0)
    server = SocketProtocolServer(searcher, "spans.sock", str(tmp_path))
    server.start_background()
    try:
        w = QtStreamWriter()
        w.write_int32(1)
        w.write_string(b"lib")
        w.write_string(b"")
        w.write_int32(7)
        w.write_int32(5)
        w.write_double(0.0)
        w.write_bytearray(data.fingerprints[3].tobytes())
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(server.path)
            for _ in range(3):
                c.sendall(w.getvalue())
                assert c.recv(1 << 16)
            deadline = time.monotonic() + 10
            while reg.stats()["stages"][spans.REPLY] == 0:
                assert time.monotonic() < deadline
                time.sleep(0.01)
    finally:
        server.close()
        searcher.close()
    stats = reg.stats()
    assert stats["requests"] == 3 and stats["front_end_seconds"] > 0
    assert stats["stages"][spans.PARSE] > 0


def test_warm_up_and_direct_engine_calls_are_not_counted(data):
    reg = DatabaseRegistry(device="cpu")
    reg.add("lib", data)
    reg.warmup(ks=(5,), max_batch=2)
    reg.get("lib").search(data.fingerprints[0].view(np.uint32), k=5)
    stats = reg.stats()
    assert stats["requests"] == stats["batches"] == 0
    assert stats["queue_wait_seconds"] == stats["front_end_seconds"] == 0
    assert stats["pass_wait_seconds"] == stats["pass_host_seconds"] == 0
    assert not any(stats["stages"].values())


def test_counters_and_ring_lose_nothing_under_contention(monkeypatch):
    """More threads than cores add into one Counters and one ring while a
    reader sums, with the interpreter switching threads every 10 us: every
    add is counted, ended threads' sums included, and the ring's order is
    its numbers'."""
    monkeypatch.setattr(spans, "RING_CAPACITY", 1 << 20)
    counters, trace = spans.Counters(), spans._Trace()
    trace.attach()
    n_threads, adds = 2 * (os.cpu_count() or 2) + 2, 2000
    stop = threading.Event()

    def adder():
        for i in range(adds):
            counters.add(spans.PARSE, 1)
            trace.append(spans.PARSE, i, i, 0)

    def reader():
        while not stop.is_set():
            assert counters.totals()[spans.PARSE] <= n_threads * adds

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        watcher = threading.Thread(target=reader)
        watcher.start()
        workers = [threading.Thread(target=adder) for _ in range(n_threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        stop.set()
        watcher.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in workers + [watcher])
    assert counters.totals()[spans.PARSE] == n_threads * adds
    seqs = [r[0] for r in trace.records()]
    assert seqs == list(range(1, n_threads * adds + 1))


# ----------------------------------------------------------------- the links


class _Recording(DatabaseRegistry):
    """A registry that notes each pass's id and queries, and holds the
    pass of a query whose first word is ``hold`` for ``HOLD_S``."""

    HOLD_S = 0.5

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.passes: dict[int, list] = {}
        self.hold: int | None = None

    def _execute_batch(self, dbnames, key_oks, queries, *a):
        pass_span = spans.current_pass()
        self.passes[pass_span.id] = [q.tobytes() for q in queries]
        if self.hold is not None and int(queries[0][0]) == self.hold:
            time.sleep(self.HOLD_S)
        return super()._execute_batch(dbnames, key_oks, queries, *a)


def test_each_request_records_the_pass_that_held_its_query(data):
    reg = _Recording(device="cpu")
    reg.add("lib", data)
    searcher = BatchingSearcher(reg, window_ms=5.0)
    queries = [data.fingerprints[i].view(np.uint32) for i in range(0, 240, 10)]
    requests = [spans.Request() for _ in queries]
    try:
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda i: searcher.search(["lib"], [""], queries[i], k=5,
                                                    request=requests[i]),
                          range(len(queries))))
    finally:
        searcher.close()
    assert set(reg.passes) == {r.pass_id for r in requests}
    assert any(len(held) > 1 for held in reg.passes.values())
    for q, r in zip(queries, requests):
        assert q.tobytes() in reg.passes[r.pass_id]
        assert r.start <= r.enqueued <= r.drained <= r.pass_end


def test_a_wait_behind_another_callers_pass_is_queue_wait(data):
    """With one pool thread, a request that arrives during another
    caller's held pass waits for it in the pool, and its own pass is
    short."""
    reg = _Recording(device="cpu")
    reg.add("lib", data)
    searcher = BatchingSearcher(reg, window_ms=1.0)
    searcher._pool.shutdown()
    searcher._pool = ThreadPoolExecutor(1)
    first, second = data.fingerprints[1].view(np.uint32), data.fingerprints[2].view(np.uint32)
    reg.hold = int(first[0])
    assert int(second[0]) != reg.hold
    held, behind = spans.Request(), spans.Request()
    try:
        t = threading.Thread(target=searcher.search, args=(["lib"], [""], first),
                             kwargs={"k": 5, "request": held})
        t.start()
        time.sleep(0.15)  # the first pass holds the pool's thread
        searcher.search(["lib"], [""], second, k=5, request=behind)
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        searcher.close()
    stats = reg.stats()
    assert held.pass_id != behind.pass_id
    pool_wait = stats["stages"]["pool_part"]
    assert pool_wait >= _Recording.HOLD_S - 0.15 - 0.05
    assert stats["stages"]["window_part"] < 0.1
    # the second pass is short: the held time is the first pass's alone
    assert stats["total_search_seconds"] < _Recording.HOLD_S + pool_wait


# ------------------------------------------------------------ the idle pass


def _query(data, i):
    return data.fingerprints[i].view(np.uint32)


def _in_threads(searcher, queries, requests):
    """Each query searched on a thread of its own; returns the threads."""
    threads = [threading.Thread(target=searcher.search, args=(["lib"], [""], q),
                                kwargs={"k": 5, "request": r})
               for q, r in zip(queries, requests)]
    for t in threads:
        t.start()
    return threads


def _joined(threads):
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_a_lone_caller_on_an_idle_searcher_does_not_wait_out_the_window(data):
    reg = _Recording(device="cpu")
    reg.add("lib", data)
    searcher = BatchingSearcher(reg, window_ms=200.0)
    try:
        searcher.search(["lib"], [""], _query(data, 4), k=5)
    finally:
        searcher.close()
    stats = reg.stats()
    assert stats["stages"]["window_part"] < 0.05
    assert stats["idle_passes"] == stats["batches"] == stats["requests"] == 1


def test_arrivals_during_a_pass_in_flight_share_one_later_pass(data):
    reg = _Recording(device="cpu")
    reg.add("lib", data)
    reg.HOLD_S = 1.0
    searcher = BatchingSearcher(reg, window_ms=400.0)
    first = _query(data, 1)
    reg.hold = int(first[0])
    followers = [_query(data, i) for i in (2, 3, 5)]
    assert all(int(q[0]) != reg.hold for q in followers)
    held, behind = spans.Request(), [spans.Request() for _ in followers]
    try:
        threads = _in_threads(searcher, [first], [held])
        deadline = time.monotonic() + 10
        while not reg.passes:  # the held pass has started
            assert time.monotonic() < deadline
            time.sleep(0.005)
        threads += _in_threads(searcher, followers, behind)
        _joined(threads)
    finally:
        searcher.close()
    stats = reg.stats()
    assert len({r.pass_id for r in behind}) == 1
    assert held.pass_id != behind[0].pass_id
    assert sorted(reg.passes[behind[0].pass_id]) == sorted(q.tobytes() for q in followers)
    assert stats["batches"] == 2 and stats["idle_passes"] == 1


def test_an_idle_drain_takes_what_is_already_queued(data):
    """The batcher wakes to the first request and, before it can see that
    nothing is in flight, the others are queued: one pass holds all."""
    reg = _Recording(device="cpu")
    reg.add("lib", data)
    searcher = BatchingSearcher(reg, window_ms=200.0)
    queries = [_query(data, i) for i in (6, 7, 8, 9)]
    requests = [spans.Request() for _ in queries]
    try:
        with searcher._in_flight_lock:  # the drain stops before it decides
            threads = _in_threads(searcher, queries[:1], requests[:1])
            deadline = time.monotonic() + 10
            while searcher._queue.qsize():  # the batcher took the first
                assert time.monotonic() < deadline
                time.sleep(0.005)
            threads += _in_threads(searcher, queries[1:], requests[1:])
            while searcher._queue.qsize() < len(queries) - 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            released = spans.now()
        _joined(threads)
    finally:
        searcher.close()
    stats = reg.stats()
    assert len({r.pass_id for r in requests}) == 1
    assert stats["idle_passes"] == stats["batches"] == 1
    assert len(reg.passes[requests[0].pass_id]) == len(queries)
    assert max(r.drained for r in requests) - released < 0.05e9


def test_a_failed_pass_leaves_nothing_in_flight(data):
    reg = _Recording(device="cpu")
    reg.add("lib", data)
    searcher = BatchingSearcher(reg, window_ms=200.0)
    try:
        with pytest.raises(KeyError):
            searcher.search(["nope"], [""], _query(data, 4), k=5)
        assert searcher._in_flight == 0
        searcher.search(["lib"], [""], _query(data, 5), k=5)
    finally:
        searcher.close()
    stats = reg.stats()
    assert searcher._in_flight == 0
    # a failed pass is not counted: neither in ``batches`` nor as idle
    assert stats["idle_passes"] == stats["batches"] == stats["requests"] == 1
    assert stats["stages"]["window_part"] < 0.05


def test_a_closed_loop_of_callers_keeps_one_pass_a_round(data):
    """Callers that each send again soon after their answer: the first to
    come back from a pass of several must not start a pass alone, which
    would put a second pass into every round."""
    reg = _Recording(device="cpu")
    reg.add("lib", data)
    searcher = BatchingSearcher(reg, window_ms=250.0)
    callers, rounds = 6, 5

    def caller(c):
        rng = np.random.default_rng(c)
        for r in range(rounds):
            searcher.search(["lib"], [""], _query(data, 10 * c + r), k=5)
            time.sleep(rng.uniform(0, 0.02))  # the reply and the client's turn

    try:
        threads = [threading.Thread(target=caller, args=(c,)) for c in range(callers)]
        for t in threads:
            t.start()
        _joined(threads)
    finally:
        searcher.close()
    stats = reg.stats()
    assert stats["requests"] == callers * rounds
    # at most the first round splits: its first request finds the searcher
    # idle after no pass at all
    assert stats["batches"] <= rounds + 1
    assert stats["idle_passes"] <= 1


# ------------------------------------------------------------- GET /spans


def test_the_ring_keeps_its_bound_and_answers_since(monkeypatch):
    monkeypatch.setattr(spans, "RING_CAPACITY", 8)
    trace = spans._Trace()
    trace.append("x", 0, 1, 1)  # no listener: nothing kept
    assert trace.records() == [] and trace.last_seq() == 0
    trace.attach()
    for i in range(20):
        trace.append(spans.PARSE, i, i + 1, 5, request=i, pass_id=100 + i, parent=i)
    assert [r[0] for r in trace.records()] == list(range(13, 21))
    assert [r[0] for r in trace.records(since=18)] == [19, 20]
    assert trace.records(since=20) == []
    trace.detach()
    assert trace.ring is None


def test_get_spans(served, data, tmp_path):
    listener = profiler.ProfilerListener("localhost", 0, tmp_path, cuda=False)
    try:
        _clients(served.port, _rows(data, 8))
        got = _get(listener.port, "/spans")
        assert set(got) == {"records", "last", "capacity", "now_ns", "clock"}
        assert got["capacity"] == spans.RING_CAPACITY and got["clock"] is None
        records = got["records"]
        assert records and got["last"] == records[-1]["seq"]
        for r in records:
            assert set(r) == set(spans.RECORD_FIELDS)
            assert r["name"] in spans.SPANS + spans.CARD_SPANS
            assert r["start_ns"] <= r["end_ns"] <= got["now_ns"]
        by_name = {}
        for r in records:
            by_name.setdefault(r["name"], []).append(r)
        assert len(by_name[spans.PARSE]) == len(by_name[spans.REPLY]) == 8
        for r in by_name[spans.REPLY]:
            assert r["parent"] == r["request"] and r["pass"] is not None
        for r in by_name[spans.PREPARE]:
            assert r["request"] is None and r["parent"] == r["pass"]
        later = _get(listener.port, f"/spans?since={records[3]['seq']}")["records"]
        assert later == records[4:]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(listener.port, "/spans?since=x")
        assert e.value.code == 400
    finally:
        listener.close()
    assert spans.TRACE.ring is None


# --------------------------------------------------------- the shared clock


def _inside(span, event, slack_us=CLOCK_US):
    return (event["ts"] - slack_us <= span["ts"]
            and span["ts"] + span["dur"] <= event["ts"] + event["dur"] + slack_us)


def test_a_capture_holds_the_spans_on_its_clock(served, data, tmp_path):
    listener = profiler.ProfilerListener("localhost", 0, tmp_path, cuda=False)
    rows = _rows(data, CLIENTS * PER_CLIENT)
    batches0 = served.service.registry.stats()["batches"]
    try:
        capture = profiler.start_capture(listener.port, profiler.MAX_DURATION_MS)
        _clients(served.port, rows)
    finally:
        listener.close()
    reply = capture.result(timeout=60)
    batches = served.service.registry.stats()["batches"] - batches0
    assert len(reply["clock"]["marks"]) == 2
    with open(reply["trace"]) as f:
        events = json.load(f)["traceEvents"]
    requests = [e for e in events if e.get("name") == profiler.REQUEST_SPAN]
    searches = [e for e in events if e.get("name") == "tpusim.search.lib"]
    merged = [e for e in events if "seq" in (e.get("args") or {})]
    # one of each profiler span per POST and per pass, as before; every
    # merged event is a span of the served path
    assert len(requests) == len(rows) and len(searches) == batches
    assert all(e["cat"] == "user_annotation" for e in requests + searches)
    assert reply["merged_spans"] == len(merged) > 0
    assert {e["name"] for e in merged} <= set(spans.SPANS + spans.CARD_SPANS)
    assert {spans.PARSE, spans.WAIT, spans.REPLY, spans.PREPARE,
            spans.ASSEMBLE} <= {e["name"] for e in merged}

    by_tid: dict = {}
    for e in requests + searches:
        by_tid.setdefault((e["tid"], e["name"]), []).append(e)
    own_request: dict = {}
    for span in merged:
        if span["args"]["request"] is not None:
            [event] = [e for e in by_tid.get((span["tid"], profiler.REQUEST_SPAN), [])
                       if _inside(span, e)]
            own_request.setdefault(span["args"]["request"], {})[span["name"]] = span
            own_request[span["args"]["request"]]["event"] = event
        elif span["name"] in (spans.PREPARE, spans.LAUNCH, spans.PASS_WAIT,
                              spans.SHARD_MERGE, spans.ASSEMBLE, spans.STRINGS,
                              *spans.CARD_SPANS):
            # one card: its worker is the pass's own thread
            assert any(_inside(span, e)
                       for e in by_tid.get((span["tid"], "tpusim.search.lib"), []))
    # a request's parse-to-reply lies inside its profiler event (the two
    # clocks agree), the merge of its pass too (on another thread); its
    # ends lie near the event's, but a thread the interpreter switches away
    # from between the two stamps can move one by some milliseconds
    merges = {e["args"]["pass"]: e for e in merged if e["name"] == spans.MERGE}
    offsets = []
    for parts in own_request.values():
        if spans.PARSE in parts and spans.REPLY in parts:
            event, reply = parts["event"], parts[spans.REPLY]
            offsets.append(parts[spans.PARSE]["ts"] - event["ts"])
            offsets.append(event["ts"] + event["dur"] - reply["ts"] - reply["dur"])
            merge = merges.get(reply["args"]["pass"])
            if merge is not None:
                assert _inside(merge, event)
    assert len(offsets) >= len(rows)
    assert min(offsets) >= -CLOCK_US and np.median(offsets) <= 5 * CLOCK_US


@pytest.mark.parametrize("opening", ['"traceEvents": [\n  ', '"traceEvents":['])
def test_merged_records_land_on_the_line_through_the_markers(tmp_path, opening):
    """Kineto's layout takes the records as text; another layout is
    written whole. Records outside the markers' window stay out."""
    tid = threading.get_native_id()
    marker = {"ph": "X", "cat": "user_annotation", "name": spans.CLOCK_SPAN,
              "pid": 3, "tid": tid, "dur": 2.0}
    events = [dict(marker, ts=1000.0), dict(marker, ts=3000.0),
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 3, "tid": tid,
               "ts": 1500.0, "dur": 5.0}]
    path = tmp_path / "t.json"
    path.write_text("{" + opening + ", ".join(json.dumps(e) for e in events)
                    + '], "traceName": "t"}')
    listener = profiler.ProfilerListener("localhost", 0, tmp_path / "traces", cuda=False)
    try:
        spans.TRACE.append(spans.PARSE, 5_001_000, 5_002_000, 7, request=1,
                           pass_id=2, parent=1)
        spans.TRACE.append(spans.PARSE, 4_000_000, 5_002_000, 7)  # before the window
        got, n = listener._merge_spans(path, [5_001_000, 7_001_000])
    finally:
        listener.close()
    assert n == 1
    with open(path) as f:
        written = json.load(f)["traceEvents"]
    assert sorted(map(json.dumps, written)) == sorted(map(json.dumps, got))
    assert len(written) == 4
    [merged] = [e for e in written if e["name"] == spans.PARSE]
    # the markers' ends, 1002 and 3002 us, for 5.001 and 7.001 ms
    assert merged["ts"] == pytest.approx(1002.0) and merged["dur"] == pytest.approx(1.0)
    assert merged["tid"] == 7 and merged["pid"] == 3
    assert merged["args"] == {"request": 1, "pass": 2, "parent": 1,
                              "seq": merged["args"]["seq"]}
    assert listener.clock["marks"] == [[5_001_000, 1002.0], [7_001_000, 3002.0]]


def test_the_mapping_takes_the_marker_chosen_at_each_end(tmp_path):
    """Three markers entered at the window's opening (the second chosen)
    and two at its closing (the first chosen): the line runs through the
    chosen two; a count that does not match the trace merges nothing."""
    tid = threading.get_native_id()
    marker = {"ph": "X", "cat": "user_annotation", "name": spans.CLOCK_SPAN,
              "pid": 3, "tid": tid, "dur": 2.0}
    ends = (1000.0, 1100.0, 1200.0, 3000.0, 3100.0)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [dict(marker, ts=t) for t in ends]}))
    listener = profiler.ProfilerListener("localhost", 0, tmp_path / "traces", cuda=False)
    try:
        spans.TRACE.append(spans.PARSE, 5_001_000, 5_002_000, 7)
        _, n = listener._merge_spans(path, [5_001_000, 7_001_000], ((1, 3), (0, 2)))
        assert n == 1
        assert listener.clock["marks"] == [[5_001_000, 1102.0], [7_001_000, 3002.0]]
        _, n = listener._merge_spans(path, [5_001_000, 7_001_000], ((0, 1), (0, 1)))
    finally:
        listener.close()
    assert n == 0


def test_a_clock_marker_whose_exit_is_late_is_taken_again(monkeypatch):
    """Another thread that holds the interpreter between a marker's read
    and its exit moves the exit's stamp off the read: the marker is
    entered again, and the one that ended soonest after its read is used."""
    monkeypatch.setattr(profiler, "CLOCK_EXIT_NS", 5_000_000)
    monkeypatch.setattr(profiler, "CLOCK_TRIES", 4)
    lateness = iter([0.06, 0.04, 0.0, 0.0])
    entered = []

    class Marker:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            late = next(lateness)
            if late:
                time.sleep(late)

    monkeypatch.setattr(torch.profiler, "record_function", Marker)
    before = time.monotonic_ns()
    read, index, tries = profiler.ProfilerListener._clock_mark()
    assert (index, tries) == (2, 3)
    assert entered == [spans.CLOCK_SPAN] * 3
    assert before < read < time.monotonic_ns()
    # none soon enough: the soonest of CLOCK_TRIES
    lateness = iter([0.04, 0.02, 0.06, 0.06])
    assert profiler.ProfilerListener._clock_mark()[1:] == (1, 4)


# ------------------------------------------------------------ the off path


def test_no_listener_enters_no_profiler_span_and_keeps_nothing(
        served, data, monkeypatch, tmp_path, no_listener):
    entered = []
    record_function = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return record_function(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    appended = []
    monkeypatch.setattr(spans.TRACE, "append", lambda *a, **kw: appended.append(a))
    _clients(served.port, _rows(data, 8))
    assert served.service.registry.stats()["requests"] == 8
    assert entered == [] and spans.TRACE.ring is None
    # a listener with no capture open keeps records, still enters nothing
    listener = profiler.ProfilerListener("localhost", 0, tmp_path, cuda=False)
    try:
        _clients(served.port, _rows(data, 2))
    finally:
        listener.close()
    assert entered == [] and appended


def test_the_listener_primes_the_profiler_and_writes_no_file(tmp_path):
    traces = tmp_path / "traces"
    listener = profiler.ProfilerListener("localhost", 0, traces, cuda=False)
    try:
        assert listener.primed_s > 0
        assert list(traces.iterdir()) == []
    finally:
        listener.close()


# --------------------------------------------------------------- start-up


def test_start_up_steps_come_in_order(data, tmp_path):
    path = tmp_path / "lib.fsim"
    write_fsim(path, data)
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server", str(path),
         "--port", "0", "--cpu_only", "--warmup_ks", "5", "--warmup_batch", "1"],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True, env=env,
        cwd=REPO)
    try:
        for line in proc.stderr:
            if "tpusimilarity ready on" in line:
                seen_at = spans.process_age_s(proc.pid)
                port = int(line.split("ready on ")[1].split()[0].rsplit(":", 1)[1])
                break
        else:
            raise AssertionError("server exited before ready")
        threading.Thread(target=proc.stderr.read, daemon=True).start()
        stats = _get(port, "/stats")
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    steps = stats["startup"]
    assert set(steps) == {"imported", "native_loaded", "library_loaded",
                          "store_built", "warmed", "ready"}
    assert 0 < steps["imported"] <= min(steps.values())
    assert steps["library_loaded"] <= steps["store_built"] <= steps["warmed"]
    assert steps["native_loaded"] <= steps["warmed"] <= steps["ready"] <= seen_at
    # the warm-up's searches are not counted
    assert stats["requests"] == stats["batches"] == 0
