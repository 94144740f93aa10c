"""The traffic generator: the open loop's clock and the seed's draws."""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from harness import traffic


def test_poisson_gaps_same_set_for_every_seed():
    a = traffic.poisson_gaps(50.0, 20.0, seed=1)
    b = traffic.poisson_gaps(50.0, 20.0, seed=2**40 + 7)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(np.sort(a), np.sort(b))
    assert np.mean(a) == pytest.approx(1 / 50.0, rel=0.02)
    due = traffic.poisson_offsets(50.0, 20.0, seed=1)
    assert due[0] == 0.0 and due[-1] < 20.0 and len(due) == 1000
    assert len(traffic.poisson_offsets(50.0, 20.0, seed=2**40 + 7)) == 1000
    assert np.sum(a) == pytest.approx(20.0)


def test_query_pool_is_drawn_from_the_seed():
    a = traffic.query_pool(10**9, 4096, seed=3_000_000_019)
    assert len(np.unique(a)) == 4096 and a.max() < 10**9
    np.testing.assert_array_equal(a, traffic.query_pool(10**9, 4096, seed=3_000_000_019))
    assert not np.array_equal(a, traffic.query_pool(10**9, 4096, seed=5))
    assert sorted(traffic.query_pool(50, 4096, seed=1)) == list(range(50))


class SlowServer:
    """Answers every POST after ``delay`` seconds, one at a time."""

    def __init__(self, delay):
        lock = threading.Lock()

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                self.rfile.read(int(self.headers["Content-Length"]))
                with lock:
                    time.sleep(delay)
                body = b'{"approximate_count": 0, "results": []}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("localhost", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_open_loop_times_each_request_from_when_it_was_due():
    """A server slower than the arrivals builds a queue: in an open loop the
    later requests wait, and their latency counts the wait from the moment
    they were due, not from when they were sent."""
    server = SlowServer(0.1)
    try:
        load = traffic.run_open(server.port, [b"x=1"], rate=40.0,
                                start=time.monotonic() + 0.05, warm_s=0.0,
                                seconds=1.0, senders=1, seed=3)
    finally:
        server.close()
    recs = load.in_window()
    assert len(recs) > 20 and all(r.ok for r in recs)
    for r in recs:
        assert r.sent >= r.due - 1e-3
        assert r.latency == pytest.approx(r.done - r.due)
    # one sender, 0.1 s a request, 40 due a second: the last waits for most
    # of the ones before it
    assert recs[-1].latency > 0.5 * (len(recs) * 0.1 - 1.0)
    assert recs[-1].sent - recs[-1].due > 0.5
    assert load.extra["late_max_ms"] > 500


def test_closed_loop_sends_on_reply():
    server = SlowServer(0.02)
    try:
        load = traffic.run_closed(server.port, [b"x=1"], clients=2,
                                  start=time.monotonic(), warm_s=0.2, seconds=0.5)
    finally:
        server.close()
    recs = load.in_window()
    assert recs and all(load.t0 <= r.due < load.t1 for r in recs)
    # the server answers one at a time: two callers share its 50 a second
    assert 10 <= len(recs) <= 30
    assert all(r.ok and r.latency >= 0.015 for r in recs)


def test_failed_request_lies_over_any_limit():
    rec = traffic.Record(query=0, due=1.0, sent=1.0, done=1.5, status=503)
    assert rec.latency >= traffic.FAILED_PENALTY_S
    assert not traffic.Record(query=0, due=1.0).ok


def test_stall_probe_sees_the_generator_stall():
    """A stall of the generator's own process (here its interpreter lock,
    held for 0.1 s) shows, and a slow request over it is counted as such."""
    import sys

    probe = traffic.StallProbe()
    time.sleep(0.05)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1.0)  # no other thread runs while this one computes
    try:
        t_hold = time.monotonic()
        end = t_hold + 0.1
        while time.monotonic() < end:
            sum(range(2000))
    finally:
        sys.setswitchinterval(switch)
    time.sleep(0.05)
    probe.stop()
    recs = [traffic.Record(0, due=t_hold - 0.01, done=end + 0.01, status=200),  # slow, stalled
            traffic.Record(0, due=end + 0.02, done=end + 0.09, status=200),     # slow, clear
            traffic.Record(0, due=t_hold, done=t_hold + 0.01, status=200)]      # fast
    load = traffic.Load(recs, t_hold - 0.05, end + 0.05)
    got = probe.summary(load)
    assert got["slow_requests"] == 2
    assert got["slow_requests_in_harness_stall"] == 1
    assert got["harness_stall_max_ms"] >= 20


def test_run_reports_the_probe():
    server = SlowServer(0.01)
    try:
        load = traffic.run(server.port, {"loop": "closed", "clients": 1, "k": 1}, [b"x=1"],
                           time.monotonic(), 0.3, seed=1)
    finally:
        server.close()
    assert {"harness_stall_max_ms", "slow_requests",
            "slow_requests_in_harness_stall"} <= set(load.extra)


def client_clock_run(latencies_ms, deadline_ms=None, capture_t=None, wrong=()):
    """A run whose window holds one request per latency, due 1 s apart."""
    from types import SimpleNamespace

    from harness.cell import Run

    recs = [traffic.Record(0, due=float(i), done=i + x / 1e3, status=200)
            for i, x in enumerate(latencies_ms)]
    mix = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
    cell = SimpleNamespace(config={}, traffic=mix)
    return Run(cell, 1.0, 1.0, None, recs, {id(recs[i]) for i in wrong}, {}, {}, {},
               None, 0, capture_t=capture_t)


def test_deadline_share_counts_requests_within_the_mix_deadline():
    from harness.manifest import load_reader
    from pathlib import Path

    read = load_reader(Path(__file__).resolve().parents[2], "deadline_met_share").read
    assert read(client_clock_run([10, 20, 70, 71], deadline_ms=70.59)) == pytest.approx(75.0)
    # a wrong answer misses the deadline however fast it came
    assert read(client_clock_run([10, 20, 30, 40], 70.59, wrong=(0,))) == pytest.approx(75.0)
    assert read(client_clock_run([10, 20])) is None


def test_request_p50_leaves_out_what_the_capture_touched():
    from harness.manifest import load_reader
    from pathlib import Path

    read = load_reader(Path(__file__).resolve().parents[2], "request_p50_ms.deadline").read
    assert read(client_clock_run([10, 12, 14, 90, 95])) == pytest.approx(14)
    # the capture opened at 3 s: the two requests due after it are left out
    assert read(client_clock_run([10, 12, 14, 90, 95], capture_t=3.0)) == pytest.approx(12)
