"""Trace a running server on demand (the port's counterpart of the JAX
server's ``--jax_profiler_port``, ``gpusimilarity_tpu/cli/server.py``).

The JAX server starts ``jax.profiler.start_server`` and a TensorBoard client
pulls traces from it. Here :class:`ProfilerListener` is a small HTTP server
on a port of its own, apart from the search API::

    curl -s 'http://localhost:<port>/capture?duration_ms=2000'

runs one ``torch.profiler`` window of that many milliseconds (1 to 60,000;
default 2,000) over the whole process: the host ops of every thread (the
batcher's pool threads, where each database's pass runs inside a
``tpusim.search.<name>`` span, the HTTP handler threads, whose requests run
inside ``tpusim.request`` spans, the socket threads and the per-card shard
workers) and, on the card, every kernel CUPTI sees, the ctypes-launched
phase-1 kernels included. The trace is written with ``export_chrome_trace``
as ``<trace_dir>/tpusim-p<process>-<UTC stamp>.pt.trace.json`` (Perfetto or
``chrome://tracing`` open it) and the reply is JSON::

    {"trace": path, "duration_ms": D, "events": n, "threads": t,
     "spans": {"tpusim.search.<name>": count, ...}, "device_kernels": count,
     "bytes": file size, "window": [unix start, unix stop],
     "listener_tid": the capturing thread's id in the trace}

A bad ``duration_ms`` gets 400; a capture asked for while one runs gets 409
(the process holds one profiler); a profiler that fails to start or stop
gets 500 with its error. ``GET /status`` answers ``{"capturing": bool}``.

The served path's own spans (:mod:`.spans`: each request's parse, batch
wait and reply, each pass's stages) are kept, while a listener exists, in a
bounded ring. ``GET /spans?since=<seq>`` answers the records numbered above
``seq``::

    {"records": [{"seq", "name", "start_ns", "end_ns", "tid", "request",
                  "pass", "parent"}, ...],
     "last": the newest number, "capacity": the ring's bound,
     "now_ns": this process's monotonic clock, "clock": the last capture's
     mapping (null before one)}

The clock is ``time.monotonic_ns``; a capture enters a ``tpusim.clock``
marker under the profiler at each end of its window (again, up to
``CLOCK_TRIES`` times, while another thread delays a marker's exit), and
``clock`` holds the two ``[monotonic_ns, trace_us]`` pairs (their
difference shows the drift). An exported trace gets the records that lie
wholly inside its window as ``user_annotation`` events, on that mapping, on
the threads that ran them, with ``args`` ``{request, pass, parent, seq}``.
The reply reports them as ``merged_spans``.

Two things keep a capture's cost out of the rest of the time: the listener
runs one short window of its own at start-up, which writes nothing, so the
profiler's device tracing starts before the server serves; and the
``tpusim.request`` and ``tpusim.search.<name>`` spans are entered only
while a window is open (:func:`.spans.profiler_span`).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import Future
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import torch

from . import spans

log = logging.getLogger("tpusimilarity")

SPAN_PREFIX = "tpusim.search."
REQUEST_SPAN = "tpusim.request"
DEFAULT_DURATION_MS = 2000
MAX_DURATION_MS = 60_000
# how long close() waits for a capture in flight to stop and write its file
CLOSE_TIMEOUT_S = 300.0
# a clock marker is taken again, up to CLOCK_TRIES times, until its exit
# follows its monotonic read within CLOCK_EXIT_NS (the exit alone: ~10 us)
CLOCK_EXIT_NS = 50_000
CLOCK_TRIES = 20


class CaptureBusy(RuntimeError):
    """A capture is already running (or the listener is closing)."""


def _all_threads_config():
    """The experimental config that makes one ``torch.profiler`` window
    record the host ops of every thread of the process; without it the
    RecordFunction callbacks are the opening thread's only. Raises where the
    installed torch lacks the option: a window that silently saw one thread
    would be a wrong trace."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


def trace_counts(events) -> dict:
    """What the capture reply reports of a trace's ``traceEvents``: the
    complete events, the host threads of this process that recorded any,
    the search spans by name and the device kernels."""
    pid = os.getpid()
    complete = [e for e in events if e.get("ph") == "X"]
    return {
        "events": len(complete),
        "threads": len({e["tid"] for e in complete if e.get("pid") == pid}),
        "spans": dict(collections.Counter(
            e["name"] for e in complete
            if e.get("cat") == "user_annotation"
            and e["name"].startswith(SPAN_PREFIX))),
        "device_kernels": sum(1 for e in complete if e.get("cat") == "kernel"),
    }


class ProfilerListener:
    """An HTTP listener on ``hostname:port`` (0 picks a free port; see
    :attr:`port`) that captures ``torch.profiler`` traces of this process
    into ``trace_dir``, with CUDA activity when ``cuda`` is true, and serves
    the span ring. It primes the profiler before it listens
    (:attr:`primed_s`). Binding failures raise here; :meth:`close` stops
    it."""

    def __init__(self, hostname: str, port: int, trace_dir, cuda: bool,
                 process_index: int = 0):
        from torch.profiler import ProfilerActivity

        _all_threads_config()  # fail at start-up, not at the first capture
        self.trace_dir = Path(trace_dir)
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        self.activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        self.process_index = process_index
        self.clock: dict | None = None
        self._busy = threading.Lock()
        self._stop = threading.Event()
        self.capturing = threading.Event()
        self.primed_s = self._prime()
        self._httpd = ThreadingHTTPServer((hostname, port), _handler(self))
        self.port = self._httpd.server_address[1]
        spans.TRACE.attach()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tpusim-profiler", daemon=True)
        self._thread.start()

    def _prime(self) -> float:
        """One empty window, exported nowhere: the profiler's device
        tracing (CUPTI) starts in it, which stalls the process for seconds
        on a card, so that no capture of a serving process pays it."""
        t0 = time.monotonic()
        with torch.profiler.profile(activities=self.activities,
                                    experimental_config=_all_threads_config()):
            pass
        primed = time.monotonic() - t0
        log.info("profiler primed in %.2fs", primed)
        return primed

    @staticmethod
    def _clock_mark() -> tuple[int, int, int]:
        """Enter ``tpusim.clock`` spans under the profiler, each holding a
        monotonic read just before its end, until one ends within
        :data:`CLOCK_EXIT_NS` of its read; returns the read of the span
        that ended soonest after its own, that span's index and how many
        were entered. The end is the pair's trace time: a span's entry may
        take the profiler a millisecond, its exit is stamped at once,
        unless another thread takes the interpreter between the read and
        the exit (milliseconds under load), which the read after the exit
        shows."""
        best = None
        for tries in range(1, CLOCK_TRIES + 1):
            with torch.profiler.record_function(spans.CLOCK_SPAN):
                inside = time.monotonic_ns()
            late = time.monotonic_ns() - inside
            if best is None or late < best[0]:
                best = (late, inside, tries - 1)
            if late <= CLOCK_EXIT_NS:
                break
        return best[1], best[2], tries

    def capture(self, duration_ms: int) -> dict:
        """One window of ``duration_ms`` (cut short by :meth:`close`),
        exported and counted; raises :class:`CaptureBusy` if one runs."""
        if not self._busy.acquire(blocking=False):
            raise CaptureBusy("a capture is already running")
        try:
            if self._stop.is_set():
                raise CaptureBusy("the listener is closing")
            prof = torch.profiler.profile(
                activities=self.activities,
                experimental_config=_all_threads_config())
            with prof:
                opening = self._clock_mark()
                spans.TRACE.window_open = True
                self.capturing.set()
                start = time.time()
                self._stop.wait(duration_ms / 1e3)
                stop = time.time()
                spans.TRACE.window_open = False
                closing = self._clock_mark()
            self.capturing.clear()
            stamp = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%S.%fZ")
            path = self.trace_dir / f"tpusim-p{self.process_index}-{stamp}.pt.trace.json"
            prof.export_chrome_trace(str(path))
            events, merged = self._merge_spans(
                path, [opening[0], closing[0]], (opening[1:], closing[1:]))
            reply = {"trace": str(path), "duration_ms": duration_ms,
                     **trace_counts(events), "bytes": path.stat().st_size,
                     "window": [start, stop],
                     "listener_tid": threading.get_native_id(),
                     "merged_spans": merged, "clock": self.clock}
            log.info("profiler: %s (%d events, %d threads, spans %s, %d device "
                     "kernels, %d bytes)", path, reply["events"], reply["threads"],
                     reply["spans"], reply["device_kernels"], reply["bytes"])
            return reply
        finally:
            spans.TRACE.window_open = False
            self.capturing.clear()
            self._busy.release()

    def _merge_spans(self, path: Path, marks: list[int],
                     entered=((0, 1), (0, 1))) -> tuple[list, int]:
        """Map this process's clock onto the trace's by two ``tpusim.clock``
        markers of this thread, and add the ring's records inside the
        window to the trace as events; returns the trace's events and how
        many were added. ``marks`` are the two markers' monotonic reads;
        ``entered``, for each end of the window, the index of its marker
        among the markers entered there and their number
        (:meth:`_clock_mark`). The events go in as text after the
        list's opening, so the trace is not serialised again (seconds for
        a large one, the interpreter held all the while)."""
        text = path.read_text()
        doc = json.loads(text)
        tid = threading.get_native_id()
        found = sorted((e for e in doc["traceEvents"]
                        if e.get("name") == spans.CLOCK_SPAN and e.get("tid") == tid
                        and e.get("ph") == "X"), key=lambda e: e["ts"])
        (first, opened), (last, closed) = entered
        if len(found) != opened + closed:
            log.warning("profiler: %d clock markers in the trace, not %d; no "
                        "spans merged", len(found), opened + closed)
            return doc["traceEvents"], 0
        found = [found[first], found[opened + last]]
        pairs = [[m, float(e["ts"]) + float(e["dur"])] for m, e in zip(marks, found)]
        self.clock = {"trace": str(path), "marks": pairs}
        events = spans.chrome_events(spans.TRACE.records(), pairs, found[0]["pid"])
        if events:
            opening = '"traceEvents": ['
            at = text.find(opening)
            doc["traceEvents"].extend(events)
            if at < 0:
                path.write_text(json.dumps(doc))
            else:
                # the list holds the markers: each event goes first, a comma after
                at += len(opening)
                path.write_text(text[:at] + "".join(json.dumps(e) + "," for e in events)
                                + text[at:])
        return doc["traceEvents"], len(events)

    def spans_since(self, since: int) -> dict:
        """``GET /spans``'s answer: the ring's records numbered above
        ``since``."""
        return {"records": [dict(zip(spans.RECORD_FIELDS, r))
                            for r in spans.TRACE.records(since)],
                "last": spans.TRACE.last_seq(), "capacity": spans.RING_CAPACITY,
                "now_ns": time.monotonic_ns(), "clock": self.clock}

    def close(self) -> None:
        """Stop listening; a capture in flight ends at once and still
        writes its trace before this returns."""
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if self._busy.acquire(timeout=CLOSE_TIMEOUT_S):
            self._busy.release()
        spans.TRACE.detach()


def _handler(listener: ProfilerListener):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            # /status is polled by start_capture, /spans by an operator
            if not self.path.startswith(("/status", "/spans")):
                log.info("profiler %s - %s", self.address_string(), fmt % args)

        def _send_json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlsplit(self.path)
            query = urllib.parse.parse_qs(url.query)
            if url.path == "/status":
                self._send_json(200, {"capturing": listener.capturing.is_set()})
                return
            if url.path == "/spans":
                raw = query.get("since", ["0"])[0]
                try:
                    since = int(raw)
                except ValueError:
                    self._send_json(400, {"error": f"since must be an integer, "
                                          f"got {raw!r}"})
                    return
                self._send_json(200, listener.spans_since(since))
                return
            if url.path != "/capture":
                self._send_json(404, {"error": "not found"})
                return
            raw = query.get("duration_ms", [str(DEFAULT_DURATION_MS)])[0]
            try:
                duration_ms = int(raw)
            except ValueError:
                duration_ms = 0
            if not 1 <= duration_ms <= MAX_DURATION_MS:
                self._send_json(400, {"error": f"duration_ms must be an integer "
                                      f"in 1..{MAX_DURATION_MS}, got {raw!r}"})
                return
            try:
                self._send_json(200, listener.capture(duration_ms))
            except CaptureBusy as e:
                self._send_json(409, {"error": str(e)})
            except Exception as e:  # boundary: report, keep listening
                log.exception("profiler capture failed")
                self._send_json(500, {"error": f"capture failed: {e}"})

    return Handler


def start_capture(port: int, duration_ms: int = DEFAULT_DURATION_MS,
                  hostname: str = "localhost", timeout: float = 120.0) -> Future:
    """Ask the listener on ``port`` for a capture on a thread of its own and
    return once its window is open (or the request has ended); the future
    holds the reply's JSON, or the HTTP error."""
    done: Future = Future()
    url = f"http://{hostname}:{port}"

    def ask():
        try:
            with urllib.request.urlopen(
                    f"{url}/capture?duration_ms={duration_ms}",
                    timeout=duration_ms / 1e3 + timeout) as r:
                done.set_result(json.loads(r.read()))
        except Exception as e:  # handed to the caller through the future
            done.set_exception(e)

    threading.Thread(target=ask, name="tpusim-capture-client", daemon=True).start()
    deadline = time.monotonic() + timeout
    while not done.done():
        with urllib.request.urlopen(f"{url}/status", timeout=timeout) as r:
            if json.loads(r.read())["capturing"]:
                break
        if time.monotonic() > deadline:
            raise TimeoutError(f"no capture window opened on port {port}")
        time.sleep(0.02)
    return done
