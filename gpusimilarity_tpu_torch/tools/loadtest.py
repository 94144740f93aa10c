"""Concurrent load against the port's HTTP server (twin of the repository's
``tools/loadtest.sh`` and ``tools/loadtest104.sh``)::

    python -m gpusimilarity_tpu_torch.tools.loadtest [--preset loadtest|loadtest104]
        [--rows N] [--clients C] [--dir PATH] [--port P] [--cpu_only]
        [--profile_ms D]

Starts ``python -m gpusimilarity_tpu_torch.cli.server`` on a library as a
subprocess, waits for its ``tpusimilarity ready on`` line, warms it with
1, 2, 4, ... concurrent requests, then sends two passes of 256 requests
(cold, then warm) from ``--clients`` threads. Every query is one of the
library's first 64 rows, and every answer must lead with that row's id at
score 1.0. With ``--profile_ms D`` the server also gets ``--profiler_port``,
and after the warm pass the clients keep sending while one ``D`` ms
capture runs (``serve/profiler.py``): a third pass, ``profiled``, counts the
requests that began and ended inside the window, and the line carries the
capture's reply (``profile``: the trace's path and counts). The server is
stopped however the run ends.

Presets, each the constants of one root script:

* ``loadtest`` (default): 1,000,000 rows at 5% bit density (numpy seed 5)
  written as a ``.fsim``, ``--max_batch 8 --batch_window_ms 5`` (the
  server's default warm-up), warm-up at 1-8 concurrent requests, 32
  clients.
* ``loadtest104``: a ``tools/fold_scale`` library of 104,000,000 rows at
  ``--and_slabs 4`` (Morgan-like 6.25% density; written under ``--dir``,
  default ``$TMPDIR/tpusim_load104``, and reused), ``--max_batch 64
  --batch_window_ms 5 --warmup_ks 128 --warmup_batch 32``, warm-up at 1-32,
  32 clients.

The server runs on the card (``--cpu_only``: the plain versions on the
host). Prints one JSON line: requests and failures, each pass's qps and
p50/p99 latency with its sample count, and ``/stats`` searches against
kernel launches. Exits 1 if any request failed or was not exact.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import contextlib
import json
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np

PRESETS = {
    "loadtest": {"rows": 1_000_000, "max_batch": 8, "warmup": (1, 2, 4, 8)},
    "loadtest104": {"rows": 104_000_000, "max_batch": 64,
                    "warmup": (1, 2, 4, 8, 16, 32),
                    "server_args": ("--warmup_ks", "128", "--warmup_batch", "32")},
}
PASS_REQUESTS = 256
READY_MARKER = "tpusimilarity ready on"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def server_process(lib, port: int, server_args=(), ready_timeout_s: float = 1800):
    """Run the port's ``cli.server`` on ``lib`` and yield ``(port, seconds
    to ready)`` once it prints its ready line; SIGINT (then kill) on exit.
    Its stderr is drained on a thread; the last lines are raised with any
    failure to start."""
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server", str(lib),
         "--port", str(port), *server_args],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
    )
    tail = collections.deque(maxlen=40)
    ready = threading.Event()

    def pump():
        for line in proc.stderr:
            tail.append(line)
            if READY_MARKER in line:
                ready.set()

    threading.Thread(target=pump, daemon=True).start()
    try:
        while not ready.wait(1.0):
            if proc.poll() is not None:
                raise RuntimeError("server exited before ready:\n" + "".join(tail))
            if time.monotonic() - t0 > ready_timeout_s:
                raise RuntimeError("server not ready in time:\n" + "".join(tail))
        yield port, time.monotonic() - t0
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def get_json(port: int, path: str, timeout: float = 60):
    with urllib.request.urlopen(f"http://localhost:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def post_search(port: int, fields: dict, timeout: float = 600) -> dict:
    """One ``/similarity_search_json`` request; a dropped connection is
    retried (the latency, counted by the caller, includes the retries)."""
    body = urllib.parse.urlencode(fields).encode()
    for attempt in range(4):
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://localhost:{port}/similarity_search_json", data=body),
                    timeout=timeout) as r:
                return json.loads(r.read())
        except (ConnectionResetError, ConnectionRefusedError):
            if attempt == 3:
                raise
            time.sleep(0.05 * (attempt + 1))
    raise AssertionError("unreachable")


def build_load_fsim(directory: Path, rows: int) -> tuple[Path, np.ndarray]:
    """The ``loadtest`` library: ``rows`` rows at 5% density (numpy seed 5,
    drawn in row slabs, the same stream as one draw), ids ``SYN%08d``,
    written as ``load.fsim``; returns the path and the first 64 rows."""
    from ..utils.fsim import FingerprintData, write_fsim

    rng = np.random.default_rng(5)
    packed = np.empty((rows, 128), np.uint8)
    for lo in range(0, rows, 1 << 16):
        hi = min(rows, lo + (1 << 16))
        packed[lo:hi] = np.packbits(rng.random((hi - lo, 1024)) < 0.05, axis=1,
                                    bitorder="little")
    path = directory / "load.fsim"
    write_fsim(path, FingerprintData(
        dbkey="", fingerprints=packed,
        smiles=[f"S{i}".encode() for i in range(rows)],
        ids=[f"SYN{i:08d}".encode() for i in range(rows)],
    ))
    return path, packed[:64].copy()


def build_load104(directory: Path, rows: int) -> tuple[Path, np.ndarray]:
    """The ``loadtest104`` library: ``tools/fold_scale``'s synthetic
    ``.tfsim`` at ``--and_slabs 4`` (reused if present) and its first 64
    rows."""
    from ..utils.tfsim import load_native
    from .fold_scale import generate_tfsim, library_path

    path = library_path(directory, rows, 4)
    if not path.exists():
        directory.mkdir(parents=True, exist_ok=True)
        generate_tfsim(path, rows, and_slabs=4)
    return path, np.asarray(load_native(path).fingerprints[:64]).copy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="loadtest", choices=tuple(PRESETS))
    ap.add_argument("--rows", type=int, default=None,
                    help="library rows (default: the preset's)")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--dir", default=None,
                    help="loadtest104's library directory (default "
                    "$TMPDIR/tpusim_load104)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--cpu_only", action="store_true",
                    help="serve with the plain versions on the host")
    ap.add_argument("--profile_ms", type=int, default=0,
                    help="after the warm pass, one server-side torch.profiler "
                    "capture of this many ms while the clients keep sending "
                    "(0: none)")
    args = ap.parse_args(argv)
    preset = PRESETS[args.preset]
    rows = args.rows or preset["rows"]

    with tempfile.TemporaryDirectory() as tmp:
        if args.preset == "loadtest":
            lib, qs = build_load_fsim(Path(tmp), rows)
            dbname, extra, digits = "load", {}, 8
        else:
            directory = Path(args.dir or Path(tempfile.gettempdir()) / "tpusim_load104")
            lib, qs = build_load104(directory, rows)
            dbname, extra, digits = lib.name[: -len(".tfsim")], {"dbkeys": "scale"}, 10
        print(f"library ready: {lib} ({rows:,} rows)", file=sys.stderr, flush=True)

        server_args = ["--max_batch", str(preset["max_batch"]), "--batch_window_ms", "5",
                       *preset.get("server_args", ())]
        if args.cpu_only:
            server_args.append("--cpu_only")
        if args.profile_ms:
            profiler_port = free_port()
            server_args += ["--profiler_port", str(profiler_port)]
        failures = []

        def query(i: int) -> float:
            t0 = time.monotonic()
            try:
                p = post_search(port, {
                    "fp_hex": qs[i % 64].tobytes().hex(), "return_count": 10,
                    "similarity_cutoff": 0, "dbnames": dbname, **extra,
                })
                top = p["results"][0]
                # the self row leads at 1.0 (rows of equal smiles would join
                # their ids, hence "in")
                if f"SYN{i % 64:0{digits}d}" not in top[0] or top[2] != 1.0:
                    failures.append(f"request {i}: top result {top}")
            except Exception as e:  # counted, reported, and the run fails
                failures.append(f"request {i}: {e!r}")
            return time.monotonic() - t0

        with server_process(lib, args.port or free_port(), server_args) as (port, ready_s):
            print(f"server ready in {ready_s:.1f}s", file=sys.stderr, flush=True)
            stats0 = get_json(port, "/stats")
            requests = 0
            for b in preset["warmup"]:
                with cf.ThreadPoolExecutor(b) as ex:
                    list(ex.map(query, range(b)))
                requests += b
            out = {}
            for label in ("cold", "warm"):
                t0 = time.monotonic()
                with cf.ThreadPoolExecutor(args.clients) as ex:
                    lat = sorted(ex.map(query, range(PASS_REQUESTS)))
                wall = time.monotonic() - t0
                requests += PASS_REQUESTS
                out.update({
                    f"{label}_qps": round(PASS_REQUESTS / wall, 1),
                    f"{label}_p50_ms": round(lat[PASS_REQUESTS // 2] * 1e3, 3),
                    f"{label}_p99_ms": round(lat[int(PASS_REQUESTS * 0.99)] * 1e3, 3),
                    f"{label}_samples": PASS_REQUESTS,
                })
                print(f"LOAD {label}: {PASS_REQUESTS} queries in {wall:.1f}s = "
                      f"{PASS_REQUESTS / wall:.1f} qps", file=sys.stderr, flush=True)
            if args.profile_ms:
                out.update(profiled_pass(query, profiler_port, args.profile_ms,
                                         args.clients))
                requests += out.pop("requests")
            stats = get_json(port, "/stats")
    for f in failures[:5]:
        print(f"FAILED {f}", file=sys.stderr)
    print(json.dumps({
        "metric": "serving_qps_warm",
        "value": out["warm_qps"],
        "unit": "qps",
        "preset": args.preset,
        "rows": rows,
        "clients": args.clients,
        "max_batch": preset["max_batch"],
        "requests": requests,
        "failures": len(failures),
        **out,
        "server_ready_s": round(ready_s, 1),
        "searches": stats["searches"] - stats0["searches"],
        "kernel_launches": {
            name: n - stats0["kernel_launches"][name]
            for name, n in stats["kernel_launches"].items()
        },
        "databases": stats["databases"],
        "card": card(args.cpu_only),
    }), flush=True)
    return 1 if failures else 0


def profiled_pass(query, profiler_port: int, duration_ms: int, clients: int) -> dict:
    """``clients`` threads send ``query`` from the moment a capture's window
    opens until its reply arrives: the reply, the requests sent, and the qps
    and latency of those that began and ended inside the window."""
    from ..serve.profiler import start_capture

    capture = start_capture(profiler_port, duration_ms)
    spans: list[tuple[float, float]] = []

    def client(c: int) -> None:
        i = c
        while not capture.done():
            t0 = time.time()
            lat = query(i)
            spans.append((t0, t0 + lat))
            i += clients

    with cf.ThreadPoolExecutor(clients) as ex:
        for f in [ex.submit(client, c) for c in range(clients)]:
            f.result()
    profile = capture.result()
    lo, hi = profile["window"]
    lat = sorted(b - a for a, b in spans if a >= lo and b <= hi)
    print(f"LOAD profiled: {len(lat)} queries inside the {duration_ms} ms window "
          f"({len(spans)} sent); trace {profile['trace']}", file=sys.stderr, flush=True)
    return {
        "requests": len(spans),
        "profiled_qps": round(len(lat) / (hi - lo), 1),
        "profiled_p50_ms": round(lat[len(lat) // 2] * 1e3, 3) if lat else None,
        "profiled_samples": len(lat),
        "profile": profile,
    }


def card(cpu_only: bool) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if cpu_only:
        return "cpu"
    from .probe_b1 import card_line

    return card_line()


if __name__ == "__main__":
    sys.exit(main())
