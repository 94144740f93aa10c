"""The server under test, as a subprocess: ``python -m
gpusimilarity_tpu_torch.cli.server`` with the cell's flags written out in
full, its log drained on a thread and read for the start-up stages, and its
``/stats`` and profiler endpoints read over HTTP. Stopped with SIGINT (then
killed) however the run ends."""

from __future__ import annotations

import collections
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

READY = "tpusimilarity ready on"
PREWARM = ("prewarmed ", "rescore prewarm skipped", "rescore prewarm not needed")
SERVER_MODULE = "gpusimilarity_tpu_torch.cli.server"
# log lines the start-up metrics read: the database's upload (the store
# built on the card), its warm-up, its load, and each kernel's build
LOG_TIMES = {
    "store_build_s": re.compile(r"uploaded \S+ to .*\((\d+(?:\.\d+)?)s"),
    "warmup_s": re.compile(r"warmed up \S+ \((\d+(?:\.\d+)?)s\)"),
    "load_s": re.compile(r"loaded \S+: .*\((\d+(?:\.\d+)?)s\)"),
}
KERNEL_BUILD = re.compile(r"kernel ready \(.*, built in (\d+(?:\.\d+)?)s\)")
# when each start-up stage's log line arrived, in seconds from the spawn
# (to the log's 50 ms polling): where a slow set-up spent its time; a
# stage keeps its first line, the kernels (one line each) their last
STAGES = {
    "loaded": "loaded ",
    "uploaded": "uploaded ",
    "kernels": "kernel ready (",
    "native": "native host runtime:",
    "warmed": "warmed up ",
    "ready": READY,
    "prewarm": PREWARM,
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def flag_args(flags: dict) -> list[str]:
    """``{"max_batch": 64, "popless": true}`` -> ``["--max_batch", "64",
    "--popless"]`` (a false flag is left out)."""
    out = []
    for name, value in flags.items():
        if value is True:
            out.append(f"--{name}")
        elif value is not False and value is not None:
            out += [f"--{name}", str(value)]
    return out


class ServerProcess:
    """One server on ``lib``; ``prefix`` replaces the interpreter and module
    (tests run a patched server through it)."""

    def __init__(self, root: Path, lib: Path, flags: dict, cache_env: dict,
                 log_path: Path, prefix: list[str] | None = None):
        self.port = free_port()
        self.lines: collections.deque = collections.deque(maxlen=60)
        self.times: dict[str, float] = {}
        self.stage_at_s: dict[str, float] = {}
        self.kernel_builds: list[float] = []
        self.ready = threading.Event()
        self.prewarmed = threading.Event()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(root), env.get("PYTHONPATH", "")) if p)
        env.update(cache_env)
        cmd = (prefix or [sys.executable, "-m", SERVER_MODULE]) + [
            str(lib), "--port", str(self.port), *flag_args(flags)]
        # the log goes to a file, never a pipe: a reader that falls behind
        # must not block the server's writes
        self._log_path = log_path
        self._stop = threading.Event()
        with open(log_path, "w") as log:
            self.t_spawn = time.monotonic()
            self.proc = subprocess.Popen(
                cmd, cwd=root, env=env, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=log, text=True)
        self._pump = threading.Thread(target=self._follow, daemon=True)
        self._pump.start()

    def _follow(self) -> None:
        """Read the log file as the server writes it."""
        with open(self._log_path) as f:
            pending = ""
            while True:
                chunk = f.read()
                if chunk:
                    pending += chunk
                    *lines, pending = pending.split("\n")
                    for line in lines:
                        self._line(line + "\n")
                elif self._stop.is_set():
                    return
                else:
                    time.sleep(0.05)

    def _line(self, line: str) -> None:
        self.lines.append(line)
        at = round(time.monotonic() - self.t_spawn, 3)
        self.stage_at_s.setdefault("first_line", at)
        for stage, marks in STAGES.items():
            if any(m in line for m in ((marks,) if isinstance(marks, str) else marks)):
                if stage == "kernels" or stage not in self.stage_at_s:
                    self.stage_at_s[stage] = at
        if READY in line:
            self.ready.set()
        if any(p in line for p in PREWARM):
            self.prewarmed.set()
        for name, rx in LOG_TIMES.items():
            m = rx.search(line)
            if m and name not in self.times:
                self.times[name] = float(m.group(1))
        m = KERNEL_BUILD.search(line)
        if m:
            self.kernel_builds.append(float(m.group(1)))

    def tail(self) -> str:
        return "".join(self.lines)

    def wait_ready(self, timeout_s: float) -> None:
        """Until the ready line and the page prewarm's line; raises with the
        log's tail if the server exits or is not ready in time."""
        deadline = time.monotonic() + timeout_s
        for event in (self.ready, self.prewarmed):
            while not event.wait(0.2):
                if self.proc.poll() is not None:
                    raise RuntimeError("server exited before ready:\n" + self.tail())
                if time.monotonic() > deadline:
                    raise RuntimeError("server not ready in time:\n" + self.tail())

    def get(self, path: str, port: int | None = None, timeout: float = 60):
        url = f"http://localhost:{port or self.port}{path}"
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._stop.set()
        self._pump.join(timeout=10)


class Capture:
    """One profiler capture of ``duration_ms`` on the server's profiler
    port, asked on a thread of its own; :meth:`result` waits for the reply
    (the trace's path and counts)."""

    def __init__(self, port: int, duration_ms: int, timeout_s: float = 300):
        self._reply: dict = {}
        self._error: list = []
        url = f"http://localhost:{port}"

        def ask():
            try:
                with urllib.request.urlopen(
                        f"{url}/capture?duration_ms={duration_ms}",
                        timeout=duration_ms / 1e3 + timeout_s) as r:
                    self._reply.update(json.loads(r.read()))
            except Exception as e:  # handed to the caller by result()
                self._error.append(e)

        self._thread = threading.Thread(target=ask, daemon=True)
        self._thread.start()
        deadline = time.monotonic() + 30
        while self._thread.is_alive():
            with urllib.request.urlopen(f"{url}/status", timeout=30) as r:
                if json.loads(r.read())["capturing"]:
                    break
            if time.monotonic() > deadline:
                raise TimeoutError("no capture window opened")
            time.sleep(0.02)

    def result(self, timeout_s: float = 600) -> dict:
        self._thread.join(timeout_s)
        if self._error:
            raise self._error[0]
        if not self._reply:
            raise TimeoutError("no capture reply")
        return self._reply
