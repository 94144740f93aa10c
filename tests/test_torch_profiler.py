"""PyTorch port: the server's live profiling hook and its overlapped
start-up, on the CPU (the counterparts of the JAX server's
``--jax_profiler_port``, ``gpusimilarity_tpu/cli/server.py``, with its
``tpusim.search.<name>`` span in ``models/registry.py``, and of its
``precompile_ks`` overlap, pinned for JAX by ``tests/test_overlap_startup.py``).

Pinned here:

* a ``ProfilerListener`` capture taken while four client threads search an
  in-process ``SimilarityServer`` writes a Chrome trace holding one
  ``tpusim.search.<name>`` span per batched pass, none on the listener's
  thread, and every answer equals the same query's answer with no capture;
  ``close`` ends a capture in flight and its trace is still written; a
  capture otherwise lasts the duration asked for;
* a second capture during the first gets 409, a duration outside
  ``1..60000`` gets 400;
* ``cli.server`` binds no profiler port unless ``--profiler_port`` is given,
  process ``i`` of a job listens on ``--profiler_port + i``, and a SIGINT
  during a capture exits 0 with the trace written;
* ``start_up`` runs the kernel builds and the library load at once, raises
  a build's error, and builds no kernel with ``--cpu_only``;
* ``tools.loadtest --profile_ms`` adds a profiled pass and the capture.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from conftest import random_fingerprint_data
from gpusimilarity_tpu_torch.cli import server as cli_server
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.serve import profiler
from gpusimilarity_tpu_torch.serve.server import SimilarityServer
from gpusimilarity_tpu_torch.utils.convert import fingerprint_data_from_jax
from gpusimilarity_tpu_torch.utils.fsim import write_fsim

REPO = Path(__file__).resolve().parents[1]
N_ROWS = 2000
CLIENTS, PER_CLIENT = 4, 10


@pytest.fixture(scope="module")
def data():
    return fingerprint_data_from_jax(
        random_fingerprint_data(np.random.default_rng(12), count=N_ROWS))


@pytest.fixture(scope="module")
def served(data, tmp_path_factory):
    """An in-process server over a CPU registry, and a listener beside it."""
    reg = DatabaseRegistry(device="cpu")
    reg.add("lib", data)
    server = SimilarityServer(reg, port=0, window_ms=1.0)
    server.start_background()
    listener = profiler.ProfilerListener(
        "localhost", 0, tmp_path_factory.mktemp("traces"), cuda=False)
    yield server, listener
    listener.close()
    server.close()


def _search(port, row_hex):
    body = urllib.parse.urlencode({
        "fp_hex": row_hex, "return_count": 5, "dbnames": "lib"}).encode()
    with urllib.request.urlopen(
            f"http://localhost:{port}/similarity_search_json", data=body,
            timeout=60) as r:
        return json.loads(r.read())


def _http_code(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_capture_holds_a_span_per_batch_from_the_pool_threads(served, data,
                                                              tmp_path):
    """Four clients search inside one window, which ``close`` then ends
    (however slowly a loaded host runs them, all of them fall inside it),
    and the trace is still written and answered."""
    server, _ = served
    listener = profiler.ProfilerListener("localhost", 0, tmp_path, cuda=False)
    rows = [data.fingerprints[i].tobytes().hex()
            for i in range(0, 10 * CLIENTS * PER_CLIENT, 10)]
    want = [_search(server.port, q) for q in rows]  # no capture running
    batches0 = server.service.registry.stats()["batches"]
    got, ends = [None] * len(rows), []
    try:
        capture = profiler.start_capture(listener.port, profiler.MAX_DURATION_MS)
        opened = time.time()

        def client(c):
            for i in range(c, len(rows), CLIENTS):
                got[i] = _search(server.port, rows[i])
            ends.append(time.time())

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        listener.close()
    reply = capture.result(timeout=60)
    batches = server.service.registry.stats()["batches"] - batches0

    assert got == want
    lo, hi = reply["window"]
    assert lo <= opened and max(ends) <= hi < lo + 60
    with open(reply["trace"]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "tpusim.search.lib"]
    assert 0 < batches <= len(rows)
    assert len(spans) == batches == reply["spans"]["tpusim.search.lib"]
    assert all(e["tid"] != reply["listener_tid"] for e in spans)
    requests = [e for e in events if e.get("name") == profiler.REQUEST_SPAN]
    assert len(requests) == len(rows)
    assert reply["threads"] >= 2 and reply["device_kernels"] == 0
    assert reply["events"] > len(spans)
    assert Path(reply["trace"]).name.startswith("tpusim-p0-")
    assert reply["trace"].endswith(".pt.trace.json")
    assert reply["bytes"] == os.path.getsize(reply["trace"])


def test_a_capture_lasts_its_duration(served):
    _, listener = served
    reply = profiler.start_capture(listener.port, 800).result(timeout=60)
    lo, hi = reply["window"]
    assert reply["duration_ms"] == 800 and 0.8 <= hi - lo < 5
    assert not listener.capturing.is_set()


def test_a_second_capture_during_the_first_gets_409(served):
    _, listener = served
    capture = profiler.start_capture(listener.port, 3000)
    assert _http_code(
        f"http://localhost:{listener.port}/capture?duration_ms=10") == 409
    assert capture.result(timeout=60)["duration_ms"] == 3000
    assert _http_code(f"http://localhost:{listener.port}/status") == 200


@pytest.mark.parametrize("duration", ["0", "60001", "-5", "two"])
def test_a_duration_outside_its_range_gets_400(served, duration):
    _, listener = served
    assert _http_code(f"http://localhost:{listener.port}/capture?"
                      f"duration_ms={duration}") == 400
    assert not listener.capturing.is_set()


# ------------------------------------------------------------- cli.server


def test_the_profiler_port_is_off_by_default():
    args = cli_server.parse_args(["x.fsim"])
    assert args.profiler_port == 0
    assert Path(args.profile_dir).name == "tpusim-traces"
    assert cli_server.parse_args(
        ["x.fsim", "--profiler_port", "9000"]).profiler_port == 9000


def listening_ports(pid):
    """The TCP ports process ``pid`` listens on (``/proc``)."""
    inodes = set()
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            target = os.readlink(fd)
        except OSError:  # closed meanwhile
            continue
        if target.startswith("socket:["):
            inodes.add(target[8:-1])
    ports = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        if not os.path.exists(table):
            continue
        with open(table) as f:
            for row in list(f)[1:]:
                cols = row.split()
                if cols[3] == "0A" and cols[9] in inodes:  # LISTEN
                    ports.add(int(cols[1].rsplit(":", 1)[1], 16))
    return ports


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def small_fsim(tmp_path, data):
    path = tmp_path / "lib.fsim"
    write_fsim(path, data)
    return path


def _server(small_fsim, tmp_path, *flags):
    """A ``cli.server --cpu_only --no_warmup`` subprocess, its HTTP port
    once it is ready, and its stderr lines so far."""
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server",
         str(small_fsim), "--port", "0", "--cpu_only", "--no_warmup", *flags],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True, env=env,
        cwd=REPO)
    lines = []
    for line in proc.stderr:
        lines.append(line)
        if "tpusimilarity ready on" in line:
            port = int(line.split("ready on ")[1].split()[0].rsplit(":", 1)[1])
            threading.Thread(target=lambda: lines.extend(proc.stderr),
                             daemon=True).start()
            return proc, port, lines
    proc.wait(timeout=60)
    raise AssertionError("server exited before ready:\n" + "".join(lines[-20:]))


def _stop(proc):
    proc.send_signal(signal.SIGINT)
    try:
        return proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.parametrize("with_flag", [False, True])
def test_the_server_binds_a_profiler_port_only_when_asked(small_fsim, tmp_path,
                                                          with_flag):
    profiler_port = _free_port()
    flags = ("--profiler_port", str(profiler_port)) if with_flag else ()
    proc, port, _lines = _server(small_fsim, tmp_path, *flags)
    try:
        ports = listening_ports(proc.pid)
    finally:
        rc = _stop(proc)
    assert rc == 0
    assert ports == ({port, profiler_port} if with_flag else {port})


def test_sigint_during_a_capture_exits_0_and_writes_the_trace(small_fsim,
                                                              tmp_path):
    profiler_port = _free_port()
    traces = tmp_path / "traces"
    proc, _port, lines = _server(small_fsim, tmp_path, "--profiler_port",
                                 str(profiler_port), "--profile_dir", str(traces))
    try:
        profiler.start_capture(profiler_port, 60_000, timeout=60)
    finally:
        rc = _stop(proc)
    assert rc == 0, "".join(lines[-20:])
    [trace] = traces.iterdir()
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


class _StopAtOnce:
    """A ``SimilarityServer`` stand-in whose loop is interrupted at once."""

    def __init__(self, registry, **kw):
        self.port = 0

    def serve_forever(self):
        raise KeyboardInterrupt

    def close(self):
        pass


class _Listener:
    """A ``ProfilerListener`` stand-in that records how it was made."""

    made: list = []

    def __init__(self, hostname, port, trace_dir, cuda, process_index=0):
        self.port = port
        self.closed = False
        _Listener.made.append(self)
        self.args = (port, cuda, process_index)

    def close(self):
        self.closed = True


class _Controller:
    def __init__(self, registry, max_batch):
        pass

    def serve_worker(self):
        pass

    def shutdown(self):
        pass


@pytest.mark.parametrize("process_index", [0, 1])
def test_process_i_listens_on_the_profiler_port_plus_i(monkeypatch, data,
                                                       process_index):
    """Every process of a two-process job starts its own listener, process
    ``i`` on ``--profiler_port + i``, after the warm-up; the worker's closes
    when its loop ends, process 0's when its server does."""
    import gpusimilarity_tpu_torch.parallel.multihost as multihost
    import gpusimilarity_tpu_torch.serve.server as serve_mod

    reg = DatabaseRegistry(device="cpu")
    reg.add("lib", data)
    mesh = types.SimpleNamespace(process_index=process_index, n_processes=2,
                                 n_shards=2, distinct_devices=["cpu"])
    monkeypatch.setattr(cli_server, "start_up", lambda args: (mesh, reg))
    monkeypatch.setattr(serve_mod, "SimilarityServer", _StopAtOnce)
    monkeypatch.setattr(profiler, "ProfilerListener", _Listener)
    monkeypatch.setattr(multihost, "MultihostController", _Controller)
    monkeypatch.setattr(multihost, "finalize", lambda: None)
    monkeypatch.setattr(_Listener, "made", [])
    cli_server.main(["lib.fsim", "--cpu_only", "--no_warmup",
                     "--profiler_port", "7100"])
    [listener] = _Listener.made
    assert listener.args == (7100 + process_index, False, process_index)
    assert listener.closed


# ------------------------------------------------------ overlapped start-up


@pytest.fixture
def stubbed_start_up(monkeypatch):
    """``start_up``'s kernel builds and library load replaced by stubs that
    sleep 1 s each and record when they ran."""
    import gpusimilarity_tpu_torch.parallel.mesh as mesh_mod
    from gpusimilarity_tpu_torch.utils import kernels, native

    ran = {}

    def interval(name, fn):
        def run(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                ran[name] = (t0, time.monotonic(), threading.current_thread())
        return run

    def build(names):
        time.sleep(1.0)
        return {}

    def load(cls, paths, **kw):
        time.sleep(1.0)
        return "registry"

    monkeypatch.setattr(kernels, "load_all", interval("build", build))
    monkeypatch.setattr(DatabaseRegistry, "from_fsim_files",
                        classmethod(interval("load", load)))
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "origin", lambda: "stub")
    monkeypatch.setattr(mesh_mod, "make_mesh",
                        lambda devices=None: types.SimpleNamespace(n_processes=1))
    return ran


def test_start_up_builds_the_kernels_while_the_library_loads(stubbed_start_up):
    mesh, registry = cli_server.start_up(cli_server.parse_args(["x.fsim"]))
    (b0, b1, build_thread), (l0, l1, load_thread) = (
        stubbed_start_up["build"], stubbed_start_up["load"])
    assert registry == "registry" and mesh.n_processes == 1
    assert max(b0, l0) < min(b1, l1), "the build and the load did not overlap"
    assert build_thread is not load_thread
    assert load_thread is threading.main_thread()


def test_start_up_raises_a_kernel_build_error(stubbed_start_up, monkeypatch):
    import gpusimilarity_tpu_torch.serve.server as serve_mod
    from gpusimilarity_tpu_torch.utils import kernels

    def broken(names):
        raise RuntimeError("nvcc failed (1) on dense_phase1.cu")

    served = []
    monkeypatch.setattr(kernels, "load_all", broken)
    monkeypatch.setattr(serve_mod, "SimilarityServer",
                        lambda *a, **kw: served.append(a))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cli_server.start_up(cli_server.parse_args(["x.fsim"]))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cli_server.main(["x.fsim", "--no_warmup"])
    assert served == []


def test_cpu_only_start_up_builds_no_kernel(stubbed_start_up):
    cli_server.start_up(cli_server.parse_args(["x.fsim", "--cpu_only"]))
    assert "build" not in stubbed_start_up and "load" in stubbed_start_up


# ---------------------------------------------------------- tools.loadtest


def test_loadtest_profiled_pass_carries_the_capture(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.tools.loadtest",
         "--cpu_only", "--rows", "2000", "--clients", "4", "--profile_ms", "300"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    p = json.loads(proc.stdout.strip().splitlines()[-1])
    assert p["failures"] == 0 and p["requests"] == p["searches"]
    assert p["requests"] > 512 + 15 and p["profiled_samples"] > 0
    profile = p["profile"]
    assert profile["duration_ms"] == 300 and profile["spans"]["tpusim.search.load"] > 0
    assert Path(profile["trace"]).parent == tmp_path / "tpusim-traces"
