"""One run of one cell: write the library, start the server, warm it with
the cell's own traffic, measure a window, check a sample of the window's
answers against the reference, and read the cell's metrics.

``run_cell`` returns the dict the last line prints: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), ``check`` last.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import traffic as traffic_mod
from .library import IdScheme, write_library
from .manifest import Cell, load_reader
from .server import Capture, ServerProcess, free_port
from .trace import Trace

READY_TIMEOUT_S = 1100.0
# the longest a traced run records: enough passes for every trace metric,
# and a trace of some tens of MB. The capture takes the window's last
# seconds and closes a lead before the window does, so the stretch before
# it, read from ``/stats``, is untouched by the profiler's cost (about 5 ms
# a request)
TRACE_CAPTURE_S = 5.0
TRACE_LEAD_S = 1.0
# a server's first capture starts the profiler's device tracing (CUPTI),
# which stalls the server for seconds (7.7 s on an H100) before its window
# opens; later ones open in tens of ms. A short one in set-up takes that
PRIME_CAPTURE_MS = 100
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gpusimilarity_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Run:
    """What a metric's reader reads: the cell, the window's requests (and
    which of the checked ones were wrong), ``/stats`` at the window's two
    ends (and, traced, at the capture's two ends), the server's start-up
    times, and with a trace its capture."""

    cell: Cell
    seconds: float
    setup_s: float
    load: traffic_mod.Load
    window: list
    wrong: set
    stats0: dict
    stats1: dict
    server_times: dict
    pool_words: np.ndarray
    seed: int
    trace: Trace | None = None
    stats_capture: tuple | None = None
    capture_t: float | None = None

    def good(self, rec) -> bool:
        return rec.ok and id(rec) not in self.wrong

    def latencies_ms(self) -> list:
        """Every window request's latency; a wrong answer, like a failed
        request, lies over any limit."""
        return [(r.latency + (traffic_mod.FAILED_PENALTY_S
                              if r.ok and not self.good(r) else 0.0)) * 1e3
                for r in self.window]

    def untraced_latencies_ms(self) -> list:
        """``latencies_ms`` of the requests due before a traced run's
        capture opened (every window request when untraced)."""
        lat = self.latencies_ms()
        if self.capture_t is None:
            return lat
        return [x for x, r in zip(lat, self.window) if r.due < self.capture_t]

    def untraced_delta(self, key: str) -> float:
        """A ``/stats`` counter's change over the window, or in a traced
        run over the stretch before the capture opened."""
        end = self.stats_capture[0] if self.stats_capture else self.stats1
        return float(end[key]) - float(self.stats0[key])

    def captured_delta(self, key: str) -> float:
        """A ``/stats`` counter's change over the capture (the whole window
        when untraced)."""
        start, end = self.stats_capture or (self.stats0, self.stats1)
        return float(end[key]) - float(start[key])


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that must not be there, compared
    whole (``gpusimilarity_tpu_torch`` is not ``gpusimilarity_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc and native builds go to its ``build/gpusim_torch``)."""
    build = root / "build"
    return {
        "TRITON_CACHE_DIR": str(build / "triton-cache"),
        "TORCH_EXTENSIONS_DIR": str(build / "torch-extensions"),
    }


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout if out.returncode == 0 else ""


def card_memory_used() -> int:
    """Bytes in use on the fullest card, as ``nvidia-smi`` reads them (no
    CUDA context is opened in this process)."""
    used = [int(float(x)) << 20 for x in _smi("memory.used").split()]
    return max(used) if used else 0


def card_state() -> str:
    """The card's SM clock (MHz), temperature (C) and power draw (W)."""
    return _smi("clocks.sm,temperature.gpu,power.draw").strip()


def card_power_limit_w() -> float | None:
    vals = _smi("power.limit").split()
    try:
        return float(vals[0])
    except (IndexError, ValueError):
        return None


def percentile(values: list, q: float) -> float:
    """Nearest rank: the smallest value with at least ``q`` of the values
    at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def query_bodies(config: dict, mix: dict, seed: int):
    """The pool of query rows, their words and one request body each."""
    from reference.rows import rows_np

    lib = config
    pool = traffic_mod.query_pool(lib["rows"], int(mix.get("query_pool", 4096)), seed)
    words = rows_np(pool, lib["bitcount"] // 32, seed)
    bodies = [traffic_mod.request_body(w.astype("<u4").tobytes().hex(), mix, lib["database"])
              for w in words]
    return pool, words, bodies


def server_flags(cell: Cell, profiler_port: int | None = None,
                 profile_dir: Path | None = None, cpu: bool = False) -> dict:
    flags = dict(cell.config.get("server_flags", {}))
    flags.update(cell.traffic.get("server_flags", {}))
    if profiler_port:
        flags.update(profiler_port=profiler_port, profile_dir=str(profile_dir))
    if cpu:
        flags["cpu_only"] = True
    return flags


def check_answers(cell: Cell, window: list, pool: np.ndarray, seed: int, device,
                  controls=()):
    """Draw the checked sample from the window's requests (from the seed),
    run the reference over the library and judge. Returns ``(numbers, the
    checked requests found wrong, {control: numbers})``."""
    from reference.compare import judge
    from reference.search import reference_answers

    lib = cell.config
    words = lib["bitcount"] // 32
    fold = int(cell.config["server_flags"].get("fold", 1))
    unanswered = sum(1 for r in window if not r.ok)
    rng = np.random.default_rng([seed, 4])
    n_check = min(int(cell.traffic.get("check_sample", 64)), len(window))
    sample = [window[i] for i in sorted(rng.choice(len(window), n_check, replace=False))]
    payloads = []
    for r in sample:
        try:
            p = json.loads(r.body) if r.ok else None
        except ValueError:
            p = None
        payloads.append(p if isinstance(p, dict) else None)
    rows = pool[[r.query for r in sample]]
    k = [int(cell.traffic["k"])] * n_check
    cut = [float(cell.traffic.get("cutoff", 0))] * n_check
    t0 = time.monotonic()
    ref, ctl = reference_answers(lib["rows"], words, fold, seed, rows, k, cut,
                                 device, controls)
    log(f"reference: {n_check} queries over {lib['rows']} rows in "
        f"{time.monotonic() - t0:.1f} s on {device}")
    scheme = IdScheme(lib["ids"])

    def decode(text):
        j = scheme.decode(text)
        return j if j is not None and j < lib["rows"] else None

    def numbers(answers):
        return judge(answers, ref, rows, words, seed, decode, scheme.text, unanswered)

    served, faulty = numbers(payloads)
    wrong = {id(r) for r, bad in zip(sample, faulty) if bad}
    controls_out = {}
    for name, answers in ctl.items():
        as_served = [{"approximate_count": a.count,
                      "results": [[scheme.text(int(i)), scheme.text(int(i)), float(s)]
                                  for i, s in zip(a.idx, a.scores)]}
                     for a in answers]
        controls_out[name] = numbers(as_served)[0]
    return served, wrong, controls_out


def sleep_until(t: float) -> None:
    wait = t - time.monotonic()
    if wait > 0:
        time.sleep(wait)


def capture_span(seconds: float) -> tuple[float, float]:
    """A traced run's capture: its length and how long before the window's
    end it opens (short windows, as in tests, keep half untraced)."""
    length = min(TRACE_CAPTURE_S, 0.4 * seconds)
    return length, length + min(TRACE_LEAD_S, 0.1 * seconds)


def read_metrics(root: Path, names: list, run: Run) -> dict:
    out = {}
    for m in names:
        value = load_reader(root, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(root: Path, cell: Cell, seed: int, seconds: float, trace: bool,
             device_info: dict, reference_device, controls=(), cpu: bool = False,
             server_prefix=None, sweep_rates=()) -> dict | None:
    """One run; returns the result (None for a sweep, which prints its own
    lines)."""
    tmp = Path(tempfile.mkdtemp(prefix="bench-run-"))
    server = None
    try:
        lib = write_library(tmp, root, cell.config, seed, log=log)
        pool, pool_words, bodies = query_bodies(cell.config, cell.traffic, seed)
        profiler_port = free_port() if trace else None
        server = ServerProcess(
            root, lib, server_flags(cell, profiler_port, tmp / "traces", cpu),
            cache_env(root), tmp / "server.log", prefix=server_prefix)
        server.wait_ready(READY_TIMEOUT_S)
        log(f"server ready in {time.monotonic() - server.t_spawn:.1f} s "
            f"({server.times}; kernel builds {server.kernel_builds})")
        if sweep_rates:
            sweep(server, cell, bodies, seconds, seed, sweep_rates)
            return None
        if trace:
            t = time.monotonic()
            Capture(profiler_port, PRIME_CAPTURE_MS).result()
            log(f"profiler primed in {time.monotonic() - t:.1f} s")
        memory = [] if cpu else [card_memory_used()]
        marks: dict = {}

        def on_window(t0, t1):
            marks["stats0"] = server.get("/stats")
            if trace:
                length, before_end = capture_span(seconds)
                sleep_until(t1 - before_end)
                opened = server.get("/stats")
                marks["capture_t"] = time.monotonic()
                marks["capture"] = Capture(profiler_port, int(length * 1000))
                sleep_until(time.monotonic() + length)
                marks["stats_capture"] = (opened, server.get("/stats"))
            sleep_until(t1)
            marks["stats1"] = server.get("/stats")
            if not cpu:
                memory.append(card_memory_used())
                marks["card"] = card_state()

        start = time.monotonic() + 0.2
        load = traffic_mod.run(server.port, cell.traffic, bodies, start, seconds,
                               seed, on_window)
        setup_s = load.t0 - server.t_spawn
        parsed = None
        if trace:
            reply = marks["capture"].result()
            log(f"capture: {reply['events']} events, {reply['threads']} threads, "
                f"spans {reply['spans']}, {reply['device_kernels']} device kernels")
            window_s = reply["window"][1] - reply["window"][0]
            parsed = Trace.load(reply["trace"], window_s)
            Path(reply["trace"]).unlink(missing_ok=True)
        server.stop()
        window = load.in_window()
        if not cpu:
            reference_device = reference_device or "cuda"
        numbers, wrong, ctl = check_answers(cell, window, pool, seed,
                                            reference_device, controls)
        run = Run(cell, seconds, setup_s, load, window, wrong, marks["stats0"],
                  marks["stats1"], dict(server.times), pool_words, seed, parsed,
                  marks.get("stats_capture"), marks.get("capture_t"))
        metrics = read_metrics(root, cell.per_layer if trace else cell.end_to_end, run)
        failed = sum(1 for r in window if not run.good(r))
        from reference.compare import LIMITS, passes

        dev = dict(device_info, memory_peak_bytes=max(memory) if memory else 0)
        if parsed is not None:
            dev.update(busy_s=parsed.busy_s(), window_s=parsed.window_s)
        out = {"correct": passes(numbers) and failed == 0,
               "attempted": len(window), "failed": failed,
               "metrics": metrics, "device": dev}
        if parsed is not None:
            out["breakdown"] = parsed.breakdown()
        extra = {"setup_first_build": bool(server.kernel_builds and
                                           max(server.kernel_builds) > 1.0),
                 "server_times": dict(server.times),
                 "stage_at_s": dict(server.stage_at_s), **load.extra,
                 "client_p50_ms": percentile(run.untraced_latencies_ms(), 0.5)
                 if window else None,
                 "card_at_window_end": marks.get("card", "")}
        if parsed is not None:
            extra.update(trace_requests=len(parsed.requests),
                         trace_requests_whole=len(parsed.whole_requests()),
                         trace_search_spans=len(parsed.searches),
                         trace_kernel_lead_us=parsed.lead_us,
                         capture_batches=run.captured_delta("batches"))
        if ctl:
            extra["controls"] = ctl
        out["run"] = extra
        out["check"] = {name: {"value": numbers[name], "limit": LIMITS[name]}
                        for name in LIMITS}
        for name, c in ctl.items():
            log(f"control {name}: " + ", ".join(
                f"{k} {v} limit {LIMITS[k]}" for k, v in c.items()))
        return out
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def sweep(server: ServerProcess, cell: Cell, bodies: list, seconds: float,
          seed: int, rates) -> None:
    """Open-loop windows at each rate in turn on one warm server: one JSON
    line each with the latency quantiles, the first and last quarter's
    median (a backlog that grows shows as the last above the first) and how
    late the generator ran."""
    for rate in rates:
        load = traffic_mod.run(server.port, dict(cell.traffic, warm_s=1.0), bodies,
                               time.monotonic() + 0.2, seconds, seed,
                               rate=float(rate))
        window = load.in_window()
        lat = [r.latency * 1e3 for r in window]
        q = max(1, len(window) // 4)
        print(json.dumps({
            "sweep_rate_qps": rate, "requests": len(window),
            "failed": sum(1 for r in window if not r.ok),
            "p50_ms": percentile(lat, 0.5), "p95_ms": percentile(lat, 0.95),
            "first_quarter_p50_ms": percentile(lat[:q], 0.5),
            "last_quarter_p50_ms": percentile(lat[-q:], 0.5),
            **load.extra}), flush=True)
