"""The readers of the server's span counters (``/stats``): the batching
wait, the front end, a pass's host time and copy-back wait, and the
runtime's start-up step, on canned ``/stats``."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from harness.cell import Run
from harness.manifest import load_reader

ROOT = Path(__file__).resolve().parents[2]


def stats(requests, batches, queue, front, host, wait, startup=None):
    out = {"searches": requests, "batches": batches, "total_search_seconds": host + wait,
           "requests": requests, "queue_wait_seconds": queue,
           "front_end_seconds": front, "pass_host_seconds": host,
           "pass_wait_seconds": wait}
    if startup is not None:
        out["startup"] = startup
    return out


START = {"imported": 3.2, "cuda_ready": 6.5, "ready": 15.0}
# the window's start; a traced run's capture opening and closing; the end
STATS0 = stats(10, 10, 0.02, 0.01, 0.05, 0.12, START)
OPENED = stats(110, 60, 0.32, 0.21, 0.30, 0.72, START)
CLOSED = stats(150, 80, 0.52, 0.41, 0.40, 0.95, START)
STATS1 = stats(210, 110, 0.62, 0.51, 0.55, 1.32, START)


def run_of(stats0, stats1, capture=None):
    cell = SimpleNamespace(config={}, traffic={})
    return Run(cell, 1.0, 1.0, None, [], set(), stats0, stats1, {}, None, 0, None,
               capture)


def read(name, run):
    return load_reader(ROOT, name).read(run)


@pytest.mark.parametrize("split", ["latency", "deadline"])
def test_untraced_run_reads_the_whole_window(split):
    run = run_of(STATS0, STATS1)
    # 200 requests over 100 passes
    assert read(f"queue_wait_ms.{split}", run) == pytest.approx(1e3 * 0.60 / 200)
    assert read(f"front_end_ms.{split}", run) == pytest.approx(1e3 * 0.50 / 200)
    assert read(f"pass_host_ms.{split}", run) == pytest.approx(1e3 * 0.50 / 100)
    assert read(f"pass_wait_ms.{split}", run) == pytest.approx(1e3 * 1.20 / 100)


@pytest.mark.parametrize("split", ["latency", "deadline"])
def test_traced_run_reads_the_stretch_before_the_capture(split):
    run = run_of(STATS0, STATS1, capture=(OPENED, CLOSED))
    # 100 requests over 50 passes before the capture opened
    assert read(f"queue_wait_ms.{split}", run) == pytest.approx(1e3 * 0.30 / 100)
    assert read(f"front_end_ms.{split}", run) == pytest.approx(1e3 * 0.20 / 100)
    assert read(f"pass_host_ms.{split}", run) == pytest.approx(1e3 * 0.25 / 50)
    assert read(f"pass_wait_ms.{split}", run) == pytest.approx(1e3 * 0.60 / 50)


def test_the_four_parts_add_up_to_a_lone_callers_request():
    """With one query a pass, the wait, the front end and the pass's host
    and copy-back time add up to the server's time per request."""
    run = run_of(STATS0, STATS1)
    per_request = sum(read(f"{m}.latency", run) for m in
                      ("queue_wait_ms", "front_end_ms", "pass_host_ms", "pass_wait_ms"))
    assert per_request == pytest.approx(1e3 * (0.60 + 0.50) / 200 + 1e3 * 1.70 / 100)


def test_no_requests_or_no_passes_read_nothing():
    run = run_of(STATS0, STATS0)
    for name in ("queue_wait_ms.latency", "front_end_ms.deadline",
                 "pass_host_ms.latency", "pass_wait_ms.deadline"):
        assert read(name, run) is None


def test_a_server_without_the_counters_reads_nothing():
    """The parent of the change that adds them: ``/stats`` has only the
    pass counts, and no ``startup``."""
    old0 = {"searches": 10, "batches": 10, "total_search_seconds": 1.0}
    old1 = {"searches": 110, "batches": 60, "total_search_seconds": 1.5}
    for capture in (None, (old1, old1)):
        run = run_of(old0, old1, capture)
        for name in ("queue_wait_ms.latency", "front_end_ms.latency",
                     "pass_host_ms.deadline", "pass_wait_ms.deadline",
                     "runtime_init_s"):
            assert read(name, run) is None


def test_runtime_init_reads_the_window_start():
    assert read("runtime_init_s", run_of(STATS0, STATS1)) == 6.5
    # a server on the host has no CUDA step
    cpu = dict(STATS0, startup={"imported": 1.0, "ready": 2.0})
    assert read("runtime_init_s", run_of(cpu, STATS1)) is None
