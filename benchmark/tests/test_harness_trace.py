"""The trace reader and the per-layer metrics' readers, on a small canned
trace and canned ``/stats``."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from harness.manifest import load_reader
from harness.trace import Trace, merge, overlap

ROOT = Path(__file__).resolve().parents[2]


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


# two requests on handler threads; one search pass each on a pool thread;
# kernels inside the passes and a copy; host operations at the capture's
# two edges; times in microseconds
EVENTS = [
    ev("aten::empty", "cpu_op", -5_000, 100, tid=5),
    ev("aten::empty", "cpu_op", 39_900, 100, tid=5),
    ev("tpusim.request", "user_annotation", 0, 10_000, tid=2),
    ev("tpusim.request", "user_annotation", 20_000, 10_000, tid=3),
    ev("tpusim.search.db", "user_annotation", 2_000, 6_000, tid=4),
    ev("tpusim.search.db", "user_annotation", 22_000, 6_000, tid=4),
    ev("aten::copy_", "cpu_op", 12_000, 6_000, tid=4),
    ev("bitplane_phase1", "kernel", 3_000, 2_000),
    ev("gatherTopK", "kernel", 5_000, 1_000),
    ev("bitplane_phase1", "kernel", 23_000, 2_000),
    ev("Memcpy DtoH", "gpu_memcpy", 26_000, 1_000),
    ev("tpusim.search.db", "gpu_user_annotation", 2_000, 6_000),
    {"ph": "i", "name": "marker", "ts": 1},
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return Trace.load(path, window_s=0.040)


def test_intervals():
    assert merge([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert overlap([(0, 10)], [(2, 4), (8, 12)]) == 4


def test_trace_reads_spans_and_device(trace):
    assert len(trace.requests) == 2 and len(trace.searches) == 2
    assert len(trace.device) == 4
    assert trace.busy_s() == pytest.approx(0.006)
    assert trace.device_in_searches_s() == pytest.approx(0.006)
    b = trace.breakdown()
    assert b["device_ops"][0] == ["bitplane_phase1", pytest.approx(0.004)]
    names = dict((n, s) for n, s in b["idle_gaps"])
    # the gap 6-23 ms is mostly under aten::copy_ (12-18 ms): named by what
    # covers its middle
    assert "aten::copy_" in names
    # only the gaps between device operations: 6-23 ms and 25-26 ms
    assert sum(names.values()) == pytest.approx(0.018)


def run_of(trace, stats0, stats1, config, traffic, pool_words=None, capture=None):
    from harness.cell import Run

    cell = SimpleNamespace(config=config, traffic=traffic)
    return Run(cell, 1.0, 1.0, None, [], set(), stats0, stats1,
               {"store_build_s": 3.5, "warmup_s": 0.4}, pool_words, 0, trace, capture)


STATS0 = {"searches": 10, "batches": 10, "total_search_seconds": 1.0}
STATS1 = {"searches": 110, "batches": 60, "total_search_seconds": 1.5}
# a traced run: /stats as the capture opened and closed
OPENED = {"searches": 60, "batches": 30, "total_search_seconds": 1.3}
CLOSED = {"searches": 100, "batches": 40, "total_search_seconds": 1.45}


def test_readers(trace):
    config = {"rows": 1_000_000, "bitcount": 1024,
              "server_flags": {"fold": 4, "scan_mode": "dense"}}
    run = run_of(trace, STATS0, STATS1, config, {"k": 20})
    read = lambda name: load_reader(ROOT, name).read(run)  # noqa: E731
    # 2 x 10 ms of request, of which 2 x 6 ms inside a search span
    assert read("outside_search_share.latency") == pytest.approx(40.0)
    assert read("search_pass_ms.latency") == pytest.approx(10.0)
    assert read("device_idle_share.latency") == pytest.approx(100 * (1 - 0.006 / 0.040))
    assert read("store_build_s") == 3.5 and read("warmup_s") == 0.4
    from harness import byte_model as bm
    least = 2 * bm.least_seconds(bm.dense_pass_bytes(1_000_000, 8, 2.0, 256))
    assert read("search_roofline.latency") == pytest.approx(100 * least / 0.006)


def test_bitplane_roofline_uses_the_union_of_query_bits(trace):
    config = {"rows": 1_000_000, "bitcount": 64,
              "server_flags": {"fold": 1, "scan_mode": "bitplane"}}
    words = np.array([[0xF, 0], [0xF0, 0]], np.uint32)
    run = run_of(trace, STATS0, STATS1, config, {"k": 20}, words)
    from harness import byte_model as bm
    bits = np.unpackbits(words.view(np.uint8), axis=1)
    union = bm.expected_union_bits(bits, 2.0, 0)
    assert union == 8.0
    least = 2 * bm.least_seconds(bm.bitplane_pass_bytes(1_000_000, union, 2.0, 128))
    got = load_reader(ROOT, "search_roofline.throughput").read(run)
    assert got == pytest.approx(100 * least / 0.006)


def test_traced_run_reads_stats_apart_from_the_capture(trace):
    """The engine's pass time comes from the stretch before the capture
    (30 - 10 passes in 0.3 s), the roofline's batch from the capture
    (40 searches over 10 passes)."""
    config = {"rows": 1_000_000, "bitcount": 1024,
              "server_flags": {"fold": 4, "scan_mode": "dense"}}
    run = run_of(trace, STATS0, STATS1, config, {"k": 20}, capture=(OPENED, CLOSED))
    read = lambda name: load_reader(ROOT, name).read(run)  # noqa: E731
    assert read("search_pass_ms.latency") == pytest.approx(15.0)
    from harness import byte_model as bm
    least = 2 * bm.least_seconds(bm.dense_pass_bytes(1_000_000, 8, 4.0, 256))
    assert read("search_roofline.latency") == pytest.approx(100 * least / 0.006)


def test_capture_takes_the_window_end():
    from harness.cell import capture_span

    assert capture_span(51.0) == (5.0, 6.0)
    length, before_end = capture_span(1.5)
    assert length == pytest.approx(0.6) and before_end == pytest.approx(0.75)


@pytest.mark.parametrize("extra,whole", [
    ([], 2),
    # cut by the capture's first or last event
    ([ev("tpusim.request", "user_annotation", -5_000, 4_000, tid=6)], 2),
    ([ev("tpusim.request", "user_annotation", 35_000, 4_990, tid=6)], 2),
    # a request whose pass the capture lacks
    ([ev("tpusim.request", "user_annotation", 31_000, 3_000, tid=6)], 2),
    # a request whose pass ends after it does is not its own
    ([ev("tpusim.request", "user_annotation", 21_000, 3_000, tid=6)], 2),
    # a second whole request
    ([ev("tpusim.request", "user_annotation", 1_000, 8_000, tid=6)], 3),
])
def test_front_end_share_counts_whole_requests(tmp_path, extra, whole):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS + extra}))
    trace = Trace.load(path, window_s=0.045)
    assert len(trace.whole_requests()) == whole
    run = run_of(trace, STATS0, STATS1, {}, {"k": 20})
    got = load_reader(ROOT, "outside_search_share.latency").read(run)
    # each whole request: 6 ms of its time under a pass
    total = 20_000 + (8_000 if whole == 3 else 0)
    assert got == pytest.approx(100 * (1 - (12_000 + (6_000 if whole == 3 else 0)) / total))


def test_readers_find_nothing_without_a_trace():
    run = run_of(None, STATS0, STATS1, {}, {"k": 20})
    for name in ("outside_search_share.latency", "device_idle_share.throughput",
                 "search_roofline.latency"):
        assert load_reader(ROOT, name).read(run) is None
    same = run_of(None, STATS0, STATS0, {}, {"k": 20})
    assert load_reader(ROOT, "search_pass_ms.latency").read(same) is None


@pytest.mark.parametrize("skew_us", [2_500.0, -4_000.0])
def test_device_time_belongs_to_the_span_that_launched_it(tmp_path, skew_us):
    """Device operations whose times read ``skew_us`` off their launches
    (``args.correlation``) still count in the spans that launched them."""
    events = []
    for i, e in enumerate(EVENTS):
        e = dict(e)
        if e.get("cat") in ("kernel", "gpu_memcpy"):
            corr = 100 + i
            events.append(ev("cudaLaunchKernel", "cuda_runtime", e["ts"] - 10, 5, tid=4)
                          | {"args": {"correlation": corr}})
            e = e | {"ts": e["ts"] + skew_us, "args": {"correlation": corr}}
        events.append(e)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace = Trace.load(path, window_s=0.040)
    assert trace.lead_us[0] == pytest.approx(skew_us + 10)
    assert trace.device_in_searches_s() == pytest.approx(0.006)
    assert trace.busy_s() == pytest.approx(0.006)
