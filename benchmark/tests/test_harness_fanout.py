"""The four-card cell ``enamine1b-unfolded-4chip``: the metrics it reports,
the readers of the fan-out's counters (``/stats``) on canned deltas, and
``search_roofline`` on a canned trace of four cards."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from harness import byte_model as bm
from harness.cell import Run
from harness.manifest import load_reader, resolve
from harness.trace import Trace
from reference.search import k_fetch

ROOT = Path(__file__).resolve().parents[2]
CELL = "enamine1b-unfolded-4chip"
CARD_READERS = ("card_launch_ms.fanout", "card_lag_ms.fanout",
                "shard_merge_ms.fanout")


def stats(batches, launch, lag, merge, extra=True):
    out = {"searches": 3 * batches, "batches": batches,
           "total_search_seconds": 0.05 * batches,
           "stages": {"tpusim.pass.launch": 0.01 * batches}}
    if extra:
        out.update(card_launch_seconds=launch, card_lag_seconds=lag)
        out["stages"]["tpusim.pass.shard_merge"] = merge
    return out


# the window's start; a traced run's capture opening and closing; the end
STATS0 = stats(10, 0.4, 0.01, 0.002)
OPENED = stats(60, 2.4, 0.06, 0.012)
CLOSED = stats(80, 3.2, 0.09, 0.016)
STATS1 = stats(110, 4.4, 0.11, 0.022)


def run_of(stats0, stats1, capture=None, chips=4):
    cell = SimpleNamespace(config={}, traffic={}, chips=chips)
    return Run(cell, 1.0, 1.0, None, [], set(), stats0, stats1, {}, None, 0, None,
               capture)


def read(name, run):
    return load_reader(ROOT, name).read(run)


def test_the_cell_reports_exactly_its_metrics():
    cell = resolve(ROOT, CELL)
    assert cell.chips == 4
    assert cell.config["rows"] == 1_020_017_472
    assert cell.config["server_flags"]["fold"] == 1
    assert cell.config["server_flags"]["scan_mode"] == "bitplane"
    assert cell.traffic["deadline_ms"] == 350 and cell.traffic["k"] == 20
    assert cell.traffic["loop"] == "open" and cell.traffic["senders"] == 64
    assert {m["name"] for m in cell.end_to_end} == {"deadline_met_share", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "request_p50_ms.fanout", "queue_wait_ms.fanout", "front_end_ms.fanout",
        "pass_host_ms.fanout", "pass_wait_ms.fanout", "card_launch_ms.fanout",
        "card_lag_ms.fanout", "shard_merge_ms.fanout", "store_build_s.fanout",
        "runtime_init_s.fanout", "idle_pass_share.fanout", "search_pass_ms.fanout",
        "outside_search_share.fanout", "warmup_s.fanout"}
    for m in cell.per_layer:
        want = "setup_s" if m["name"].split(".")[0] in (
            "store_build_s", "runtime_init_s", "warmup_s") else "deadline_met_share"
        assert m["moves"] == want, m["name"]
        if m["name"] in CARD_READERS:
            assert m["layer"] == "cards"


def test_the_card_readers_read_the_whole_untraced_window():
    run = run_of(STATS0, STATS1)
    # 100 passes over 4 cards
    assert read("card_launch_ms.fanout", run) == pytest.approx(1e3 * 4.0 / 100 / 4)
    assert read("card_lag_ms.fanout", run) == pytest.approx(1e3 * 0.10 / 100)
    assert read("shard_merge_ms.fanout", run) == pytest.approx(1e3 * 0.020 / 100)


def test_the_card_readers_read_the_stretch_before_the_capture():
    run = run_of(STATS0, STATS1, capture=(OPENED, CLOSED))
    # 50 passes before the capture opened
    assert read("card_launch_ms.fanout", run) == pytest.approx(1e3 * 2.0 / 50 / 4)
    assert read("card_lag_ms.fanout", run) == pytest.approx(1e3 * 0.05 / 50)
    assert read("shard_merge_ms.fanout", run) == pytest.approx(1e3 * 0.010 / 50)


def test_the_cells_cards_divide_the_launch_time():
    four, one = run_of(STATS0, STATS1, chips=4), run_of(STATS0, STATS1, chips=1)
    assert read("card_launch_ms.fanout", one) == pytest.approx(
        4 * read("card_launch_ms.fanout", four))


def test_a_server_without_the_counters_reads_nothing():
    """The parent of the change that adds them: ``/stats`` has the pass
    counts and stages, but no card counter and no shard-merge stage."""
    old0, old1 = stats(10, 0, 0, 0, extra=False), stats(110, 0, 0, 0, extra=False)
    for capture in (None, (old1, old1)):
        run = run_of(old0, old1, capture)
        for name in CARD_READERS:
            assert read(name, run) is None, name
    bare0 = {"searches": 10, "batches": 10, "total_search_seconds": 1.0}
    bare1 = {"searches": 110, "batches": 60, "total_search_seconds": 1.5}
    for name in CARD_READERS:
        assert read(name, run_of(bare0, bare1)) is None, name


def test_no_passes_read_nothing():
    run = run_of(STATS0, STATS0)
    for name in CARD_READERS:
        assert read(name, run) is None, name


def ev(name, cat, ts, dur, pid=0, tid=1, corr=None):
    out = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid,
           "tid": tid}
    if corr is not None:
        out["args"] = {"correlation": corr}
    return out


def test_four_cards_at_their_least_time_read_at_most_100(tmp_path):
    """``search_roofline`` on the cell's configuration (the cell does not
    report it yet: PERF.md says why). Each pass launches one kernel on each
    of the four cards, all at once, each taking its own span's least time:
    the bytes of its rows' query planes and popcounts and its k_fetch
    candidates a query. The reader sums device time over the cards and
    takes the whole library's bytes over one card's bandwidth, so it reads
    the four cards' aggregate share: at most 100%, and all but the
    candidates the cards write beside one another."""
    cell = resolve(ROOT, CELL)
    rows = cell.config["rows"]
    quarter = -(-rows // 4)
    per = -(-quarter // 2048) * 2048  # whole selection blocks a card
    card_rows = [per, per, per, rows - 3 * per]
    rng = np.random.default_rng(5)
    words = np.zeros((64, 32), np.uint32)
    for q in range(64):
        bits = rng.choice(1024, 40, replace=False)
        words[q, bits // 32] |= (1 << (bits % 32)).astype(np.uint32)
    batch = 2.0
    kf = k_fetch(int(cell.traffic["k"]), 1, rows)
    union = bm.expected_union_bits(
        np.unpackbits(words.view(np.uint8), axis=1), batch, 7)
    least_us = [1e6 * bm.least_seconds(union * (-(-n // 32)) * 4 + n * 2
                                       + batch * kf * bm.CANDIDATE_BYTES)
                for n in card_rows]
    events, corr = [], 0
    for p in range(3):
        t0 = 100_000.0 * p
        events.append(ev("tpusim.search.enamine1b", "user_annotation", t0,
                         max(least_us) + 1_000.0, tid=9))
        for card, dur in enumerate(least_us):
            corr += 1
            events.append(ev("cudaLaunchKernel", "cuda_runtime", t0 + 10 + card, 5,
                             tid=20 + card, corr=corr))
            events.append(ev("bitplane_phase1", "kernel", t0 + 100, dur, pid=card,
                             corr=corr))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace = Trace.load(path, window_s=0.3)
    opened = {"searches": 20, "batches": 10}
    closed = {"searches": 26, "batches": 13}
    run = Run(cell, 1.0, 1.0, None, [], set(), opened, closed, {}, words, 7, trace,
              (opened, closed))
    share = read("search_roofline.fanout", run)
    whole = bm.least_seconds(bm.bitplane_pass_bytes(rows, union, batch, kf))
    assert share == pytest.approx(100 * whole / (sum(least_us) / 1e6))
    assert 99.0 < share <= 100.0
    # the union of the cards' busy time is about a quarter of their sum
    assert trace.busy_s() == pytest.approx(3 * max(least_us) / 1e6)
