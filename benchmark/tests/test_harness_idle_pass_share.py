"""The reader of the batcher's idle passes (``idle_pass_share``): the share
of the passes that started at once, no pass being in flight, from two
``/stats`` of the server, and nothing from a server without the counter."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from harness.cell import Run
from harness.manifest import load_reader

ROOT = Path(__file__).resolve().parents[2]


def stats(batches, idle=None):
    out = {"searches": 2 * batches, "batches": batches, "requests": 2 * batches,
           "total_search_seconds": 0.01 * batches, "queue_wait_seconds": 0.001 * batches}
    if idle is not None:
        out["idle_passes"] = idle
    return out


def run_of(stats0, stats1, capture=None):
    cell = SimpleNamespace(config={}, traffic={})
    return Run(cell, 1.0, 1.0, None, [], set(), stats0, stats1, {}, None, 0, None,
               capture)


def read(name, run):
    return load_reader(ROOT, name).read(run)


@pytest.mark.parametrize("split", ["latency", "deadline"])
def test_idle_pass_share_reads_the_stretch_before_the_capture(split):
    # the window's start; a traced run's capture opening and closing; the end
    stats0, opened = stats(10, 4), stats(60, 44)
    closed, stats1 = stats(80, 60), stats(110, 90)
    # 100 passes, 86 of them idle, over the whole window
    assert read(f"idle_pass_share.{split}", run_of(stats0, stats1)) == pytest.approx(86.0)
    # 50 passes, 40 of them idle, before the capture opened
    assert read(f"idle_pass_share.{split}",
                run_of(stats0, stats1, capture=(opened, closed))) == pytest.approx(80.0)
    # no passes: nothing
    assert read(f"idle_pass_share.{split}", run_of(stats0, stats0)) is None


@pytest.mark.parametrize("split", ["latency", "deadline"])
@pytest.mark.parametrize("traced", [False, True])
def test_idle_pass_share_reads_nothing_without_the_counter(split, traced):
    """The parent of the change that adds ``idle_passes``: ``/stats`` has
    ``batches`` but not it."""
    capture = (stats(60), stats(80)) if traced else None
    assert read(f"idle_pass_share.{split}", run_of(stats(10), stats(110), capture)) is None
