"""Read a captured Chrome trace (``torch.profiler``'s ``export_chrome_trace``
of the server): the device's operations, the program's spans, and the
host's operations, as intervals in the trace's microseconds.

Device operations are the complete events of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the program's spans are the host-side
``user_annotation`` events named ``tpusim.request`` (each HTTP POST) and
``tpusim.search.<name>`` (each batched pass over one database).

The device's times and the host's do not always line up: some captures
read a share of the kernels starting up to tens of ms before their launch.
Each device operation names the host call that launched it
(``args.correlation``), so a device operation belongs to the span that
launched it, by the launch's host time, whatever its own time reads.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
REQUEST_SPAN = "tpusim.request"
SEARCH_PREFIX = "tpusim.search."
# a request span that begins or ends this close (us) to the capture's first
# or last event may have been cut by the capture's edge
EDGE_US = 1000.0


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def measure(intervals) -> float:
    return sum(b - a for a, b in merge(intervals))


def overlap(intervals, union) -> float:
    """How much of ``intervals`` (each counted whole) the disjoint sorted
    ``union`` covers."""
    if not union:
        return 0.0
    starts = np.array([a for a, _ in union])
    ends = np.array([b for _, b in union])
    total = 0.0
    for a, b in intervals:
        lo = np.searchsorted(ends, a, side="right")
        hi = np.searchsorted(starts, b, side="left")
        for i in range(lo, hi):
            total += max(0.0, min(b, ends[i]) - max(a, starts[i]))
    return total


class Trace:
    """One capture; ``window_s`` is its length (the listener's reply)."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device: list[tuple[float, float, str]] = []
        self.requests: list[tuple[float, float]] = []
        self.searches: list[tuple[float, float]] = []
        self.host: list[tuple[float, float, str]] = []
        self.extent = (np.inf, -np.inf)
        launched: dict = {}  # correlation -> the launching host call's start
        device_corr: list = []
        kernel_lead: list = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            a = float(e["ts"])
            b = a + float(e["dur"])
            self.extent = (min(self.extent[0], a), max(self.extent[1], b))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((a, b, name))
                device_corr.append((corr, cat == "kernel"))
            elif cat in HOST_CATS:
                self.host.append((a, b, name))
                if corr is not None and cat in ("cuda_runtime", "cuda_driver"):
                    launched[corr] = a
                if cat == "user_annotation":
                    if name == REQUEST_SPAN:
                        self.requests.append((a, b))
                    elif name.startswith(SEARCH_PREFIX):
                        self.searches.append((a, b))
        for (a, _, _), (corr, kernel) in zip(self.device, device_corr):
            if kernel and corr in launched:
                kernel_lead.append(a - launched[corr])
        # kernel start less launch (us): least, 1st percentile, median; a
        # negative one is a kernel whose time reads before its launch
        lead = np.sort(np.array(kernel_lead)) if kernel_lead else np.zeros(1)
        self.lead_us = [float(lead[0]), float(lead[len(lead) // 100]),
                        float(lead[len(lead) // 2])]
        self.device_launch = [launched.get(corr) for corr, _ in device_corr]

    @classmethod
    def load(cls, path, window_s: float) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], window_s)

    def whole_requests(self) -> list[tuple[float, float]]:
        """The request spans that the capture holds whole: away from its
        edges, and holding a whole search span (the pass that answered it;
        a request that holds none lost its pass to the capture's edge or to
        a thread the profiler did not follow)."""
        lo, hi = self.extent[0] + EDGE_US, self.extent[1] - EDGE_US
        searches = sorted(self.searches)
        starts = np.array([a for a, _ in searches])
        out = []
        for a, b in self.requests:
            if a < lo or b > hi:
                continue
            i = np.searchsorted(starts, a, side="left")
            if any(e <= b for _, e in searches[i:np.searchsorted(starts, b, side="right")]):
                out.append((a, b))
        return out

    def device_union(self) -> list[tuple[float, float]]:
        return merge((a, b) for a, b, _ in self.device)

    def busy_s(self) -> float:
        return measure((a, b) for a, b, _ in self.device) / 1e6

    def device_in_searches_s(self) -> float:
        """Device time of the operations that the search spans launched (an
        operation without a known launch: that started inside one), summed:
        one stream runs them one after another, and a sum does not depend
        on where their times lie."""
        spans = merge(self.searches)
        if not spans:
            return 0.0
        starts = np.array([a for a, _ in spans])
        ends = np.array([b for _, b in spans])
        mine = []
        for (a, b, _), t in zip(self.device, self.device_launch):
            t = a if t is None else t
            i = np.searchsorted(starts, t, side="right") - 1
            if i >= 0 and t <= ends[i]:
                mine.append(b - a)
        return sum(mine) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the device's
        200 longest idle gaps between its first and last operation, summed
        by what the host was doing in them (the shortest host operation or
        span over a gap's middle, on any thread)."""
        by_op: dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            by_op[name] += (b - a) / 1e6
        busy = self.device_union()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        gaps = gaps[:200]
        by_host: dict[str, float] = defaultdict(float)
        if gaps:
            hs = np.array([h[0] for h in self.host]) if self.host else np.zeros(0)
            he = np.array([h[1] for h in self.host]) if self.host else np.zeros(0)
            for a, b in gaps:
                mid = (a + b) / 2
                cover = np.nonzero((hs <= mid) & (he >= mid))[0]
                name = (self.host[cover[np.argmin((he - hs)[cover])]][2]
                        if len(cover) else "host idle")
                by_host[name] += (b - a) / 1e6
        return {
            "device_ops": sorted(([n, s] for n, s in by_op.items()),
                                 key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([n, s] for n, s in by_host.items()),
                                key=lambda x: -x[1])[:top],
        }
