"""95th percentile of latency over every request in the window, in ms (of
all requests, not of chunks); the clock is ``latency_p50_ms``'s."""

from harness.cell import percentile

LAYER = "end to end"
SOURCE = "host_clock"


def read(run):
    lat = run.latencies_ms()
    return percentile(lat, 0.95) if lat else None
