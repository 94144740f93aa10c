"""Request: median latency in ms, timed at the client as
``latency_p50_ms`` is, over the window's requests due before a traced
run's capture opened, which the profiler's cost does not touch."""

from harness.cell import percentile

LAYER = "request"
SOURCE = "host_clock"


def read(run):
    lat = run.untraced_latencies_ms()
    return percentile(lat, 0.50) if lat else None
