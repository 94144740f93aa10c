"""Median latency over every request in the window, in ms, timed at the
client: from the moment the request was due (open loop) or sent (closed
loop) to the end of its reply. A failed or wrong request counts as over any
limit."""

from harness.cell import percentile

LAYER = "end to end"
SOURCE = "host_clock"


def read(run):
    lat = run.latencies_ms()
    return percentile(lat, 0.50) if lat else None
