"""Share (%) of every request in the window answered within the mix's
``deadline_ms``, timed at the client as ``latency_p50_ms`` is. A failed or
wrong request misses it. A mix with no deadline has nothing to read."""

LAYER = "end to end"
SOURCE = "host_clock"


def read(run):
    deadline = run.cell.traffic.get("deadline_ms")
    lat = run.latencies_ms()
    if deadline is None or not lat:
        return None
    return 100.0 * sum(1 for x in lat if x <= float(deadline)) / len(lat)
