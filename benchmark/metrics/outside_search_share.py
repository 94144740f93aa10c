"""Front end: the share (%) of the ``tpusim.request`` spans' time (each HTTP
POST on its handler thread) in which no ``tpusim.search.<name>`` span (a
batched pass, on any thread) ran, in the traced window: parsing, the
batcher's window, the reply's JSON and HTTP.

Only requests the capture holds whole count (``Trace.whole_requests``). A
pass of any caller covers a request: where callers overlap, a request that
waits behind another caller's pass reads that wait as search time, not as
front-end time; with one caller at a time every pass is the request's own.
"""

from harness.trace import merge, overlap

LAYER = "front end"
SOURCE = "program_span"


def read(run):
    if run.trace is None:
        return None
    requests = run.trace.whole_requests()
    total = sum(b - a for a, b in requests)
    if total <= 0:
        return None
    covered = overlap(requests, merge(run.trace.searches))
    return 100.0 * (1.0 - covered / total)
