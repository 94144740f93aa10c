"""Batching: mean ms a request waited from its enqueue until the pass that
served it started (the batch window, then a free pool thread), from the
server's ``/stats`` (``queue_wait_seconds`` over ``requests``), over the
stretch before a traced run's capture opens. A server without these
counters reads nothing."""

LAYER = "batching"
SOURCE = "program_counter"


def read(run):
    try:
        requests = run.untraced_delta("requests")
        seconds = run.untraced_delta("queue_wait_seconds")
    except KeyError:
        return None
    return 1e3 * seconds / requests if requests > 0 else None
