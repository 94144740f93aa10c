"""Front end: mean ms of a request's parse (body, form, ``fp_hex`` to words)
and reply (from its pass's end: the handler's wake-up, JSON, the write),
from the server's ``/stats`` (``front_end_seconds`` over ``requests``),
over the stretch before a traced run's capture opens. A server without
these counters reads nothing."""

LAYER = "front end"
SOURCE = "program_counter"


def read(run):
    try:
        requests = run.untraced_delta("requests")
        seconds = run.untraced_delta("front_end_seconds")
    except KeyError:
        return None
    return 1e3 * seconds / requests if requests > 0 else None
