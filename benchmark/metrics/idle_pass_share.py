"""Batching: % of the batcher's passes that started at once, no pass being
in flight (Δ``idle_passes`` over Δ``batches`` of the server's ``/stats``),
over the stretch before a traced run's capture opens. A server without
the counter reads nothing."""

LAYER = "batching"
SOURCE = "program_counter"


def read(run):
    try:
        batches = run.untraced_delta("batches")
        idle = run.untraced_delta("idle_passes")
    except KeyError:
        return None
    return 100.0 * idle / batches if batches > 0 else None
