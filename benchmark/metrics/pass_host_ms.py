"""Engine: mean ms of host time in one batched pass, the pass less the time
the host waited in its copy back (``pass_host_seconds`` over ``batches`` in
the server's ``/stats``), over the stretch before a traced run's capture
opens. A server without the counter reads nothing."""

LAYER = "engine"
SOURCE = "program_counter"


def read(run):
    try:
        batches = run.untraced_delta("batches")
        seconds = run.untraced_delta("pass_host_seconds")
    except KeyError:
        return None
    return 1e3 * seconds / batches if batches > 0 else None
