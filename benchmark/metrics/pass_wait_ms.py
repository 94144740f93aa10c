"""Kernels and selection: mean ms a batched pass's host waited in the copy
back of its results, for the device work it queued and did not hide
(``pass_wait_seconds`` over ``batches`` in the server's ``/stats``), over
the stretch before a traced run's capture opens. A server without the
counter reads nothing."""

LAYER = "kernels and selection"
SOURCE = "program_counter"


def read(run):
    try:
        batches = run.untraced_delta("batches")
        seconds = run.untraced_delta("pass_wait_seconds")
    except KeyError:
        return None
    return 1e3 * seconds / batches if batches > 0 else None
