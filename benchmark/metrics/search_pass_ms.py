"""Engine: mean ms of one batched pass, from the server's ``/stats``
(host-clock seconds around each pass, over the passes), over the window;
in a traced run over the stretch before the capture opens, which the
profiler's cost does not touch."""

LAYER = "engine"
SOURCE = "program_counter"


def read(run):
    batches = run.untraced_delta("batches")
    return 1e3 * run.untraced_delta("total_search_seconds") / batches if batches > 0 else None
