"""Cards: mean ms, in one batched pass, from the first card's copy back
done to the last's (Δ``card_lag_seconds`` over Δ``batches`` of the
server's ``/stats``; 0 with one card), over the stretch before a traced
run's capture opens. A server without the counter reads nothing."""

LAYER = "cards"
SOURCE = "program_counter"


def read(run):
    try:
        batches = run.untraced_delta("batches")
        seconds = run.untraced_delta("card_lag_seconds")
    except KeyError:
        return None
    return 1e3 * seconds / batches if batches > 0 else None
