"""Cards: mean ms a card's worker took, in one batched pass, from its start
until its shards' work was queued (the span ``tpusim.card.launch``:
Δ``card_launch_seconds``, summed over the cards, over Δ``batches`` and
the cell's cards, from the server's ``/stats``), over the stretch before a
traced run's capture opens. A server without the counter reads nothing."""

LAYER = "cards"
SOURCE = "program_counter"


def read(run):
    try:
        batches = run.untraced_delta("batches")
        seconds = run.untraced_delta("card_launch_seconds")
    except KeyError:
        return None
    return 1e3 * seconds / batches / run.cell.chips if batches > 0 else None
