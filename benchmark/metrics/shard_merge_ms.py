"""Cards: mean ms of a batched pass's shard merge, the shards' candidates
stacked, gathered and merged on the host (the stage
``tpusim.pass.shard_merge`` of the server's ``/stats`` ``stages``, over
Δ``batches``), over the stretch before a traced run's capture opens. A
server without the stage reads nothing."""

LAYER = "cards"
SOURCE = "program_counter"
STAGE = "tpusim.pass.shard_merge"


def read(run):
    end = run.stats_capture[0] if run.stats_capture else run.stats1
    try:
        seconds = (float(end["stages"][STAGE])
                   - float(run.stats0["stages"][STAGE]))
    except KeyError:
        return None
    batches = run.untraced_delta("batches")
    return 1e3 * seconds / batches if batches > 0 else None
