"""Kernels and selection: the share (%) of the device time inside the
``tpusim.search.<name>`` spans that the passes' least work needs.

The work is the byte model's (``harness/byte_model.py``): from the
configuration and the batch's queries, never from the kernels that ran.
Each traced pass counts the mean batch of the capture (``/stats`` searches
over batches, read as it opened and closed); for a bitplane store the planes read are the mean union of
that many of the window's queries' bits. The least time is those bytes
over the data sheet's 3.35 TB/s."""

import numpy as np

from harness import byte_model
from reference.rows import fold_np
from reference.search import k_fetch

LAYER = "kernels and selection"
SOURCE = "device_trace"


def read(run):
    trace = run.trace
    if trace is None or not trace.searches:
        return None
    device_s = trace.device_in_searches_s()
    batches = run.captured_delta("batches")
    if device_s <= 0 or batches <= 0:
        return None
    batch = run.captured_delta("searches") / batches
    config = run.cell.config
    flags = config["server_flags"]
    fold = int(flags.get("fold", 1))
    rows = config["rows"]
    words = config["bitcount"] // 32 // fold
    kf = k_fetch(int(run.cell.traffic["k"]), fold, rows)
    if flags["scan_mode"] == "bitplane":
        folded = fold_np(run.pool_words, fold)
        bits = np.unpackbits(np.ascontiguousarray(folded).view(np.uint8), axis=1)
        union = byte_model.expected_union_bits(bits, batch, run.seed)
        nbytes = byte_model.bitplane_pass_bytes(rows, union, batch, kf)
    else:
        nbytes = byte_model.dense_pass_bytes(rows, words, batch, kf)
    least = len(trace.searches) * byte_model.least_seconds(nbytes)
    return 100.0 * least / device_s
