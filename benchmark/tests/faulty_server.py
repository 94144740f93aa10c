"""The program's server with one fault planted under its timed path, for the
test that a run then reads ``correct`` false::

    python faulty_server.py <fault> <server arguments>

Faults: ``altered`` (each answer's top score nudged where the engine
produces it), ``half_library`` (the pass drops every candidate from the
library's second half and halves the counts), ``swapped`` (each caller of a
batch of several gets its neighbour's answer; a lone caller the answer to
its query with the words rotated).
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gpusimilarity_tpu_torch.cli import server  # noqa: E402
from gpusimilarity_tpu_torch.models import fingerprint_db, registry  # noqa: E402
from gpusimilarity_tpu_torch.parallel import sharded  # noqa: E402


def altered():
    orig = fingerprint_db.FingerprintDB._assemble

    def patched(self, *a, **kw):
        vals, idx = orig(self, *a, **kw)
        if len(vals):
            vals = vals.copy()
            vals[0] = np.nextafter(vals[0], np.float32(0))
        return vals, idx

    fingerprint_db.FingerprintDB._assemble = patched


def half_library():
    orig = sharded.sharded_local_topk

    def patched(store, *a, **kw):
        vals, idx, counts = orig(store, *a, **kw)
        vals = vals.clone()
        vals[idx >= store.n_valid // 2] = float("-inf")
        return vals, idx, counts // 2

    sharded.sharded_local_topk = patched


def swapped():
    orig = registry.DatabaseRegistry.search_databases_batch

    def patched(self, dbnames, dbkeys, queries, *a, **kw):
        if len(queries) == 1:
            return orig(self, dbnames, dbkeys, np.roll(queries, 1, axis=1), *a, **kw)
        out = orig(self, dbnames, dbkeys, queries, *a, **kw)
        return out[1:] + out[:1]

    registry.DatabaseRegistry.search_databases_batch = patched


if __name__ == "__main__":
    {"altered": altered, "half_library": half_library, "swapped": swapped}[sys.argv[1]]()
    server.main(sys.argv[2:])
