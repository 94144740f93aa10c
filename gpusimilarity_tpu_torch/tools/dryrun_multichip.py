"""Run the sharded search end to end over an ``n``-shard mesh in one process
(the torch counterpart of ``__graft_entry__.dryrun_multichip``)::

    python -m gpusimilarity_tpu_torch.tools.dryrun_multichip --shards 4
    python -m gpusimilarity_tpu_torch.tools.dryrun_multichip --shards 4 --cpu_only

The shards go round-robin over the visible cards (several on one card when
there are fewer cards than shards); ``--cpu_only`` puts them all on the
host's plain path. The same sequence as the JAX dry run: dense unfolded,
fold 4 with the exact full-width rescore, bitplane, a popless virtual
library at fold 8, and the bitplane per-process feed (one process: its span
is the whole library). Each search's self-query must come back first at
1.0; any failure raises. The JAX dry run's overlapped-startup step has no
counterpart: the port compiles nothing per shape.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.fingerprint_db import FingerprintDB
from ..ops.bitplane import query_plane_indices
from ..ops.scan import popcount_rows_np
from ..parallel import sharded
from ..parallel.mesh import Mesh, make_mesh
from ..utils import synth
from ..utils.fsim import FingerprintData


def shard_devices(n_shards: int, cpu_only: bool = False) -> list[torch.device]:
    """``n_shards`` devices: the host, or the visible cards round-robin
    (raises without one)."""
    if cpu_only:
        return [torch.device("cpu")] * n_shards
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --cpu_only")
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", i % n_cards) for i in range(n_shards)]


def _self_hit(r, want_id: str, what: str) -> None:
    if not (r.ids and r.ids[0] == want_id and r.scores[0] == 1.0):
        raise AssertionError(f"{what}: expected {want_id} first at 1.0, got "
                             f"{list(zip(r.ids[:3], r.scores[:3]))}")


def dryrun_multichip(mesh: Mesh) -> list[str]:
    """The dry run's steps over ``mesh``; returns what each checked."""
    rng = np.random.default_rng(7)
    count, bitcount = 4096, 1024
    bits = rng.random((count, bitcount)) < 0.1
    packed = np.packbits(bits, axis=1, bitorder="little")
    data = FingerprintData(
        dbkey="dryrun", bitcount=bitcount, fingerprints=packed,
        smiles=[b"C" for _ in range(count)],
        ids=[f"D{i}".encode() for i in range(count)],
    )
    words = data.packed_words()
    queries = words[:3]
    done = []

    db = FingerprintDB(data, mesh=mesh, scan_mode="dense")
    for qi, r in enumerate(db.search_batch(queries, k=16, cutoff=[0.0, 0.2, 0.5],
                                           dbkey="dryrun")):
        _self_hit(r, f"D{qi}", "dense")
    done.append(f"dense over {db.store.n_shards} shards")

    folded = FingerprintDB(data, mesh=mesh, fold_factor=4, scan_mode="dense")
    _self_hit(folded.search(queries[1], k=8, dbkey="dryrun"), "D1", "fold 4")
    done.append("fold 4 with full-width rescore")

    bitp = FingerprintDB(data, mesh=mesh, scan_mode="bitplane")
    _self_hit(bitp.search(queries[2], k=8, dbkey="dryrun"), "D2", "bitplane")
    done.append("bitplane")

    n_virt = synth.aligned_virtual_rows(65536, mesh.n_shards)
    vdata = FingerprintData(
        dbkey="dryrun", bitcount=bitcount,
        fingerprints=synth.VirtualFingerprints(n_virt, bitcount, seed=7),
        smiles=[b"C"] * n_virt, ids=[f"V{i}".encode() for i in range(n_virt)],
    )
    popl = FingerprintDB(vdata, mesh=mesh, fold_factor=8, scan_mode="dense",
                         popless=True)
    if any(s.popcounts is not None for s in popl.store.shards):
        raise AssertionError("popless store holds popcounts")
    _self_hit(popl.search(vdata.packed_words()[5], k=8, dbkey="dryrun"), "V5",
              "popless virtual")
    done.append(f"popless virtual dense, {n_virt} rows at fold 8")

    store = sharded.build_sharded_store(words, mesh, "bitplane")
    if store.local_rows != len(words):
        raise AssertionError(
            f"the feed read {store.local_rows} rows of {len(words)}")
    plane_idx, _ = query_plane_indices(queries[2:3], bitcount)
    vals, idx, _ = sharded.sharded_local_topk(
        store, plane_idx, popcount_rows_np(queries[2:3]),
        np.zeros(1, np.float32), 8,
    )
    if int(idx[0, 0]) != 2 or float(vals[0, 0]) != 1.0:
        raise AssertionError("multihost bitplane feed: self row not first")
    done.append("multihost bitplane feed")
    return done


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--cpu_only", action="store_true",
                        help="put every shard on the host's plain path")
    args = parser.parse_args(argv)
    mesh = make_mesh(shard_devices(args.shards, args.cpu_only))
    t0 = time.monotonic()
    done = dryrun_multichip(mesh)
    devices = ", ".join(map(str, mesh.distinct_devices))
    print(f"dryrun_multichip({args.shards}) on {devices}: OK in "
          f"{time.monotonic() - t0:.2f}s — " + "; ".join(done), flush=True)


if __name__ == "__main__":
    main()
