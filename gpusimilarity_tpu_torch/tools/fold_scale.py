"""Folded search over a library larger than the card (twin of the
repository's ``tools/fold_scale.py``)::

    python -m gpusimilarity_tpu_torch.tools.fold_scale [--rows N] [--fold F]
        [--dir PATH] [--queries Q] [--k K] [--mode dense|bitplane]
        [--and_slabs S] [--generate_only] [--cpu_only]

The reference's headline trick is folding: a library larger than GPU
memory is scanned folded and its candidates rescored exactly on the host at
full width (``fingerprintdb_cuda.cu:307-331``; presentation slides 10-13:
510M rows fold 8 on 2x 1080Ti, 1.02B rows fold 4 on 4x V100). This tool:

* stream-writes a synthetic ``.tfsim`` of ``--rows`` 1024-bit rows, byte for
  byte the root tool's (numpy seed 7, ``--and_slabs`` random slabs ANDed,
  ids ``SYN%010d`` as fixed-width records, smiles hardlinked to them); the
  default, 768,000,000 rows, is 98.3 GB of fingerprints, more than one 80 GB
  H100 holds;
* loads it memory-mapped (``utils/tfsim.load_native``), folds and uploads it
  (``FingerprintDB``, ``--mode`` dense or bitplane at ``--fold``);
* runs exact top-k searches, each a library row as its query, and checks
  that rank 0 is that row at 1.0 and that every returned score equals the
  full-width ``scores_np`` of the row it names.

Use ``--and_slabs 4`` (Morgan-like 6.25% density) at fold 8: 50%-dense
random rows OR-fold by 8 to nearly all ones and the folded scan can no
longer rank them. The library is written under ``--dir`` (default
``$TMPDIR/tpusim_fold_scale``) and reused when present. Runs on the card
unless ``--cpu_only`` (the plain versions on the host). Prints one JSON
line; exits 1 unless every query is exact.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

GiB = 1 << 30


def library_path(directory, rows: int, and_slabs: int) -> Path:
    """Where ``generate_tfsim`` puts a library: the root tool's name."""
    density = "" if and_slabs == 1 else f"_d{and_slabs}"
    return Path(directory) / f"rows{rows}{density}.tfsim"


#: the string tables' meta of :func:`write_strided_ids`
STRIDED_IDS = {"kind": "strided", "itemsize": 13}


def write_strided_ids(directory: Path, rows: int) -> None:
    """Write ``ids.blob``, the ids ``SYN`` and 10 digits of every row as
    13-byte records, in slabs, into a ``.tfsim`` directory, and hardlink
    ``smiles.blob`` to it."""
    if rows > 10**10:
        raise ValueError("id generator supports at most 1e10 rows")
    id_len, n_digits = STRIDED_IDS["itemsize"], 10
    with open(directory / "ids.blob", "wb") as f:
        chunk = 8 * 1024 * 1024
        for lo in range(0, rows, chunk):
            hi = min(lo + chunk, rows)
            idx = np.arange(lo, hi, dtype=np.int64)
            out = np.empty((hi - lo, id_len), np.uint8)
            out[:, 0], out[:, 1], out[:, 2] = 0x53, 0x59, 0x4E  # "SYN"
            for d in range(n_digits):
                out[:, id_len - 1 - d] = (idx // 10**d) % 10 + 0x30
            f.write(out.tobytes())
    os.link(directory / "ids.blob", directory / "smiles.blob")


def generate_tfsim(path: Path, rows: int, bitcount: int = 1024,
                   and_slabs: int = 1) -> None:
    """Stream-write a synthetic ``.tfsim`` directory without holding it
    (the same bytes as the root tool's ``generate_tfsim``).

    ``and_slabs``: AND of k independent random slabs, bit density 0.5^k
    (k=4, 6.25%, about 64 of 1024 bits, is Morgan-like). Ids are ``SYN`` and
    10 digits as fixed-width records (no offsets index, which would cost 16
    bytes a row); smiles hardlink to the same blob, so every row has a
    distinct smiles (the service layer merges rows of equal smiles) at no
    extra disk.
    """
    width = bitcount // 8
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=False)
    rng = np.random.default_rng(7)
    t0 = time.monotonic()
    fp_mm = np.lib.format.open_memmap(
        tmp / "fingerprints.npy", mode="w+", dtype=np.uint8, shape=(rows, width),
    )
    slab = (512 * 1024 * 1024) // width
    for lo in range(0, rows, slab):
        hi = min(lo + slab, rows)
        buf = np.frombuffer(bytearray(rng.bytes((hi - lo) * width)), dtype=np.uint8)
        for _ in range(and_slabs - 1):
            buf &= np.frombuffer(rng.bytes((hi - lo) * width), dtype=np.uint8)
        fp_mm[lo:hi] = buf.reshape(hi - lo, width)
    fp_mm.flush()
    del fp_mm

    write_strided_ids(tmp, rows)
    (tmp / "meta.json").write_text(json.dumps({
        "format_version": 1,
        "dbkey": "scale",
        "bitcount": bitcount,
        "count": rows,
        "generator": "synthetic-random",
        "strings": {"ids": STRIDED_IDS, "smiles": STRIDED_IDS},
    }))
    tmp.rename(path)
    print(f"  generated {rows:,} rows in {time.monotonic() - t0:.1f}s",
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=768_000_000)
    ap.add_argument("--fold", type=int, default=4)
    ap.add_argument("--dir", default=str(Path(tempfile.gettempdir()) / "tpusim_fold_scale"))
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--mode", default="dense", choices=("dense", "bitplane"))
    ap.add_argument("--and_slabs", type=int, default=1,
                    help="AND k random slabs: bit density 0.5^k (4 = Morgan-like 6.25%%)")
    ap.add_argument("--cpu_only", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--generate_only", action="store_true",
                    help="write the synthetic library and exit")
    args = ap.parse_args(argv)

    lib_dir = library_path(args.dir, args.rows, args.and_slabs)
    if not lib_dir.exists():
        print(f"generating synthetic library at {lib_dir} ...", file=sys.stderr)
        generate_tfsim(lib_dir, args.rows, and_slabs=args.and_slabs)
    if args.generate_only:  # before torch is imported
        print(f"library ready at {lib_dir}", file=sys.stderr)
        return 0

    import torch

    from ..models.fingerprint_db import FingerprintDB
    from ..ops.scan import scores_np
    from ..parallel.mesh import select_device
    from ..utils.tfsim import load_native
    from .probe_b1 import card_line

    device = select_device(args.cpu_only)
    t0 = time.monotonic()
    data = load_native(lib_dir)
    load_s = time.monotonic() - t0
    print(f"mapped {data.count:,} rows ({data.fingerprints.nbytes / GiB:.1f} GiB) "
          f"in {load_s:.2f}s", file=sys.stderr)

    t0 = time.monotonic()
    db = FingerprintDB(data, device=device, fold_factor=args.fold, scan_mode=args.mode)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.monotonic() - t0
    print(f"folded x{db.fold_factor} and uploaded {db.store.nbytes / GiB:.1f} GiB "
          f"in {build_s:.1f}s", file=sys.stderr)

    rng = np.random.default_rng(123)
    q_rows = rng.choice(args.rows, size=args.queries, replace=False)
    full = data.packed_words()

    t0 = time.monotonic()
    db.search(np.array(full[q_rows[0]]), k=args.k, dbkey="scale")
    first_s = time.monotonic() - t0
    lat = []
    exact_ok = 0
    for qi in q_rows:
        query = np.array(full[qi])
        t0 = time.monotonic()
        r = db.search(query, k=args.k, dbkey="scale", return_indices=True)
        lat.append(time.monotonic() - t0)
        oracle = scores_np(np.array(full[np.asarray(r.indices)]), query[None, :])[0]
        if (r.indices[0] == qi and r.scores[0] == 1.0
                and np.array_equal(np.asarray(r.scores, np.float32), oracle)):
            exact_ok += 1
    p50 = statistics.median(lat)
    print(json.dumps({
        "metric": "folded_search_p50_ms",
        "value": round(p50 * 1e3, 2),
        "unit": "ms",
        "rows": args.rows,
        "fold": db.fold_factor,
        "mode": args.mode,
        "k": args.k,
        "library_gib": round(args.rows * 128 / GiB, 1),
        "device_gib": round(db.store.nbytes / GiB, 1),
        "exact_self_match": f"{exact_ok}/{args.queries}",
        "fps_per_chip": round(args.rows / p50, 1),
        "load_s": round(load_s, 2),
        "fold_upload_s": round(build_s, 1),
        "compile_plus_first_s": round(first_s, 1),
        "card": card_line() if device.type == "cuda" else "cpu",
    }), flush=True)
    return 0 if exact_ok == args.queries else 1


if __name__ == "__main__":
    sys.exit(main())
