"""A library of millions of compounds built from SMILES and searched on the
card (twin of the repository's ``tools/chem_scale.py``)::

    python -m gpusimilarity_tpu_torch.tools.chem_scale [--rows N] [--dir PATH]
        [--workers W] [--sample S] [--keep] [--reuse] [--cpu_only]

The reference's build path is made for 10^9 molecules
(``gpusim_createdb.py:103-147``: an ipyparallel fan-out and 1 GiB chunks).
This tool:

1. writes a ``--rows`` (default 5,000,000) line ``.smi.gz`` corpus of valid,
   Morgan-diverse SMILES (scaffolds times substituent chains, the same
   lines as the JAX tool's), so the real parser and Morgan code do the work;
2. runs ``python -m gpusimilarity_tpu_torch.cli.createdb corpus.smi.gz
   lib.tfsim --dbkey bulk --force --workers W`` as a subprocess and records
   its wall time, compounds a second and peak resident memory: the VmHWM of
   the ``createdb`` process itself, as the JAX tool reads it, which leaves
   out the pool's spawned workers (with ``--workers 1`` nothing runs
   elsewhere); null where ``/proc`` gives no VmHWM;
3. loads the library and checks ``--sample`` rows (numpy seed 5) through the
   port's ``FingerprintDB`` on the card (unfolded, bitplane: kernel 1):
   rank 0 must score 1.0 and the row its id names must hold the query's
   words (the corpus holds duplicate structures, so the query's own id may
   be displaced by an equal row; ``exact_id_in_top5`` counts where it is
   not).

``--cpu_only`` searches with the plain versions on the host. Files go under
``--dir`` (default ``$TMPDIR/tpusim_chem_scale``); the corpus is removed
unless ``--keep``; ``--reuse`` skips the build of an existing library and
prints ``value: null, reused: true``. Prints one JSON line, the JAX tool's
record plus ``card`` and ``kernel_launches``; exits 1 unless every sampled
row matches itself.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

# substituent chain units (each valid as a mid-chain SMILES token) and ring
# cores with one parenthesised attachment point
UNITS = [
    "C", "CC", "O", "N", "CCC", "C(C)", "C(N)C", "C(O)C", "S", "CCO",
    "C(C)C", "CN", "CO", "CCN", "C(C)(C)C", "OC",
]
CORES = [
    "c1ccc({sub})cc1",          # benzene, para
    "c1ccc({sub})cn1",          # pyridine
    "c1cc({sub})ccc1O",         # phenol
    "C1CCC({sub})CC1",          # cyclohexane
    "c1cc({sub})cs1",           # thiophene
    "c1cc({sub})c[nH]1",        # pyrrole
    "c1ccc2cc({sub})ccc2c1",    # naphthalene
    "C1CCN({sub})CC1",          # piperidine (N-attached)
]


def chain(i: int, max_units: int = 4) -> str:
    """A substituent chain of 1 to ``max_units`` units drawn from ``i``."""
    n = 1 + (i % max_units)
    parts = []
    v = i // max_units
    for _ in range(n):
        parts.append(UNITS[v % len(UNITS)])
        v //= len(UNITS)
    return "".join(parts)


def smiles_for(i: int) -> str:
    core = CORES[i % len(CORES)]
    j = i // len(CORES)
    pre = chain(j & 0xFFFF)
    sub = chain((j >> 16) ^ (j & 0xFFFF) ^ 0x2A5)
    return pre + core.format(sub=sub)


def write_corpus(path: Path, rows: int) -> None:
    t0 = time.monotonic()
    with gzip.open(path, "wt", compresslevel=1) as f:
        for i in range(rows):
            f.write(f"{smiles_for(i)} MOL{i:08d}\n")
            if i % 500_000 == 0:
                print(f"  corpus {i / rows:5.1%}", file=sys.stderr, flush=True)
    print(f"corpus: {rows:,} rows in {time.monotonic() - t0:.0f}s",
          file=sys.stderr, flush=True)


def peak_rss_kib(pid: int) -> int | None:
    """VmHWM of process ``pid`` (its own peak, not its children's), or None
    where ``/proc`` does not give it."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmHWM"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def build(corpus: Path, lib: Path, workers: int) -> tuple[float, int | None]:
    """Run the port's ``createdb`` on ``corpus``; ``(seconds, peak KiB or
    None)``."""
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.createdb",
         str(corpus), str(lib), "--dbkey", "bulk", "--force",
         "--workers", str(workers)],
        stderr=subprocess.PIPE, text=True,
    )
    peak = None

    def watch():  # VmHWM only grows; read it until the process is gone
        nonlocal peak
        while proc.poll() is None:
            kib = peak_rss_kib(proc.pid)
            if kib is not None:
                peak = max(peak or 0, kib)
            time.sleep(0.2)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    tail = [line.rstrip()[:200] for line in proc.stderr][-5:]
    proc.wait()
    watcher.join()
    if proc.returncode != 0:
        print("\n".join(tail), file=sys.stderr)
        raise SystemExit(f"createdb failed rc={proc.returncode}")
    return time.monotonic() - t0, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=5_000_000)
    ap.add_argument("--dir", default=str(Path(tempfile.gettempdir()) / "tpusim_chem_scale"))
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--reuse", action="store_true",
                    help="skip the build if the library already exists "
                    "(run only the verification)")
    ap.add_argument("--sample", type=int, default=8)
    ap.add_argument("--cpu_only", action="store_true",
                    help="search with the plain versions on the host")
    args = ap.parse_args(argv)

    base = Path(args.dir)
    base.mkdir(parents=True, exist_ok=True)
    corpus = base / f"corpus_{args.rows}.smi.gz"
    lib = base / f"lib_{args.rows}.tfsim"
    if not corpus.exists():
        write_corpus(corpus, args.rows)

    peak = None
    build_s = 0.0
    if args.reuse and lib.exists():
        print(f"reusing existing {lib}", file=sys.stderr)
    else:
        build_s, peak = build(corpus, lib, args.workers)

    import numpy as np

    from ..models.fingerprint_db import FingerprintDB
    from ..utils import kernels
    from ..utils.tfsim import load_native
    from .loadtest import card

    data = load_native(lib)
    assert data.count == args.rows, (data.count, args.rows)
    db = FingerprintDB(data, device="cpu" if args.cpu_only else None)
    words = data.packed_words()
    rng = np.random.default_rng(5)
    ok = exact_id = 0
    kernels.reset_launches()
    for qi in rng.choice(args.rows, size=args.sample, replace=False):
        r = db.search(np.array(words[qi]), k=5, dbkey="bulk")
        # rank 0 must be a row with the query's words at exactly 1.0 (the
        # query's own id may be displaced by an exact duplicate)
        top = int(r.ids[0].split(";:;")[0].removeprefix("MOL"))
        if r.scores[0] == 1.0 and np.array_equal(
            np.asarray(words[top]), np.asarray(words[qi])
        ):
            ok += 1
        if any(f"MOL{qi:08d}" == i for j in r.ids for i in j.split(";:;")):
            exact_id += 1
    launches = kernels.launch_counts()
    record = {
        "metric": "createdb_mols_per_sec",
        "unit": "mol/s",
        "rows": args.rows,
        "library_mib": round(
            sum(p.stat().st_size for p in lib.rglob("*")) / 2**20, 1
        ),
        "self_match": f"{ok}/{args.sample}",
        "exact_id_in_top5": f"{exact_id}/{args.sample}",
    }
    if build_s:
        record.update(
            value=round(args.rows / build_s, 1),
            build_s=round(build_s, 1),
            peak_rss_mib=None if peak is None else round(peak / 1024, 1),
        )
    else:
        # --reuse skipped the build: a verification-only record, with no
        # build numbers that could be read as measured
        record.update(value=None, reused=True)
    record.update(kernel_launches=launches, card=card(args.cpu_only))
    print(json.dumps(record), flush=True)
    if ok != args.sample:
        print("self-match verification failed", file=sys.stderr)
        return 1
    if not args.keep:
        os.remove(corpus)
    return 0


if __name__ == "__main__":
    sys.exit(main())
