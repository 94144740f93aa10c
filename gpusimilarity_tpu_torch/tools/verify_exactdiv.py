"""The float32 divide and the cutoff predicate, checked on the card (twin of
the repository's ``tools/verify_exactdiv.py``)::

    python -m gpusimilarity_tpu_torch.tools.verify_exactdiv [--cpu_only]

On a TPU the divide is a reciprocal-multiply that misrounds about a third of
small-integer quotients by one ulp, so the JAX package repairs it
(``ops.scan.exact_div``) and its tool proves the repair on the chip. The
port has no such repair: IEEE float32 ``/`` is correctly rounded on a CUDA
card as on the CPU. This tool proves that on the card:

1. a census of torch's float32 divide on the device over every pair
   ``num <= 2048, 1 <= den <= 4096`` (the grid of ``tests/test_exactdiv.py``)
   against numpy's correctly rounded divide;
2. the engine's predicate ``similarity_from_counts(...) >= cutoff`` over
   every Tanimoto quotient a score can take (``den >= num``: each pair as
   the triple ``common = num``, ``|q| = num + (den - num) // 2``, ``|db| =
   den - |q| + num``) at the cutoffs 0.2, 0.3 (``tests/test_exactdiv.py``),
   0.4, 0.5 and 1.0, against numpy's ``num / den >= cutoff``.

The kernels divide with ``__fdiv_rn`` in their epilogue; ``chip_smoke.py``
holds their scores bit for bit against the plain versions (phases (b),
(b2) and (m)), so no second path of them is checked here. Both checks must
show 0 mismatches. Prints one JSON line; exits 1 on any mismatch.
``--cpu_only`` runs the same checks on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops.scan import similarity_from_counts
from ..parallel.mesh import select_device
from .loadtest import card

CUTOFFS = (0.2, 0.3, 0.4, 0.5, 1.0)


def grid(max_num: int = 2048, max_den: int = 4096):
    """Every ``(num, den)`` pair, ``0 <= num <= max_num``, ``1 <= den <=
    max_den``, as float32 arrays."""
    num = np.arange(0, max_num + 1, dtype=np.float32)
    den = np.arange(1, max_den + 1, dtype=np.float32)
    return np.repeat(num, len(den)), np.tile(den, len(num))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu_only", action="store_true",
                    help="run the checks on the host")
    args = ap.parse_args(argv)
    device = select_device(args.cpu_only)

    c, d = grid()
    want = c / d  # numpy: IEEE correctly rounded
    t0 = time.perf_counter()
    got = (torch.from_numpy(c).to(device) / torch.from_numpy(d).to(device)).cpu().numpy()
    bad = got != want
    divide_s = time.perf_counter() - t0
    for j in np.nonzero(bad)[0][:5]:
        print(f"  {c[j]}/{d[j]}: got {got[j]!r} want {want[j]!r}", file=sys.stderr)

    sel = d >= c
    common = c[sel].astype(np.int32)
    den = d[sel].astype(np.int32)
    qpop = common + (den - common) // 2
    dpop = den - qpop + common
    t0 = time.perf_counter()
    scores = similarity_from_counts(  # one query per quotient: (N, 1)
        torch.from_numpy(common).to(device)[:, None],
        torch.from_numpy(dpop).to(device)[:, None],
        torch.from_numpy(qpop).to(device),
    )[:, 0]
    disagreements = {}
    for cut in CUTOFFS:
        cutf = np.float32(cut)
        dev_ge = (scores >= float(cutf)).cpu().numpy()
        np_ge = c[sel] / d[sel] >= cutf
        disagreements[str(cut)] = int((np_ge != dev_ge).sum())
    predicate_s = time.perf_counter() - t0
    mismatches = int(bad.sum()) + sum(disagreements.values())
    print(json.dumps({
        "device": str(device),
        "grid_pairs": len(c),
        "divide_misrounds": int(bad.sum()),
        "tanimoto_quotients": int(sel.sum()),
        "predicate_disagreements": disagreements,
        "mismatches": mismatches,
        "divide_s": round(divide_s, 3),
        "predicate_s": round(predicate_s, 3),
        "result": "PASS" if mismatches == 0 else "FAIL",
        "card": card(args.cpu_only),
    }), flush=True)
    return 0 if mismatches == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
