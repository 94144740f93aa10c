"""Run one cell of the port's benchmark once::

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``benchmark/configs/``) and a traffic mix
(``benchmark/traffic/``); the run serves the configuration's synthetic
library from ``gpusimilarity_tpu_torch.cli.server`` on the card, drives the
mix for ``--seconds`` after the set-up, checks a sample of the window's
answers against the plain reference (``benchmark/reference/``), and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` (and ``breakdown`` when traced), and
``check``, each number compared beside its limit (also the last lines on
standard error).

Two options are for measuring the benchmark itself, never for a check:
``--control half_scores,no_rescore`` also judges the reference computed with
one guarantee broken (see ``reference/search.py``), and ``--sweep
r1,r2,...`` runs an open-loop mix at each rate in turn on one server and
prints a line per rate, with no result.

Exits 2 without a result when the card is missing (or fewer cards than the
cell asks for), and 3 when a forbidden module (JAX, or the JAX package) is
loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path.cwd()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="",
                    help="comma-separated controls to judge beside the program "
                    "(measuring the check; not for the benchmark's runs)")
    ap.add_argument("--sweep", default="",
                    help="comma-separated open-loop rates (queries/s) to run in "
                    "turn, one line each, no result")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from harness.cell import forbidden_modules, log, run_cell, card_power_limit_w
    from harness.manifest import resolve

    cell = resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"the cell needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    # the card's name is read once the server has stopped: this process
    # opens no CUDA context while the server uses the card
    device = {"platform": "gpu", "kind": "", "count": cell.chips,
              "power_limit_w": card_power_limit_w()}
    controls = tuple(c for c in args.control.split(",") if c)
    rates = tuple(float(r) for r in args.sweep.split(",") if r)
    result = run_cell(ROOT, cell, args.seed, args.seconds, bool(args.trace), device,
                      "cuda", controls=controls, sweep_rates=rates)
    if result is not None:
        result["device"]["kind"] = torch.cuda.get_device_name(0)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in the harness: {', '.join(bad)}")
        return 3
    if result is None:
        return 0
    for name, c in result["check"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
