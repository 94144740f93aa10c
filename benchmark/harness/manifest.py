"""Find what a cell needs by name: ``BENCHMARK.json`` at the checkout's root
names the cells; each cell's configuration is ``benchmark/configs/<config>
.json``, its traffic mix ``benchmark/traffic/<traffic>.json``, and each of
its metrics is read by ``benchmark/metrics/<metric>.py`` (or, for a name
split by what it moves, ``<part before the first dot>.py``). Adding a
configuration, a mix or a metric adds files and entries; no file here
changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = "benchmark"


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _metrics_for(metrics: list, cell: str, reported: set | None = None) -> list:
    """The metrics a cell reports: those that list it, and those without a
    list whose ``moves`` the cell reports (per-layer) or, for end-to-end
    metrics (``reported`` None), those without a list."""
    out = []
    for m in metrics:
        listed = m.get("workloads")
        if listed is not None:
            if cell in listed:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def resolve(root: Path, workload: str) -> Cell:
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    base = root / BENCH_DIR
    config = json.loads((base / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    config.setdefault("name", w["config"])
    e2e = _metrics_for(manifest["end_to_end"], workload)
    per_layer = _metrics_for(manifest["per_layer"], workload, {m["name"] for m in e2e})
    return Cell(workload, config, traffic, int(w["chips"]), e2e, per_layer)


def reader_path(root: Path, metric: str) -> Path:
    base = root / BENCH_DIR / "metrics"
    whole = base / f"{metric}.py"
    return whole if whole.exists() else base / f"{metric.split('.', 1)[0]}.py"


def load_reader(root: Path, metric: str):
    """The module that reads ``metric``: it has ``LAYER``, ``SOURCE`` and
    ``read(run) -> float | None``."""
    path = reader_path(root, metric)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
