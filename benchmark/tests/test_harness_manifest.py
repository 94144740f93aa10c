"""BENCHMARK.json against the contract it is written to, and the rule that
a cell, a configuration, a mix and a metric are found by name: adding one
adds files and entries and edits none."""

import json
import re
import shutil
from pathlib import Path

import pytest

from harness.manifest import load_manifest, load_reader, reader_path, resolve

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return load_manifest(ROOT)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


def test_names_units_and_lines(manifest):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in manifest[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for e in manifest["configs"] + manifest["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells_and_bounds(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    used = {w["config"] for w in manifest["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in manifest["workloads"])
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(
        1, len(manifest["workloads"]) // 4)
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in manifest["workloads"]:
        cell = resolve(ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


def test_every_metric_has_its_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        reader = load_reader(ROOT, m["name"])
        assert callable(reader.read)
        assert reader.SOURCE == m["source"], m["name"]
        if "layer" in m:
            assert reader.LAYER == m["layer"], m["name"]
    layers = {m["layer"] for m in manifest["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_cells_resolve_to_their_files(manifest):
    cell = resolve(ROOT, "enamine1b-fold4-fdw")
    assert cell.config["rows"] == 1_020_017_472 and cell.traffic["clients"] == 1
    assert cell.config["server_flags"]["fold"] == 4
    assert {m["name"] for m in cell.end_to_end} == {"latency_p50_ms", "latency_p95_ms",
                                                    "setup_s"}
    assert "search_roofline.latency" in {m["name"] for m in cell.per_layer}
    assert reader_path(ROOT, "search_pass_ms.latency").name == "search_pass_ms.py"
    cell = resolve(ROOT, "enamine113m-interactive")
    assert {m["name"] for m in cell.end_to_end} == {"deadline_met_share", "setup_s"}
    assert cell.traffic["deadline_ms"] == 70.59
    assert "request_p50_ms.deadline" in {m["name"] for m in cell.per_layer}
    with pytest.raises(KeyError):
        resolve(ROOT, "no-such-cell")


def test_adding_a_config_mix_and_metric_edits_no_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "enamine113m-unfolded.json").read_text())
    config["rows"] = 510_008_695
    (bench / "configs" / "enamine510m-fold8.json").write_text(json.dumps(config))
    (bench / "traffic" / "open-bursts-k20.json").write_text(json.dumps(
        {"loop": "open", "rate_qps": 40, "k": 20}))
    (bench / "metrics" / "first_request_ms.py").write_text(
        'LAYER = "start-up"\nSOURCE = "host_clock"\n\ndef read(run):\n    return 1.0\n')
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "enamine510m-fold8", "source": "x",
                                "file": "benchmark/configs/enamine510m-fold8.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "enamine510m-bursts", "config": "enamine510m-fold8",
                                  "traffic": "open-bursts-k20", "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "first_request_ms", "unit": "ms",
                                  "better": "lower", "source": "host_clock",
                                  "layer": "start-up", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = resolve(root, "enamine510m-bursts")
    assert cell.config["rows"] == 510_008_695 and cell.traffic["rate_qps"] == 40
    assert "first_request_ms" in {m["name"] for m in cell.per_layer}
    assert load_reader(root, "first_request_ms").read(None) == 1.0
    # a metric with no workloads list reaches every cell that reports what
    # it moves, the old ones too
    assert "first_request_ms" in {m["name"] for m in
                                  resolve(root, "enamine113m-interactive").per_layer}
    for path, data in before.items():
        assert path.read_bytes() == data, path
