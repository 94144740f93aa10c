"""Whole runs on the host: the harness against the program's server with
``--cpu_only`` at a tiny size, sound and with a fault planted under the
timed path; the last line's shape; and the guard on what the harness
loads."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from harness import cell as cell_mod
from harness.manifest import resolve

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
FAULTY = Path(__file__).with_name("faulty_server.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "gpusimilarity_tpu"}


def tiny_root(tmp_path, fold: int, rows: int = 20000) -> Path:
    """A checkout whose one cell ``tiny`` serves a ``rows``-row library of
    the real configuration at ``fold`` to four waiting callers."""
    root = tmp_path / "checkout"
    (root / "benchmark" / "configs").mkdir(parents=True)
    (root / "benchmark" / "traffic").mkdir()
    shutil.copytree(BENCH / "metrics", root / "benchmark" / "metrics")
    src = "enamine1b-fold4" if fold > 1 else "enamine113m-unfolded"
    config = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    config["rows"] = rows
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(config))
    (root / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps({
        "loop": "closed", "clients": 4, "k": 10, "cutoff": 0.0, "query_pool": 64,
        "warm_s": 0.5, "check_sample": 12, "deadline_ms": 60_000,
        "server_flags": {"warmup_ks": "10", "warmup_batch": 1}}))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["workloads"] = [{"name": "tiny", "config": "tiny", "traffic": "tiny",
                              "chips": 1, "why": "x"}]
    for m in manifest["end_to_end"]:
        m.pop("workloads", None)
    for m in manifest["per_layer"]:
        m["workloads"] = ["tiny"]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def run_tiny(root, monkeypatch, prefix=None, trace=False, seed=3_000_000_019):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    cell = resolve(root, "tiny")
    return cell_mod.run_cell(root, cell, seed, 1.5, trace,
                             {"platform": "cpu", "kind": "cpu", "count": 1}, "cpu",
                             cpu=True, server_prefix=prefix)


def test_sound_run_is_correct_and_its_line_has_the_contract_shape(tmp_path, monkeypatch):
    root = tiny_root(tmp_path, fold=4, rows=60000)
    out = run_tiny(root, monkeypatch)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"latency_p50_ms", "deadline_met_share",
                                    "latency_p95_ms", "setup_s"}
    assert line["metrics"]["deadline_met_share"]["value"] == 100.0
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["count"] == 1 and "memory_peak_bytes" in line["device"]
    assert all(c["value"] == 0 and c["limit"] == 0 for c in line["check"].values())
    # the id blob is cached at its fixed place, and linked into the next run
    blobs = list((root / "build" / "benchmark-strings").iterdir())
    assert len(blobs) == 1 and blobs[0].stat().st_size == 60000 * 5


def test_traced_run_reports_per_layer_metrics(tmp_path, monkeypatch):
    root = tiny_root(tmp_path, fold=1)
    out = run_tiny(root, monkeypatch, trace=True, seed=12)
    assert out["correct"] is True
    assert {"search_pass_ms.latency", "request_p50_ms.deadline", "store_build_s",
            "warmup_s"} <= set(out["metrics"])
    assert "latency_p95_ms" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault,fold", [("altered", 1), ("half_library", 4),
                                        ("swapped", 1)])
def test_a_fault_under_the_timed_path_reads_not_correct(tmp_path, monkeypatch, fault, fold):
    root = tiny_root(tmp_path, fold=fold)
    out = run_tiny(root, monkeypatch, prefix=[sys.executable, str(FAULTY), fault])
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["check"].values())
    assert out["failed"] > 0


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if path == FAULTY:
            continue  # plants faults in the program, which is not JAX
        names = _imports(path)
        assert not names & FORBIDDEN, path
        if "reference" in path.parts:
            assert "gpusimilarity_tpu_torch" not in names, path


def test_loaded_modules_are_clean():
    """What the harness, the reference and every reader load, by whole
    top-level names (a prefix test would flag ``gpusimilarity_tpu_torch``)."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import reference.rows, reference.search, reference.compare\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "import harness.cell, harness.trace, harness.byte_model, harness.server\n"
        "from pathlib import Path\n"
        "from harness.manifest import load_reader\n"
        "for p in Path(%r).glob('*.py'): load_reader(Path(%r), p.stem)\n"
        "print(json.dumps([ref, sorted({m.split('.')[0] for m in sys.modules})]))\n"
    ) % (str(BENCH), str(BENCH / "metrics"), str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": ""})
    ref, everything = json.loads(out.stdout.splitlines()[-1])
    assert not set(everything) & FORBIDDEN
    assert "gpusimilarity_tpu_torch" not in ref


def test_runtime_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpusimilarity_tpu_torch_fake", object())
    assert cell_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy_fake", object())
    assert cell_mod.forbidden_modules() == ["jax"]


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "enamine113m-interactive",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA card" in out.stderr
