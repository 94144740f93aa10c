"""PyTorch port: HTTP/JSON service, CLI and import hygiene, on the CPU.

The port's ``SearchService`` must answer exactly as the JAX package's does
on the same ``.fsim`` files; the port and its serving modules must load
without JAX; the CLI must refuse to start without a GPU unless told to run
on the CPU.
"""

import ast
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import torch

from gpusimilarity_tpu.models import DatabaseRegistry as JaxRegistry
from gpusimilarity_tpu.serve.server import SearchService as JaxService
from gpusimilarity_tpu.utils.fingerprints import smiles_to_fingerprint_bin
from gpusimilarity_tpu.utils.fsim import FingerprintData, write_fsim
from gpusimilarity_tpu_torch.cli import server as cli_server
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.serve.server import (
    RequestError,
    SearchService,
    SimilarityServer,
)

REPO = Path(__file__).resolve().parent.parent

CORPUS = [
    "CCO", "CCCO", "CCCCO", "c1ccccc1", "c1ccncc1", "Cc1ccccc1",
    "CC(=O)O", "CC(=O)N", "CCN(CC)CC", "OCC(O)CO", "Clc1ccccc1",
    "Brc1ccccc1", "CC(C)CC", "C1CCCCC1", "C1CCNCC1", "N#Cc1ccccc1",
]


def _corpus(dbkey=""):
    fps, smiles = [], []
    for s in CORPUS:
        fp, canon = smiles_to_fingerprint_bin(s)
        fps.append(np.frombuffer(fp, np.uint8))
        smiles.append(canon)
    return FingerprintData(
        dbkey=dbkey, fingerprints=np.stack(fps), smiles=smiles,
        ids=[f"CMPD{i:04d}".encode() for i in range(len(CORPUS))],
    )


@pytest.fixture(scope="module")
def fsim_paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchsrv")
    write_fsim(tmp / "corpus.fsim", _corpus())
    write_fsim(tmp / "keyed.fsim", _corpus(dbkey="sekrit"))
    return [str(tmp / "corpus.fsim"), str(tmp / "keyed.fsim")]


@pytest.fixture(scope="module")
def services(fsim_paths):
    port = SearchService(
        DatabaseRegistry.from_fsim_files(fsim_paths, device="cpu"), window_ms=1.0
    )
    ref = JaxService(JaxRegistry.from_fsim_files(fsim_paths), window_ms=1.0)
    yield port, ref
    port.close()
    ref.close()


def _hex(smiles):
    return smiles_to_fingerprint_bin(smiles)[0].hex()


FORMS = {
    "smiles": ({"smiles": "CCO", "return_count": "5", "dbnames": "corpus"}, None),
    "cutoff": ({"smiles": "c1ccccc1", "return_count": "10",
                "similarity_cutoff": "0.2", "dbnames": "corpus"}, None),
    "fp_hex_keyed": ({"fp_hex": _hex("Cc1ccccc1"), "return_count": "4",
                      "dbnames": "keyed", "dbkeys": "sekrit"}, None),
    "all_merged": ({"smiles": "CCO", "return_count": "3", "dbkeys": ",sekrit"}, "all"),
    "wrong_key": ({"smiles": "CCO", "dbnames": "keyed", "dbkeys": "wrong"}, None),
    "tversky": ({"smiles": "Clc1ccccc1", "return_count": "6", "dbnames": "corpus",
                 "similarity": "tversky", "alpha": "0.7", "beta": "0.3"}, None),
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_search_json_matches_jax_service(services, name):
    port, ref = services
    form, url_db = FORMS[name]
    got = port.handle_search(dict(form), url_db)
    want = ref.handle_search(dict(form), url_db)
    assert got["approximate_count"] == want["approximate_count"]
    assert (got["query"], got["query_canonical"]) == (
        want["query"], want["query_canonical"])
    assert [r[:2] for r in got["results"]] == [r[:2] for r in want["results"]]
    gs = [r[2] for r in got["results"]]
    ws = [r[2] for r in want["results"]]
    if form.get("similarity") == "tversky":  # XLA may fuse an FMA
        np.testing.assert_allclose(gs, ws, rtol=1e-6)
    else:
        assert gs == ws
    if name == "wrong_key":
        assert got["results"] == [] and got["approximate_count"] == 0
    if name == "all_merged":
        assert ";:;" in got["results"][0][0]


def test_request_errors(services):
    port, _ = services
    for form in ({"dbnames": "corpus"}, {"smiles": "CCO", "return_count": "0"},
                 {"smiles": "CCO", "similarity": "cosine"},
                 {"fp_hex": "zz", "dbnames": "corpus"}):
        with pytest.raises(RequestError):
            port.handle_search(form)


def _post(port, path, fields):
    body = urllib.parse.urlencode(fields).encode()
    url = f"http://localhost:{port}{path}"
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body)) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.status, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}") as r:
        return json.loads(r.read())


def test_http_roundtrip_and_concurrency(fsim_paths):
    srv = SimilarityServer(
        DatabaseRegistry.from_fsim_files(fsim_paths, device="cpu"), port=0,
        window_ms=20.0,
    )
    srv.start_background()
    try:
        status, payload = _post(srv.port, "/similarity_search_json_corpus",
                                {"smiles": "CCO", "return_count": 3})
        assert status == 200 and payload["results"][0][1:] == ["CCO", 1.0]
        assert set(payload) >= {"approximate_count", "results"}
        out = [None] * 6

        def worker(i):
            out[i] = _post(srv.port, "/similarity_search_json", {
                "fp_hex": _hex(CORPUS[i]), "return_count": 2,
                "dbnames": "corpus", "similarity_cutoff": 0.1 * (i % 3)})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, (status, payload) in enumerate(out):
            assert status == 200
            assert payload["results"][0][0] == f"CMPD{i:04d}"
            assert payload["results"][0][2] == 1.0
        assert _post(srv.port, "/similarity_search_json",
                     {"smiles": "not a smiles((", "dbnames": "corpus"})[0] == 400
        assert _post(srv.port, "/nope", {})[0] == 404
        assert _get(srv.port, "/healthz")["databases"] == ["corpus", "keyed"]
        stats = _get(srv.port, "/stats")
        assert stats["searches"] == 7 and stats["device"] == "cpu"
        assert "bitplane_phase1" in stats["kernel_launches"]
    finally:
        srv.close()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), env.get("PYTHONPATH", "")]
    ).rstrip(os.pathsep)
    return env


def test_port_imports_without_jax():
    """Every module of the port (its serving and CLI modules and the probe
    among them) and the chip smoke script load without JAX and without
    anything of the JAX package (the machine with the card has neither)."""
    code = (
        "import pkgutil, sys\n"
        "import gpusimilarity_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'gpusimilarity_tpu_torch.')]\n"
        "for name in names:\n"
        "    __import__(name)\n"
        "import chip_smoke\n"
        "assert 'gpusimilarity_tpu_torch.tools.probe_mxu' in names, names\n"
        "assert 'gpusimilarity_tpu_torch.serve.server' in names, names\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'gpusimilarity_tpu'))\n"
        "assert not bad, bad\n"
        "print('jax-free', len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "jax-free" in proc.stdout


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` and the probe reach the host code only through the
    port; neither imports ``jax`` or ``gpusimilarity_tpu``, at module level
    or inside a function."""
    for path in ("chip_smoke.py", "gpusimilarity_tpu_torch/tools/probe_mxu.py"):
        tree = ast.parse((REPO / path).read_text())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                roots.add("." if node.level else node.module.split(".")[0])
        assert roots & {"gpusimilarity_tpu_torch", "."}, (path, roots)
        assert not roots & {"jax", "jaxlib", "gpusimilarity_tpu"}, (path, roots)


def test_cli_raises_without_cuda(fsim_paths, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_server.main([fsim_paths[0], "--port", "0"])


def _start_cli(*args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server", *args,
         "--port", "0", "--cpu_only"],
        cwd=REPO, env=_env(), stderr=subprocess.PIPE, text=True,
    )
    for line in proc.stderr:
        if "ready on" in line:
            return proc, int(line.split("ready on ")[1].split()[0].split(":")[1])
    return proc, None


def _stop(proc):
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def test_cli_cpu_only_fold2_serves_like_jax(tmp_path):
    """``--cpu_only --fold 2`` serves a folded dense library over HTTP; its
    answers equal the JAX registry's at fold 2 (dense, Pallas phase 1)."""
    rng = np.random.default_rng(21)
    bits = rng.random((3000, 1024)) < 0.05
    data = FingerprintData(
        fingerprints=np.packbits(bits, axis=1, bitorder="little"),
        smiles=[f"C{i}".encode() for i in range(3000)],
        ids=[f"F{i:05d}".encode() for i in range(3000)],
    )
    path = str(tmp_path / "folded.fsim")
    write_fsim(path, data)
    jreg = JaxRegistry.from_fsim_files([path], fold_factor=2, use_pallas=True)
    proc, port = _start_cli(path, "--fold", "2")
    try:
        assert port, "server exited before printing ready"
        stats = _get(port, "/stats")
        assert stats["databases"]["folded"]["fold_factor"] == 2
        assert stats["databases"]["folded"]["scan_mode"] == "dense"
        words = data.packed_words()
        for i, cut in ((11, 0.0), (2999, 0.1)):
            status, payload = _post(port, "/similarity_search_json", {
                "fp_hex": words[i].view(np.uint8).tobytes().hex(),
                "return_count": 15, "similarity_cutoff": cut})
            want = jreg.search_databases(["folded"], [""], words[i], 15, cut)
            assert status == 200
            assert payload["approximate_count"] == want.approximate_count
            assert [r[0] for r in payload["results"]] == want.ids
            assert [r[2] for r in payload["results"]] == want.scores
            assert payload["results"][0][:2] == [f"F{i:05d}", f"C{i}"]
            assert payload["results"][0][2] == 1.0
    finally:
        _stop(proc)


def test_cli_cpu_only_serves(fsim_paths):
    """``--cpu_only`` serves the plain path end to end in a subprocess."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server",
         fsim_paths[0], "--port", "0", "--cpu_only"],
        cwd=REPO, env=_env(), stderr=subprocess.PIPE, text=True,
    )
    try:
        port = None
        for line in proc.stderr:
            if "ready on" in line:
                port = int(line.split("ready on ")[1].split()[0].split(":")[1])
                break
        assert port, "server exited before printing ready"
        status, payload = _post(port, "/similarity_search_json",
                                {"smiles": "CCCO", "return_count": 2})
        assert status == 200 and payload["results"][0][1:] == ["CCCO", 1.0]
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
