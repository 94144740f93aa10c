"""PyTorch port: the command-line tools, the FDW and the served surfaces, on
the CPU.

``createdb``, ``convertdb`` and ``mergedb`` of both packages must write
byte-identical files from the same input and refuse or replace an existing
database the same way; the host-only tools must not import torch (so they
cannot touch a card). ``cli.server --cpu_only --socket_name ...
--http_interface`` must answer over HTTP, the HTML UI and the socket, and
the ``search`` REPL and the FDW must read it as they read the JAX server.
"""

import filecmp
import gzip
import io
import os
import signal
import subprocess
import sys
import urllib.request
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest

import gpusimilarity_tpu.cli.convertdb as jconvertdb
import gpusimilarity_tpu.cli.createdb as jcreatedb
import gpusimilarity_tpu.cli.mergedb as jmergedb
import gpusimilarity_tpu.fdw as jfdw
from gpusimilarity_tpu.models import DatabaseRegistry as JaxRegistry
from gpusimilarity_tpu_torch.cli import convertdb as pconvertdb
from gpusimilarity_tpu_torch.cli import createdb as pcreatedb
from gpusimilarity_tpu_torch.cli import mergedb as pmergedb
from gpusimilarity_tpu_torch.cli import search as psearch
from gpusimilarity_tpu_torch import fdw as pfdw
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.utils import tfsim as ptfsim

from tests_socket_helpers import decode_response, encode_request

REPO = Path(__file__).resolve().parent.parent

SMILES = [
    "CCO", "CCCO", "CCCCO", "c1ccccc1", "c1ccncc1", "Cc1ccccc1", "CC(=O)O",
    "CC(=O)N", "CCN(CC)CC", "OCC(O)CO", "Clc1ccccc1", "Brc1ccccc1", "CC(C)CC",
    "C1CCCCC1", "C1CCNCC1", "N#Cc1ccccc1", "CC(=O)Oc1ccccc1C(=O)O",
    "C[NH+](C)CC(=O)N1c2ccccc2Sc2ccccc21", "c1ccc2ccccc2c1", "OCCO",
]


def _smi_gz(path, offset=0):
    """A ``.smi.gz`` of :data:`SMILES` with ZINC ids, a bad SMILES, a
    one-field line and a blank line."""
    lines = [f"{s} ZINC{offset + i:06d}" for i, s in enumerate(SMILES)]
    lines[5:5] = ["C1CC(N BAD1", "lonelytoken", ""]
    with gzip.open(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def _tree_bytes(path):
    """A file's bytes, or a directory's {name: bytes}."""
    p = Path(path)
    if p.is_dir():
        return {f.name: f.read_bytes() for f in sorted(p.iterdir())}
    return p.read_bytes()


def _outputs(path):
    out = {"db": _tree_bytes(path)}
    if os.path.exists(f"{path}.meta.json"):
        out["sidecar"] = _tree_bytes(f"{path}.meta.json")
    return out


CREATEDB = {"jax": jcreatedb, "port": pcreatedb}


@pytest.mark.parametrize("ext", [".fsim", ".tfsim"])
@pytest.mark.parametrize("workers", [["--singleThreaded"], ["--workers", "2"]],
                         ids=["single", "pool2"])
def test_createdb_writes_what_the_jax_createdb_writes(tmp_path, ext, workers):
    src = _smi_gz(tmp_path / "in.smi.gz")
    out = {}
    for side, mod in CREATEDB.items():
        path = str(tmp_path / f"{side}{ext}")
        # the JAX pool forks, which this test process must not do
        mod.main([src, path, "--dbkey", "key1",
                  *(workers if side == "port" else ["--singleThreaded"])])
        out[side] = _outputs(path)
    assert out["port"] == out["jax"]
    data = ptfsim.load_any(str(tmp_path / f"port{ext}"))
    assert data.count == len(SMILES) and data.dbkey == "key1"
    assert data.generator == "rdkit-compat-morgan-r2-1024"
    assert b"BAD1" not in b"".join(data.ids)


@pytest.mark.parametrize("ext", [".fsim", ".tfsim"])
def test_createdb_refuses_to_clobber_and_force_replaces_as_jax_does(tmp_path, ext):
    first, second = _smi_gz(tmp_path / "a.smi.gz"), _smi_gz(tmp_path / "b.smi.gz", 500)
    out = {}
    for side, mod in CREATEDB.items():
        path = str(tmp_path / f"{side}{ext}")
        mod.main([first, path, "--singleThreaded"])
        before = _outputs(path)
        with pytest.raises(SystemExit) as exc:
            mod.main([second, path, "--singleThreaded"])
        assert exc.value.code == 2, side
        assert _outputs(path) == before, side  # untouched
        mod.main([second, path, "--singleThreaded", "--force"])
        out[side] = _outputs(path)
        assert out[side] != before
        assert not [p for p in os.listdir(tmp_path) if ".tmp." in p or ".new." in p]
    assert out["port"] == out["jax"]


def test_createdb_force_replaces_a_directory_with_an_fsim_as_jax_does(tmp_path):
    src = _smi_gz(tmp_path / "in.smi.gz")
    out = {}
    for side, mod in CREATEDB.items():
        path = tmp_path / f"{side}.fsim"
        path.mkdir()
        (path / "old").write_text("old")
        mod.main([src, str(path), "--singleThreaded", "--force"])
        out[side] = _outputs(path)
    assert out["port"] == out["jax"] and isinstance(out["port"]["db"], bytes)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Two ``.fsim`` libraries written by the port's createdb, one keyed."""
    tmp = tmp_path_factory.mktemp("built")
    a, b = str(tmp / "alpha.fsim"), str(tmp / "beta.fsim")
    pcreatedb.main([_smi_gz(tmp / "a.smi.gz"), a, "--singleThreaded", "--dbkey", "k"])
    pcreatedb.main([_smi_gz(tmp / "b.smi.gz", 100), b, "--singleThreaded", "--dbkey", "k"])
    return tmp, a, b


@pytest.mark.parametrize("dbkey", [None, "other"])
def test_mergedb_writes_what_the_jax_mergedb_writes(built, tmp_path, dbkey):
    _tmp, a, b = built
    extra = [] if dbkey is None else ["--dbkey", dbkey]
    for side, mod in (("jax", jmergedb), ("port", pmergedb)):
        mod.main(["-o", str(tmp_path / f"{side}.fsim"), a, b, a, *extra])
    assert _outputs(tmp_path / "port.fsim") == _outputs(tmp_path / "jax.fsim")
    merged = ptfsim.load_any(str(tmp_path / "port.fsim"))
    assert merged.count == 3 * len(SMILES) and merged.dbkey == (dbkey or "k")


@pytest.mark.parametrize("route", ["fsim_to_tfsim", "tfsim_to_fsim"])
def test_convertdb_writes_what_the_jax_convertdb_writes(built, tmp_path, route):
    _tmp, a, _b = built
    src = a
    if route == "tfsim_to_fsim":
        src = str(tmp_path / "src.tfsim")
        pconvertdb.main([a, src])
    ext = ".tfsim" if route == "fsim_to_tfsim" else ".fsim"
    for side, mod in (("jax", jconvertdb), ("port", pconvertdb)):
        mod.main([src, str(tmp_path / f"{side}{ext}")])
    assert _outputs(tmp_path / f"port{ext}") == _outputs(tmp_path / f"jax{ext}")
    if route == "tfsim_to_fsim":
        assert filecmp.cmp(tmp_path / "port.fsim", a, shallow=False)


def _writer_batches(n_batches):
    rng = np.random.default_rng(n_batches)
    out = []
    for b in range(n_batches):
        n = int(rng.integers(0, 40))
        fps = np.packbits(rng.random((n, 1024)) < 0.1, axis=1, bitorder="little")
        out.append((fps.tobytes() if b % 2 else fps,
                    [f"C{b}.{i}".encode() for i in range(n)],
                    [f"ID{b}.{i}".encode() for i in range(n)]))
    return out


@pytest.mark.parametrize("n_batches", [0, 1, 4])
def test_stream_writer_writes_what_the_jax_writer_writes(tmp_path, n_batches):
    from gpusimilarity_tpu.utils.tfsim import TfsimStreamWriter as JaxWriter

    for side, cls in (("jax", JaxWriter), ("port", ptfsim.TfsimStreamWriter)):
        with cls(tmp_path / f"{side}.tfsim", dbkey="k", generator="g") as w:
            for batch in _writer_batches(n_batches):
                w.append_batch(*batch)
    assert _outputs(tmp_path / "port.tfsim") == _outputs(tmp_path / "jax.tfsim")


@pytest.mark.parametrize("bad", ["words", "short_ids", "exists"])
def test_stream_writer_refuses_what_the_jax_writer_refuses(tmp_path, bad):
    from gpusimilarity_tpu.utils.tfsim import TfsimStreamWriter as JaxWriter

    fps = np.zeros((3, 128), np.uint8)
    errors = {}
    for side, cls in (("jax", JaxWriter), ("port", ptfsim.TfsimStreamWriter)):
        path = tmp_path / f"{side}.tfsim"
        if bad == "exists":
            path.mkdir()
        try:
            with cls(path) as w:
                if bad == "words":
                    w.append_batch(fps.view(np.uint32), [b"C"] * 3, [b"I"] * 3)
                else:
                    w.append_batch(fps, [b"C"] * 3, [b"I"] * 2)
        except (TypeError, ValueError, FileExistsError) as e:
            errors[side] = type(e)
        assert [p.name for p in tmp_path.iterdir() if ".tmp." in p.name] == []
        assert path.exists() == (bad == "exists")
    assert errors["port"] == errors["jax"]


def test_tfsim_convert_round_trips(built, tmp_path):
    _tmp, a, _b = built
    ptfsim.convert(a, tmp_path / "x.tfsim")
    ptfsim.convert(tmp_path / "x.tfsim", tmp_path / "x.fsim")
    assert filecmp.cmp(tmp_path / "x.fsim", a, shallow=False)


# tool -> the code a fresh interpreter runs ({tmp} holds the inputs)
HOST_TOOLS = {
    "createdb": "from gpusimilarity_tpu_torch.cli import createdb as m\n"
                "m.main(['{tmp}/in.smi.gz', '{tmp}/o.tfsim', '--workers', '2'])",
    "convertdb": "from gpusimilarity_tpu_torch.cli import convertdb as m\n"
                 "m.main(['{tmp}/a.fsim', '{tmp}/a.tfsim'])\n"
                 "m.main(['{tmp}/a.tfsim', '{tmp}/b.fsim'])",
    "mergedb": "from gpusimilarity_tpu_torch.cli import mergedb as m\n"
               "m.main(['-o', '{tmp}/m.fsim', '{tmp}/a.fsim', '{tmp}/a.fsim'])",
    "search": "from gpusimilarity_tpu_torch.cli import search as m\n"
              "m.main(['--port', '9'])",
}


@pytest.mark.parametrize("name", sorted(HOST_TOOLS))
def test_host_tools_do_not_import_torch(name, tmp_path):
    """``createdb`` (whose pool workers import what it imports),
    ``convertdb``, ``mergedb`` and ``search`` run on the host: they never
    import torch, so they can neither need nor touch a card."""
    src = _smi_gz(tmp_path / "in.smi.gz")
    pcreatedb.main([src, str(tmp_path / "a.fsim"), "--singleThreaded"])
    code = HOST_TOOLS[name].format(tmp=tmp_path) + (
        "\nimport sys\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'gpusimilarity_tpu')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env, input="",
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "[]"
    if name == "createdb":
        assert ptfsim.load_any(str(tmp_path / "o.tfsim")).count == len(SMILES)


def test_registry_search_databases_matches_jax(built):
    _tmp, a, b = built
    preg = DatabaseRegistry.from_fsim_files([a, b], device="cpu")
    jreg = JaxRegistry.from_fsim_files([a, b])
    words = ptfsim.load_any(a).packed_words()
    for qi, k, cut, names in ((3, 5, 0.0, ["alpha"]), (16, 30, 0.1, ["alpha", "beta"]),
                              (0, 4, 0.0, ["beta", "alpha"])):
        got = preg.search_databases(names, ["k"] * len(names), words[qi], k, cut)
        want = jreg.search_databases(names, ["k"] * len(names), words[qi], k, cut)
        assert (got.ids, got.smiles, got.scores, got.approximate_count) == (
            want.ids, want.smiles, want.scores, want.approximate_count)


# ------------------------------------------------- the served surfaces


@pytest.fixture(scope="module")
def served(built):
    """``cli.server --cpu_only --socket_name --http_interface`` on the two
    built libraries: (HTTP port, socket path)."""
    tmp, a, b = built
    env = dict(os.environ, PYTHONPATH=str(REPO), TMPDIR=str(tmp))
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server", a, b,
         "--port", "0", "--cpu_only", "--socket_name", "cli.sock",
         "--http_interface", "--search_timeout_s", "60"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True,
    )
    port = None
    for line in proc.stderr:
        if "ready on" in line:
            port = int(line.split("ready on ")[1].split()[0].split(":")[1])
            break
    try:
        assert port, "server exited before printing ready"
        yield port, str(tmp / "cli.sock")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert not os.path.exists(tmp / "cli.sock")  # close() removed the socket


def _http(port, path, fields=None):
    import json
    import urllib.parse

    data = None if fields is None else urllib.parse.urlencode(fields).encode()
    with urllib.request.urlopen(
        urllib.request.Request(f"http://localhost:{port}{path}", data=data), timeout=60
    ) as r:
        body = r.read().decode()
        return json.loads(body) if r.headers["Content-Type"] == "application/json" else body


@pytest.mark.parametrize("dbnames", [["alpha"], ["beta", "alpha"]])
def test_cli_server_answers_over_json_html_and_socket(served, built, dbnames):
    """One query, three surfaces: the socket's answer equals the JSON one,
    and the HTML page shows it with depictions and ZINC links."""
    import socket

    port, sock = served
    words = ptfsim.load_any(built[1]).packed_words()
    form = {"fp_hex": words[6].view(np.uint8).tobytes().hex(), "return_count": 8,
            "similarity_cutoff": 0.0, "dbnames": ",".join(dbnames), "dbkeys": "k"}
    payload = _http(port, "/similarity_search_json", form)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(60)
        c.connect(sock)
        c.sendall(encode_request([(n, "k") for n in dbnames], 31, 8, 0.0,
                                 words[6].view(np.uint8).tobytes()))
        buf = b""
        while True:
            buf += c.recv(1 << 16)
            try:
                rn, approx, smiles, ids, scores = decode_response(buf)
                break
            except Exception:
                continue
    assert rn == 31 and approx == payload["approximate_count"]
    assert [list(r) for r in zip(ids, smiles, scores)] == payload["results"]
    assert "ZINC000006" in ids[0].split(";:;") and scores[0] == 1.0
    assert 'action="/similarity_search"' in _http(port, "/")
    page = _http(port, "/similarity_search",
                 {"smiles": SMILES[6], "dbnames": ",".join(dbnames), "dbkeys": "k"})
    assert page.count("<svg") >= 2
    assert 'href="http://zinc.docking.org/substance/' in page and "ZINC000006" in page


@pytest.mark.parametrize("query", ["CCO", "c1ccccc1", "Cc1ccccc1"])
def test_search_repl_prints_what_the_jax_repl_prints(served, monkeypatch, capsys, query):
    port, _sock = served
    out = {}
    for side, mod in (("jax", __import__("gpusimilarity_tpu.cli.search",
                                         fromlist=["main"])), ("port", psearch)):
        monkeypatch.setattr(sys, "stdin", io.StringIO(f"{query}\n\n"))
        mod.main(["--port", str(port), "--dbnames", "alpha", "--dbkeys", "k",
                  "--return_count", "5"])
        out[side] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert f"  1.0000  ZINC{SMILES.index(query):06d}" in out["port"]


Qual = namedtuple("Qual", "field_name operator value")


@pytest.mark.parametrize("options", [
    {"db_name": "alpha", "dbkey": "k", "max_results": "5"},
    {"db_name": "all", "dbkey": "k", "max_results": "12", "similarity_cutoff": "0.2"},
])
def test_fdw_rows_match_the_jax_fdws(served, options):
    port, _sock = served
    cols = ["id", "query", "smiles", "similarity"]
    rows = {}
    for side, mod in (("jax", jfdw), ("port", pfdw)):
        fdw = mod.TpuSimilarityFDW({"server": "localhost", "port": str(port), **options},
                                   cols)
        rows[side] = [list(fdw.execute([Qual("query", "=", s)], cols))
                      for s in ("CCO", "c1ccccc1")]
        assert list(fdw.execute([], cols)) == []  # no query qual, no rows
        assert list(fdw.execute([Qual("smiles", "=", "CCO")], cols)) == []
    assert rows["port"] == rows["jax"]
    first = rows["port"][0]
    assert len(first) == int(options["max_results"]) or options["db_name"] == "all"
    assert first[0]["smiles"] == "CCO" and first[0]["similarity"] == 1.0


def test_fdw_default_timeout_covers_the_server_deadline():
    from gpusimilarity_tpu_torch.serve.batching import DEFAULT_RESULT_TIMEOUT_S

    fdw = pfdw.TpuSimilarityFDW({"server": "h", "port": "1"}, [])
    assert DEFAULT_RESULT_TIMEOUT_S < fdw.timeout <= DEFAULT_RESULT_TIMEOUT_S + 60
    assert fdw.endpoint == "http://h:1/similarity_search_json_all"
