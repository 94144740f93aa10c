"""PyTorch port: the server's start-up warm-up against the JAX package's, on
the CPU (twin of ``gpusimilarity_tpu/models/fingerprint_db.py``'s
``_synthetic_query``/``_warmup_queries``/``warmup``,
``models/registry.py``'s ``warmup`` and ``cli/server.py``'s warm-up flags).

Pinned here, on libraries made from a numpy seed (bitplane unfolded,
bitplane fold 4, dense fold 4, and a virtual bitplane library without host
rows):

* ``_warmup_queries`` is bit-equal to the JAX engine's;
* ``warmup`` runs the JAX engine's searches, queries x batches x ks in its
  order, and leaves the registry's ``searches`` unchanged;
* ``cli.server`` warms with the JAX server's defaults, ``--no_warmup`` runs
  none and ``--warmup_batch`` above ``--max_batch`` is clamped; its parser
  takes the JAX server's warm-up flags with the same defaults;
* a server subprocess logs ``warmed up <name>`` before its ready line, and
  a SIGINT sent the moment the ready line appears exits 0, five starts in a
  row.
"""

import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import jax

from gpusimilarity_tpu.cli import server as jax_server
from gpusimilarity_tpu.models import FingerprintDB as JaxDB
from gpusimilarity_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gpusimilarity_tpu.utils import synth as jsynth
from gpusimilarity_tpu.utils.fsim import FingerprintData as JaxData
from gpusimilarity_tpu_torch.cli import server as port_server
from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.utils import synth
from gpusimilarity_tpu_torch.utils.fsim import FingerprintData, write_fsim

REPO = Path(__file__).resolve().parents[1]
N_ROWS = 3000


def _two_density_data(n=N_ROWS, seed=11):
    """Rows whose first half is sparse (5%) and second half dense (15%), so
    the sampled p50 and p95 popcounts fall in different plane buckets."""
    rng = np.random.default_rng(seed)
    density = np.where(np.arange(n) < n // 2, 0.05, 0.15)[:, None]
    bits = rng.random((n, 1024)) < density
    return FingerprintData(
        dbkey="w", bitcount=1024,
        fingerprints=np.packbits(bits, axis=1, bitorder="little"),
        smiles=[f"C{i}".encode() for i in range(n)],
        ids=[f"W{i:05d}".encode() for i in range(n)],
    )


def _virtual_pair():
    """A virtual bitplane library on one JAX device and its port twin,
    neither keeping host rows (``_full_words`` is None)."""
    n = jsynth.aligned_virtual_rows(20000, 1, with_pops3=False)
    strings = [b"C"] * n
    port = FingerprintData(
        dbkey="w", bitcount=1024,
        fingerprints=synth.VirtualFingerprints(n, 1024, seed=4),
        smiles=strings, ids=strings)
    jax_data = JaxData(
        dbkey="w", bitcount=1024,
        fingerprints=jsynth.VirtualFingerprints(n, 1024, seed=4),
        smiles=strings, ids=strings)
    return port, jax_data


# name -> (scan_mode, fold)
LIBRARIES = {
    "bitplane": ("bitplane", 1),
    "bitplane_fold4": ("bitplane", 4),
    "dense_fold4": ("dense", 4),
    "virtual": ("bitplane", 1),
}


def _pair(name):
    mode, fold = LIBRARIES[name]
    if name == "virtual":
        data, jdata = _virtual_pair()
        kw = {"keep_full_on_host": False}
    else:
        data = jdata = _two_density_data()
        kw = {}
    db = FingerprintDB(data, device="cpu", scan_mode=mode, fold_factor=fold, **kw)
    jdb = JaxDB(jdata, mesh=jax_make_mesh(jax.devices()[:1]), scan_mode=mode,
                fold_factor=fold, **kw)
    return db, jdb


@pytest.fixture(scope="module", params=sorted(LIBRARIES))
def pair(request):
    return request.param, *_pair(request.param)


def _recorded(db, monkeypatch):
    """Wrap ``db.search_batch`` to record ``(queries, k, results)``."""
    calls = []
    real = db.search_batch

    def record(queries, k=20, *a, **kw):
        results = real(queries, k, *a, **kw)
        calls.append((np.array(queries, copy=True), k, results))
        return results

    monkeypatch.setattr(db, "search_batch", record)
    return calls


def test_warmup_queries_are_bit_equal_to_jax(pair):
    name, db, jdb = pair
    got, want = db._warmup_queries(), jdb._warmup_queries()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and g.shape == (32,)
        np.testing.assert_array_equal(g, w)
    if name == "virtual":
        assert db._full_words is None and len(got) == 2  # 48 bits, and 128
    elif LIBRARIES[name][0] == "bitplane":
        assert len(got) >= 3  # row 0 and the buckets of the two densities
    else:
        assert len(got) == 1  # dense: row 0 only
    for n_set in (1, 48, 64, 256):
        np.testing.assert_array_equal(db._synthetic_query(n_set),
                                      jdb._synthetic_query(n_set))


def test_warmup_runs_the_jax_searches_and_counts_none(pair, monkeypatch):
    """Queries x batches x ks searches, in the JAX engine's order (its
    searches recorded, not run), through the registry's ``warmup``, which
    leaves ``searches`` at 0; every warm-up answer is a real one."""
    name, db, jdb = pair
    ks, max_batch = (20, 128), 8
    jax_calls = []
    monkeypatch.setattr(jdb, "search_batch", lambda q, k=20, **kw: jax_calls.append(
        (np.array(q, copy=True), k)))
    jdb.warmup(ks=ks, max_batch=max_batch)

    reg = DatabaseRegistry(device="cpu")
    reg._dbs[name] = db
    calls = _recorded(db, monkeypatch)
    reg.warmup(ks=ks, max_batch=max_batch)

    n_queries = len(db._warmup_queries())
    assert len(calls) == n_queries * 4 * len(ks) == len(jax_calls)
    for (q, k, results), (jq, jk) in zip(calls, jax_calls):
        assert k == jk
        np.testing.assert_array_equal(q, jq)
        assert len(results) == len(q) and results[0].scores
    assert [len(q) for q, _, _ in calls[:8]] == [1, 1, 2, 2, 4, 4, 8, 8]
    assert reg.stats()["searches"] == 0 and reg.search_count == 0


def test_warmup_of_an_empty_library_runs_nothing(monkeypatch):
    empty = FingerprintData(dbkey="", bitcount=1024,
                            fingerprints=np.zeros((0, 128), np.uint8),
                            smiles=[], ids=[])
    db = FingerprintDB(empty, device="cpu")
    calls = _recorded(db, monkeypatch)
    db.warmup(ks=(20,), max_batch=8)
    assert calls == []


# ----------------------------------------------------------- cli.server flags


def test_parse_args_takes_the_jax_warmup_flags_with_its_defaults():
    for argv in (["x.fsim"],
                 ["x.fsim", "--no_warmup", "--warmup_batch", "32",
                  "--warmup_ks", "128"]):
        got, want = port_server.parse_args(argv), jax_server.parse_args(argv)
        for flag in ("no_warmup", "warmup_batch", "warmup_ks", "max_batch"):
            assert getattr(got, flag) == getattr(want, flag), flag
    args = port_server.parse_args(["x.fsim"])
    assert (args.no_warmup, args.warmup_batch, args.warmup_ks) == (False, 8, "20,128")
    assert port_server.warmup_ks(args) == (20, 128)
    assert port_server.warmup_ks(port_server.parse_args(
        ["x.fsim", "--warmup_ks", "5, 64,"])) == (5, 64)
    for refused in ("--pallas", "--jax_profiler_port=1", "--jax_cache_dir=x"):
        with pytest.raises(SystemExit):
            port_server.parse_args(["x.fsim", refused])


class _StopAtOnce:
    """A ``SimilarityServer`` stand-in whose loop is interrupted at once."""

    def __init__(self, registry, **kw):
        self.port = 0
        self.closed = False

    def serve_forever(self):
        raise KeyboardInterrupt

    def close(self):
        self.closed = True


@pytest.fixture
def small_fsim(tmp_path):
    path = tmp_path / "smoke.fsim"
    write_fsim(path, _two_density_data(n=600))
    return path


@pytest.mark.parametrize("argv,want", [
    ((), ((20, 128), 8)),
    (("--no_warmup",), None),
    (("--warmup_batch", "100", "--max_batch", "16"), ((20, 128), 16)),
    (("--warmup_batch", "1", "--warmup_ks", "128"), ((128,), 1)),
])
def test_server_main_warms_as_the_jax_server(small_fsim, monkeypatch, argv, want):
    """``main`` calls ``registry.warmup(ks, min(--warmup_batch,
    --max_batch))`` before it serves, or not at all with ``--no_warmup``."""
    import gpusimilarity_tpu_torch.serve.server as serve_mod

    seen = []
    monkeypatch.setattr(serve_mod, "SimilarityServer", _StopAtOnce)
    monkeypatch.setattr(DatabaseRegistry, "warmup",
                        lambda self, ks, max_batch: seen.append((tuple(ks), max_batch)))
    port_server.main([str(small_fsim), "--cpu_only", *argv])
    assert seen == ([] if want is None else [want])


# ------------------------------------------------------- the server process


@pytest.mark.parametrize("attempt", range(5))
def test_sigint_at_the_ready_line_exits_0_after_warmup(small_fsim, attempt):
    """The server logs ``warmed up smoke (<s>s)`` before ``tpusimilarity
    ready on``, and a SIGINT sent the moment the ready line appears closes it
    with exit code 0 (the ready line's write sits inside the server's
    ``try``)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server",
         str(small_fsim), "--port", "0", "--cpu_only"],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True, env=env,
        cwd=REPO,
    )
    seen = []
    deadline = threading.Timer(120, proc.kill)  # a server that never gets ready
    deadline.start()
    try:
        for line in proc.stderr:
            seen.append(line)
            if "tpusimilarity ready on" in line:
                proc.send_signal(signal.SIGINT)
                break
        rc = proc.wait(timeout=60)
    finally:
        deadline.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = "".join(seen)
    assert rc == 0, text[-2000:]
    warmed = [i for i, ln in enumerate(seen) if "warmed up smoke (" in ln]
    ready = [i for i, ln in enumerate(seen) if "tpusimilarity ready on" in ln]
    assert warmed and ready and warmed[0] < ready[0], text[-2000:]
