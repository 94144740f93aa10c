"""PyTorch port: multi-process serving over a gloo process group, on the CPU
(modelled on ``tests/test_multihost.py``).

Each subprocess imports only the port: it joins a 2-process job
(``parallel.multihost.initialize``), serves two CPU shards of its own, and
prints its answers. Pinned here:

* the engine on two processes (dense, bitplane, fold 4 with the full-width
  rescore) equals the JAX engine on one process; each process read only its
  span (``loaded_fp_bytes``), and the ``.fsim`` string tables, held in RAM,
  are cut to the process's span and resolved across processes (a 700-byte
  SMILES on the other process's span included);
* a shard search that fails on one process fails the request on both, and
  the next request succeeds on both (no process is left in a collective);
* two ``cli.server`` processes with ``--coordinator`` answer HTTP and the
  reference's socket protocol byte for byte like one JAX server process,
  each fed half the library, and shut down cleanly together;
* the controller's unit tests of the JAX package (``:601-706``), on the
  port's controller.

Every subprocess has a timeout of 120 s or less, a fresh port and
``OMP_NUM_THREADS=1``.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from gpusimilarity_tpu_torch.models.registry import resolve_scan_mode
from gpusimilarity_tpu_torch.ops.scan import scores_np
from gpusimilarity_tpu_torch.parallel import multihost, sharded
from gpusimilarity_tpu_torch.parallel.multihost import MultihostController
from gpusimilarity_tpu_torch.utils.fsim import FingerprintData, write_fsim
from gpusimilarity_tpu_torch.utils.strings import ConstantStringTable
from gpusimilarity_tpu_torch.utils.tfsim import load_any, save_native

from tests_socket_helpers import decode_response, encode_request

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
N_ROWS = 12000
LONG_ROW = 9000  # on process 1's span; its SMILES is 700 bytes
QUERY_ROWS = [7, 3000, LONG_ROW, N_ROWS - 1]

ENGINE_WORKER = r"""
import json, sys
pid, port, path, mode, fold = sys.argv[1:6]
pid, fold = int(pid), int(fold)
import numpy as np
from gpusimilarity_tpu_torch.models.fingerprint_db import FingerprintDB
from gpusimilarity_tpu_torch.parallel import multihost, sharded
from gpusimilarity_tpu_torch.parallel.mesh import make_mesh
from gpusimilarity_tpu_torch.utils.tfsim import load_any

multihost.initialize(f"127.0.0.1:{port}", 2, pid)
mesh = make_mesh(["cpu"] * 2)  # two shards a process, four in all
data = load_any(path)
db = FingerprintDB(data, mesh=mesh, scan_mode=mode, fold_factor=fold)
words = data.packed_words()
rows = json.loads(sys.argv[6])
res = db.search_batch(words[rows], [5, 20, 1, 50], [0.0, 0.1, 0.0, 0.05],
                      data.dbkey, return_indices=True)

# a shard search that fails on process 1 fails the request everywhere...
local = sharded.dense_local_topk if mode == "dense" else sharded.bitplane_local_topk
def boom(*a, **k):
    raise RuntimeError("injected shard failure")
if pid == 1:
    setattr(sharded, local.__name__, boom)
try:
    db.search(words[7], 5, 0.0, data.dbkey)
    failed = None
except RuntimeError as e:
    failed = str(e)
setattr(sharded, local.__name__, local)
# ...and the next one succeeds everywhere
after = db.search(words[7], 5, 0.0, data.dbkey, return_indices=True).indices

print("RESULT " + json.dumps({
    "pid": pid, "shards": db.store.n_shards, "row0s": list(db.store.row0s),
    "loaded_fp_bytes": db.loaded_fp_bytes,
    "strings": [type(db._smiles).__name__, type(db._ids).__name__],
    "results": [[r.ids, r.smiles, r.scores, r.indices, r.approximate_count]
                for r in res],
    "failed": failed, "after": after,
}), flush=True)
multihost.finalize()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _library(n=N_ROWS, seed=77):
    rng = np.random.default_rng(seed)
    bits = rng.random((n, 1024), dtype=np.float32) < 0.1
    smiles = [f"SMI{i:05d}".encode() for i in range(n)]
    if n > LONG_ROW:
        smiles[LONG_ROW] = b"C" * 700
    return FingerprintData(
        dbkey="mh", bitcount=1024,
        fingerprints=np.packbits(bits, axis=1, bitorder="little"),
        smiles=smiles, ids=[f"ID{i:05d}".encode() for i in range(n)],
    )


@pytest.fixture(scope="module")
def fsim_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("mh") / "mh.fsim"
    write_fsim(path, _library())
    return path


def _run_pair(args_for, timeout=TIMEOUT_S, env=None):
    """Start the two processes of a job, wait for both; their outputs."""
    procs = [
        subprocess.Popen(args_for(pid), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, cwd=REPO,
                         env=env or _env())
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
    return outs


def _result(out):
    [line] = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("mode,fold", [("dense", 1), ("bitplane", 1), ("dense", 4)])
def test_two_process_engine_equals_jax_on_one_process(tmp_path, fsim_path, mode, fold):
    from gpusimilarity_tpu.models import FingerprintDB as JaxDB
    from gpusimilarity_tpu.utils.fsim import read_fsim

    script = tmp_path / "worker.py"
    script.write_text(ENGINE_WORKER)
    port = _free_port()
    outs = _run_pair(lambda pid: [
        sys.executable, str(script), str(pid), str(port), str(fsim_path), mode,
        str(fold), json.dumps(QUERY_ROWS)])
    got = [_result(o) for o in outs]

    jdata = read_fsim(str(fsim_path))
    words = jdata.packed_words()
    want = JaxDB(jdata, scan_mode=mode, fold_factor=fold).search_batch(
        words[QUERY_ROWS], [5, 20, 1, 50], [0.0, 0.1, 0.0, 0.05], "mh",
        return_indices=True)
    full = scores_np(words, words[QUERY_ROWS])
    spans = sharded.plan_shard_spans(N_ROWS, 4, sharded.shard_align(mode))
    for pid, g in enumerate(got):
        assert g["shards"] == 4
        mine = spans[2 * pid:2 * pid + 2]
        assert g["row0s"] == [lo for lo, _ in mine]
        assert g["loaded_fp_bytes"] == sum(hi - lo for lo, hi in mine) * 128
        assert g["strings"] == ["HostStrings", "HostStrings"]
        assert g["failed"] in ("injected shard failure",
                               "a shard search failed on another process")
        assert g["after"][0] == 7
        assert g["results"] == got[0]["results"]  # replicated
    assert got[0]["failed"] != got[1]["failed"]
    for qi, ((ids, smiles, scores, idx, approx), w) in enumerate(
            zip(got[0]["results"], want)):
        assert approx == w.approximate_count
        assert scores == w.scores
        assert idx[0] == QUERY_ROWS[qi] and scores[0] == 1.0
        if mode == "dense":
            assert (ids, smiles, idx) == (w.ids, w.smiles, w.indices)
        else:  # either equal-score boundary row; each index carries its score
            assert [float(full[qi][i]) for i in idx] == scores
            assert ids == [f"ID{i:05d}" for i in idx]
    assert got[0]["results"][2][1][0] == "C" * 700


def test_strings_are_host_sharded_only_when_held_in_ram(tmp_path, fsim_path):
    """``.fsim`` tables live in RAM and are cut to a process's span; a
    ``.tfsim``'s are memory-mapped and stay whole; constant tables too."""
    fsim = load_any(str(fsim_path))
    assert multihost.needs_host_sharding(fsim.smiles)
    assert multihost.needs_host_sharding([b"a", b"b"])
    tfsim_path = tmp_path / "mh.tfsim"
    save_native(tfsim_path, fsim)
    tfsim = load_any(str(tfsim_path))
    assert not multihost.needs_host_sharding(tfsim.smiles)
    assert not multihost.needs_host_sharding(tfsim.ids)
    assert not multihost.needs_host_sharding(ConstantStringTable(b"C", 10))


# ------------------------------------------------------------- server stack


def _post_raw(port, fields):
    body = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/similarity_search_json", data=body)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _exchange(path, payloads):
    out = []
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(60)
        c.connect(str(path))
        for p in payloads:
            c.sendall(p)
            buf = b""
            while True:
                chunk = c.recv(1 << 16)
                assert chunk, "the server closed the socket"
                buf += chunk
                try:
                    decode_response(buf)
                except Exception:
                    continue
                out.append(buf)
                break
    return out


def _tie_free_k(words, q, want_k, cutoff):
    s = np.sort(scores_np(words, q[None])[0])[::-1]
    s = s[s >= np.float32(cutoff)]
    for k in range(want_k, 0, -1):
        if k >= len(s) or s[k - 1] != s[k]:
            return k
    raise AssertionError("no tie-free k")


def _pump(proc, lines, event, marker):
    for line in proc.stderr:
        lines.append(line)
        if marker in line:
            event.set()


def test_two_process_server_stack_answers_like_one_jax_server(tmp_path):
    """Two ``cli.server --coordinator`` processes on one ``.fsim``: process 0
    answers HTTP and the socket byte for byte like a one-process JAX server,
    its ``/stats`` reports two shards, each process was fed its half, and
    SIGINT to process 0 shuts both down cleanly."""
    from gpusimilarity_tpu.models import DatabaseRegistry as JaxRegistry
    from gpusimilarity_tpu.serve.server import SimilarityServer as JaxServer

    n = 4096
    data = _library(n, seed=99)
    path = tmp_path / "mh.fsim"
    write_fsim(path, data)
    words = data.packed_words()
    sock_dir = tmp_path / "s"
    sock_dir.mkdir()

    coord = _free_port()
    procs, lines, ready = [], [[], []], [threading.Event(), threading.Event()]
    for pid in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gpusimilarity_tpu_torch.cli.server",
             str(path), "--cpu_only", "--port", "0", "--socket_name", "mh.sock",
             "--coordinator", f"127.0.0.1:{coord}", "--num_processes", "2",
             "--process_id", str(pid)],
            stderr=subprocess.PIPE, text=True, cwd=REPO,
            env=_env(TMPDIR=str(sock_dir))))
        threading.Thread(target=_pump, daemon=True, args=(
            procs[pid], lines[pid], ready[pid],
            "ready on" if pid == 0 else "worker 1 ready")).start()
    jreg = JaxRegistry.from_fsim_files([str(path)])
    jsrv = JaxServer(jreg, port=0, socket_name="jax.sock")
    jsrv.start_background()
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not all(e.is_set() for e in ready):
            assert all(p.poll() is None for p in procs), "".join(lines[0] + lines[1])
            assert time.monotonic() < deadline, "servers not ready"
            time.sleep(0.2)
        port = int(re.search(r"ready on [^:]+:(\d+)", "".join(lines[0])).group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["databases"]["mh"]["shards"] == 2
        assert stats["processes"] == 2

        forms = []
        for row, want_k, cut in ((3000, 10, 0.0), (17, 30, 0.12)):
            k = _tie_free_k(words, words[row], want_k, cut)
            forms.append({"fp_hex": words[row].view(np.uint8).tobytes().hex(),
                          "return_count": k, "similarity_cutoff": cut,
                          "dbnames": "mh", "dbkeys": "mh"})
        forms.append({**forms[0], "dbkeys": "wrong"})
        for form in forms:
            assert _post_raw(port, form) == _post_raw(jsrv.port, form)
        payloads = [
            encode_request([("mh", "mh")], 40 + i, _tie_free_k(words, words[r], 15, 0.0),
                           0.0, words[r].tobytes())
            for i, r in enumerate((5, 4095))
        ]
        got = _exchange(sock_dir / "mh.sock", payloads)
        assert got == _exchange(jsrv.socket_server.path, payloads)
        assert decode_response(got[1])[3][0] == "ID04095"
    finally:
        jsrv.close()
        procs[0].send_signal(signal.SIGINT)
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for pid, p in enumerate(procs):
        assert p.returncode == 0, "".join(lines[pid][-30:])
        fed = re.search(r"worker \d: mh fed (\d+) fp bytes", "".join(lines[pid]))
        assert fed and int(fed.group(1)) == n // 2 * 128


# ------------------------------------------------- controller unit tests
# (one process: the broadcast is the identity, which pins the lifecycle and
# template logic without a process group)


class _FakeDB:
    word_count = 32


class _FakeRegistry:
    def __init__(self, names):
        self._names = list(names)

    def names(self):
        return list(self._names)

    def get(self, name):
        return _FakeDB()

    def _execute_batch(self, *a, **k):
        return []


def test_controller_max_dbs_defaults_to_registry_count():
    c = MultihostController(_FakeRegistry([f"db{i}" for i in range(12)]))
    assert c.max_dbs == 12
    assert c._template()["db_idx"].shape == (12,)
    # an empty registry still broadcasts one (unused) slot
    assert MultihostController(_FakeRegistry([])).max_dbs == 1


def test_controller_dispatch_after_shutdown_fails_fast():
    c = MultihostController(_FakeRegistry(["db0"]))
    c.shutdown()
    c.shutdown()  # idempotent: no second broadcast, no error
    with pytest.raises(RuntimeError, match="shut down"):
        c.dispatch_batch(["db0"], [True], np.zeros((1, 32), np.uint32), [5],
                         [0.0], "tanimoto", 1.0, 1.0)


def test_serve_worker_survives_failing_request():
    class _BoomRegistry(_FakeRegistry):
        def __init__(self, names):
            super().__init__(names)
            self.calls = 0

        def _execute_batch(self, *a, **k):
            self.calls += 1
            raise RuntimeError("boom")

    reg = _BoomRegistry(["db0"])
    c = MultihostController(reg)
    search = c._template()
    search["meta"][:] = (multihost._OP_SEARCH, 1, 0)
    search["db_idx"][0] = 0
    search["key_ok"][0] = 1
    stop = c._template()  # zero meta == shutdown
    seq = iter([search, stop])
    c._broadcast = lambda payload: next(seq)  # shadow the collective
    c.serve_worker()  # returns via the shutdown op, exception logged
    assert reg.calls == 1


def test_resolve_strings_many_splits_pairs_in_one_collective():
    a = multihost.HostStrings([b"a0", b"a1"], 0, 4)
    b = multihost.HostStrings([b"b2", b"b3"], 2, 4)
    out = multihost.resolve_strings_many([(a, [0, 1, 3]), (b, [2, 0]), (a, [])])
    assert out == [[b"a0", b"a1", b""], [b"b2", b""], []]
    assert multihost.resolve_strings_many([(a, []), (b, [])]) == [[], []]
    assert multihost.resolve_strings(a, [1, 2]) == [b"a1", b""]


def test_dispatch_batch_executes_with_broadcast_roundtripped_values():
    class _Recorder(_FakeRegistry):
        def __init__(self, names):
            super().__init__(names)
            self.seen = None

        def _execute_batch(self, dbnames, key_oks, queries, ks, cutoffs,
                           similarity, alpha, beta):
            self.seen = (list(ks), list(cutoffs), alpha, beta)
            return ["ok"]

    reg = _Recorder(["db0"])
    c = MultihostController(reg, max_batch=4)
    c.dispatch_batch(["db0"], [True], np.zeros((1, 32), np.uint32), [5], [0.3],
                     "tversky", 0.3, 0.7)
    ks, cutoffs, alpha, beta = reg.seen
    assert ks == [5]
    assert cutoffs == [float(np.float32(0.3))] != [0.3]
    assert alpha == float(np.float32(0.3)) != 0.3
    assert beta == float(np.float32(0.7)) != 0.7


def test_resolve_scan_mode_allows_multihost_bitplane():
    """Each process builds its own shards' planes, so a multi-process
    library resolves as a one-process one: bitplane unfolded, dense
    folded."""
    assert resolve_scan_mode("auto", 1) == "bitplane"
    assert resolve_scan_mode("auto", 4) == "dense"


def test_initialize_refuses_a_bad_coordinator():
    with pytest.raises(ValueError, match="host:port"):
        multihost.initialize("localhost", 2, 0)
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("127.0.0.1:1", 2, 2)
