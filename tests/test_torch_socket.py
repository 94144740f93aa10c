"""PyTorch port: the reference's binary socket protocol, on the CPU.

``gpusimilarity_tpu_torch.serve.socket_server`` must put the same bytes on
the wire as ``gpusimilarity_tpu.serve.socket_server``: the request parser and
the response writer are compared on the same inputs, and two live servers,
one on each package's CPU registry over the same libraries, must answer the
same requests (single- and multi-database, a wrong key) byte for byte, drop
the same corrupt and oversized records and keep serving after them.

The libraries are random, and each request's k and cutoff are chosen so that
no two rows tie at the boundary of a database's top k: the port serves them
from a bitplane store, which may return either of two equal-score boundary
rows (ROADMAP hazard "Tie order"), where the JAX registry scans dense.
"""

import socket

import numpy as np
import pytest

import gpusimilarity_tpu.serve.socket_server as jsock
from gpusimilarity_tpu.models import DatabaseRegistry as JaxRegistry
from gpusimilarity_tpu.models.results import SearchResult as JaxResult
from gpusimilarity_tpu.serve.batching import BatchingSearcher as JaxSearcher
from gpusimilarity_tpu.utils.fsim import FingerprintData as JaxData
from gpusimilarity_tpu.utils.qtstream import QtStreamError as JaxStreamError
from gpusimilarity_tpu_torch.models.registry import DatabaseRegistry
from gpusimilarity_tpu_torch.models.results import SearchResult
from gpusimilarity_tpu_torch.ops.scan import scores_np
from gpusimilarity_tpu_torch.serve import socket_server as psock
from gpusimilarity_tpu_torch.serve.batching import BatchingSearcher
from gpusimilarity_tpu_torch.utils.fsim import FingerprintData
from gpusimilarity_tpu_torch.utils.qtstream import QtStreamError

from tests_socket_helpers import decode_response, encode_request


def _qt_string(b: bytes) -> bytes:
    return len(b + b"\0").to_bytes(4, "big") + b + b"\0"


# name -> a request on the wire, as the reference's front end or a broken
# client writes it
REQUESTS = {
    "one_db": encode_request([("db1", "k1")], 42, 10, 0.5, b"\x01" * 128),
    "two_dbs_empty_key": encode_request([("db1", "k1"), ("db2", "")], 7, 3, 0.0,
                                        bytes(range(128))),
    "unicode_name": encode_request([("bibliothèque", "clé")], -1, 1, 1.0, b"\xff" * 256),
    "negative_cutoff": encode_request([("a", "")], 0, 1_000_000, -0.25, b"\x00" * 128),
    "no_db": encode_request([], 5, 20, 0.3, b"\x10" * 128),
    "trailing_bytes": encode_request([("db1", "")], 1, 5, 0.0, b"\x02" * 128) + b"\x00\x00",
    "dbcount_negative": (-1).to_bytes(4, "big", signed=True),
    "dbcount_4096": (4096).to_bytes(4, "big"),
    "return_count_0": encode_request([("a", "")], 1, 0, 0.0, b"\x00" * 128),
    "return_count_over": encode_request([("a", "")], 1, 1_000_001, 0.0, b"\x00" * 128),
    "null_fingerprint": encode_request([("a", "")], 1, 5, 0.0, b"")[:-4] + b"\xff" * 4,
    "fingerprint_65537": encode_request([("a", "")], 1, 5, 0.0, b"\x00" * 65537),
    "not_nul_terminated": (1).to_bytes(4, "big") + (4).to_bytes(4, "big") + b"abcd",
    "partial": encode_request([("db", "")], 1, 5, 0.0, b"\x00" * 128)[:30],
}


def _outcome(mod, stream_error, raw):
    try:
        return mod.parse_request(raw)
    except stream_error as e:  # partial or corrupt: the framing's concern
        return ("stream", type(e).__name__)
    except ValueError as e:
        return ("value", str(e))


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_parse_request_matches_jax(name):
    """Same parsed fields and bytes consumed, or the same refusal, for valid
    requests and for each bound of ``parse_request``."""
    raw = REQUESTS[name]
    assert _outcome(psock, QtStreamError, raw) == _outcome(jsock, JaxStreamError, raw)


RESULTS = {
    "empty": dict(),
    "one": dict(smiles=["CCO"], ids=["X1"], scores=[0.75], approximate_count=9),
    "merged": dict(smiles=["c1ccccc1", "CCN"], ids=["A;:;B", "ZINC01"],
                   scores=[1.0, np.float32(1) / np.float32(3)],
                   approximate_count=2**40),
    "unicode": dict(smiles=["[Na+].[Cl-]"], ids=["é"], scores=[np.float32(0.1)],
                    approximate_count=1),
}


@pytest.mark.parametrize("name", sorted(RESULTS))
@pytest.mark.parametrize("request_num", [0, 1234, -7])
def test_serialize_response_bytes_match_jax(name, request_num):
    fields = RESULTS[name]
    got = psock.serialize_response(request_num, SearchResult(**fields))
    assert got == jsock.serialize_response(request_num, JaxResult(**fields))
    rn, approx, smiles, ids, scores = decode_response(got)
    assert (rn, approx, smiles, ids) == (
        request_num, fields.get("approximate_count", 0), fields.get("smiles", []),
        fields.get("ids", []))
    assert scores == [float(s) for s in fields.get("scores", [])]


# ------------------------------------------------------------ live servers


def _library(seed, n, dbkey, smiles=None):
    rng = np.random.default_rng(seed)
    fps = np.packbits(rng.random((n, 1024)) < 0.08, axis=1, bitorder="little")
    smiles = smiles or [f"C{'C' * (i % 5)}N{seed}.{i}".encode() for i in range(n)]
    ids = [f"L{seed}-{i:05d}".encode() for i in range(n)]
    return fps, smiles, ids, dbkey


@pytest.fixture(scope="module")
def libraries():
    a = _library(1, 300, "ka")
    # b repeats a's first 40 compounds (SMILES and fingerprints) under other
    # ids: the merge joins their ids
    b = _library(2, 200, "", smiles=a[1][:40] + [f"B{i}".encode() for i in range(160)])
    b[0][:40] = a[0][:40]
    return {"liba": a, "libb": b}


@pytest.fixture(scope="module")
def servers(libraries, tmp_path_factory):
    """A socket server on each package's CPU registry, same libraries."""
    tmp = tmp_path_factory.mktemp("sock")
    preg, jreg = DatabaseRegistry(device="cpu"), JaxRegistry()
    for name, (fps, smiles, ids, key) in libraries.items():
        preg.add(name, FingerprintData(dbkey=key, fingerprints=fps, smiles=smiles, ids=ids))
        jreg.add(name, JaxData(dbkey=key, fingerprints=fps, smiles=smiles, ids=ids))
    searchers = [BatchingSearcher(preg, window_ms=1.0), JaxSearcher(jreg, window_ms=1.0)]
    out = {
        "port": psock.SocketProtocolServer(searchers[0], "port.sock", str(tmp)),
        "jax": jsock.SocketProtocolServer(searchers[1], "jax.sock", str(tmp)),
    }
    for srv in out.values():
        srv.start_background()
    yield out
    for srv in out.values():
        srv.close()
    for s in searchers:
        s.close()


def _tie_free_k(libraries, names, query, want_k, cutoff):
    """The largest k <= ``want_k`` with no tie at any database's boundary."""
    for k in range(want_k, 0, -1):
        ok = True
        for name in names:
            fps = libraries[name][0]
            s = np.sort(scores_np(fps.view(np.uint32), query.view(np.uint32)))[::-1]
            s = s[s >= np.float32(cutoff)]
            if k < len(s) and s[k - 1] == s[k]:
                ok = False
        if ok:
            return k
    raise AssertionError("no tie-free k")


def _exchange(path, payloads):
    """Send each payload on one connection; the raw responses, or None where
    the server closed the connection."""
    out = []
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(60)
        c.connect(path)
        for p in payloads:
            try:
                c.sendall(p)
            except (BrokenPipeError, ConnectionResetError):
                out.append(None)
                break
            buf = b""
            while True:
                try:
                    chunk = c.recv(1 << 16)
                except ConnectionResetError:
                    chunk = b""
                if not chunk:
                    out.append(None)
                    return out
                buf += chunk
                try:
                    decode_response(buf)
                except Exception:
                    continue
                out.append(buf)
                break
    return out


# name -> (databases with keys, query library and row, k, cutoff)
LIVE = {
    "single_self": ((("liba", "ka"),), "liba", 5, 10, 0.0),
    "single_cutoff": ((("liba", "ka"),), "liba", 17, 50, 0.2),
    "keyless_db": ((("libb", ""),), "libb", 3, 8, 0.0),
    "two_dbs_merged": ((("liba", "ka"), ("libb", "")), "libb", 7, 30, 0.05),
    "two_dbs_reversed": ((("libb", ""), ("liba", "ka")), "liba", 12, 12, 0.0),
    "wrong_key": ((("liba", "nope"),), "liba", 1, 10, 0.0),
    "unknown_db": ((("nosuch", ""),), "liba", 1, 10, 0.0),
}


@pytest.mark.parametrize("name", sorted(LIVE))
def test_live_servers_answer_byte_identically(servers, libraries, name):
    dbs, qlib, qrow, want_k, cutoff = LIVE[name]
    query = libraries[qlib][0][qrow]
    k = _tie_free_k(libraries, [d for d, _ in dbs if d in libraries], query, want_k, cutoff)
    payload = encode_request(list(dbs), 100 + qrow, k, cutoff, query.tobytes())
    got = {side: _exchange(srv.path, [payload, payload]) for side, srv in servers.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][1]  # sequential requests, one connection
    rn, approx, smiles, ids, scores = decode_response(got["port"][0])
    assert rn == 100 + qrow
    if name in ("wrong_key", "unknown_db"):
        assert (approx, ids) == (0, [])
    else:
        assert scores[0] == 1.0 and len(scores) <= k
    if name == "two_dbs_merged":
        assert any(";:;" in i for i in ids)


BROKEN = {
    # a complete record whose first string lacks its NUL
    "corrupt": (1).to_bytes(4, "big") + (4).to_bytes(4, "big") + b"liba"
    + _qt_string(b"ka") + (1).to_bytes(4, "big") * 2 + bytes(8)
    + (128).to_bytes(4, "big") + bytes(128),
    # a fingerprint length prefix of 1 GiB: buffered to 16 MiB, then dropped
    "oversize_prefix": (1).to_bytes(4, "big") + _qt_string(b"liba") + _qt_string(b"ka")
    + (1).to_bytes(4, "big") * 2 + bytes(8) + (1 << 30).to_bytes(4, "big")
    + bytes(17 << 20),
    "malformed_count": encode_request([("liba", "ka")], 1, 0, 0.0, bytes(128)),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_requests_drop_the_connection_and_the_server_keeps_serving(
        servers, libraries, name):
    good = encode_request([("liba", "ka")], 9, 3, 0.0, libraries["liba"][0][9].tobytes())
    for side, srv in servers.items():
        assert _exchange(srv.path, [BROKEN[name], good]) == [None], side
        [answer] = _exchange(srv.path, [good])
        assert decode_response(answer)[3][0] == "L1-00009", side
