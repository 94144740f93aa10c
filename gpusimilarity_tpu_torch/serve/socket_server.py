"""Reference-compatible local-socket backend protocol (twin of
``gpusimilarity_tpu/serve/socket_server.py``, the same bytes on the wire).

The reference front end talks to its C++ backend over a QLocalSocket named
"gpusimilarity" with a QDataStream wire format (request serialization at
``gpusim_server.py:76-92``, backend decode/respond at ``gpusim.cpp:376-454``).
This module speaks that exact protocol over the same Unix socket path, so the
reference's own clients (``gpusim_search.py``, its HTTP front end, or any
in-house integration built on the socket) can point at this backend unchanged.

Wire format (big-endian, QDataStream Qt_5_2 — floats travel as 8-byte
doubles at this version):

request::

    int32 dbcount; dbcount x { writeString dbname; writeString dbkey; }
    int32 request_num; int32 return_count; float64 similarity_cutoff;
    QByteArray fingerprint (packed bits)

response::

    int32 request_num; int32 return_count; uint64 approximate_count;
    return_count x writeString smiles; return_count x writeString id;
    return_count x float64 score

One connection carries sequential requests (the reference serializes on the
client side); each connection gets its own handler thread here, and searches
still flow through the batching engine: a handler thread only enqueues its
request on the :class:`BatchingSearcher`, which runs the device work. Each
request is a :class:`~.spans.Request` from its parse to its reply's last
byte, counted as an HTTP request is.
"""

from __future__ import annotations

import logging
import os
import socketserver
import threading

import numpy as np

from ..models.results import SearchResult
from ..utils.qtstream import (
    QtStreamCorruptError,
    QtStreamError,
    QtStreamReader,
    QtStreamWriter,
)
from . import spans
from .batching import BatchingSearcher

log = logging.getLogger("tpusimilarity.socket")

DEFAULT_SOCKET_NAME = "gpusimilarity"


def parse_request(buf: bytes):
    """Parse one request; returns (parsed dict, bytes consumed).

    Raises QtStreamError if the buffer does not yet hold a full request.
    """
    r = QtStreamReader(buf)
    dbcount = r.read_int32()
    if not 0 <= dbcount < 4096:
        raise ValueError(f"implausible dbcount {dbcount}")
    names, keys = [], []
    for _ in range(dbcount):
        names.append((r.read_string() or b"").decode("utf-8"))
        keys.append((r.read_string() or b"").decode("utf-8"))
    request_num = r.read_int32()
    return_count = r.read_int32()
    if not 1 <= return_count <= 1_000_000:
        # same resource guard as the HTTP layer: a huge (or negative) k
        # would run a full-library top-k on behalf of any local client
        raise ValueError(f"implausible return_count {return_count}")
    cutoff = r.read_double()
    fp = r.read_bytearray()
    if fp is None:
        raise ValueError("null fingerprint")
    if len(fp) > 1 << 16:
        raise ValueError(f"implausible fingerprint size {len(fp)}")
    return (
        {
            "dbnames": names,
            "dbkeys": keys,
            "request_num": request_num,
            "return_count": return_count,
            "cutoff": cutoff,
            "fingerprint": fp,
        },
        r.pos,
    )


def serialize_response(request_num: int, result) -> bytes:
    w = QtStreamWriter()
    w.write_int32(request_num)
    w.write_int32(len(result.scores))
    w.write_uint64(result.approximate_count)
    for s in result.smiles:
        w.write_string(s.encode("utf-8"))
    for i in result.ids:
        w.write_string(i.encode("utf-8"))
    for sc in result.scores:
        w.write_double(float(sc))
    return w.getvalue()


class SocketProtocolServer:
    """Unix-socket server speaking the reference backend protocol."""

    def __init__(
        self,
        searcher: BatchingSearcher,
        socket_name: str = DEFAULT_SOCKET_NAME,
        socket_dir: str | None = None,
    ):
        self.searcher = searcher
        socket_dir = socket_dir or os.environ.get("TMPDIR", "/tmp")
        self.path = os.path.join(socket_dir, socket_name)
        if os.path.exists(self.path):
            # stale socket from a dead server: remove and rebind, mirroring
            # the reference's retry (gpusim.cpp:255-274)
            os.unlink(self.path)

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                buf = b""
                while True:
                    start = spans.now()
                    try:
                        req, used = parse_request(buf)
                    except QtStreamCorruptError as e:
                        # complete-but-invalid record: more bytes can never
                        # fix it, so drop the connection now instead of
                        # recv-looping toward the 16 MiB cap in silence
                        log.warning("corrupt socket request dropped: %s", e)
                        return
                    except QtStreamError:
                        if len(buf) > 16 << 20:
                            # a bogus length prefix would otherwise make us
                            # buffer gigabytes before ever failing
                            log.warning("oversized socket request dropped")
                            return
                        chunk = self.request.recv(1 << 20)
                        if not chunk:
                            return
                        buf += chunk
                        continue
                    except ValueError as e:
                        log.warning("malformed socket request: %s", e)
                        return
                    buf = buf[used:]
                    outer._serve_one(self.request, req, spans.Request(start))

        class Server(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
            daemon_threads = True

        self.server = Server(self.path, Handler)
        self._thread: threading.Thread | None = None

    def _serve_one(self, conn, req, request: spans.Request):
        query = np.frombuffer(req["fingerprint"], dtype=np.uint8)
        try:
            query_words = query.view(np.uint32)
            result = self.searcher.search(
                req["dbnames"],
                req["dbkeys"],
                query_words,
                k=req["return_count"],
                cutoff=req["cutoff"],
                request=request,
            )
        except Exception:
            log.exception("socket search failed")
            result = SearchResult()
        conn.sendall(serialize_response(req["request_num"], result))
        spans.replied(self.searcher.registry.counters, request)

    def start_background(self):
        self._thread = threading.Thread(
            target=self.server.serve_forever, name="gpusim-socket", daemon=True
        )
        self._thread.start()
        log.info("socket protocol server listening on %s", self.path)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        if os.path.exists(self.path):
            os.unlink(self.path)
        if self._thread:
            self._thread.join(timeout=5)
