"""HTTP/JSON similarity-search service (twin of
``gpusimilarity_tpu/serve/server.py``), with the same wire contract:

* ``POST /similarity_search_json[_<db>]`` with form fields ``smiles`` (or
  ``fp_hex``), ``return_count``, ``similarity_cutoff``, ``dbnames`` and
  ``dbkeys`` (comma-separated), plus the extensions ``similarity``
  (``tanimoto``/``tversky``), ``alpha`` and ``beta`` → JSON
  ``{"approximate_count": N, "results": [[id, smiles, score], ...]}``.
  The URL suffix names the databases for clients that post no ``dbnames``;
  ``all`` means every loaded database.
* ``GET /healthz`` and ``GET /stats`` (which also reports the kernels'
  launch counts and the batched passes).
* ``POST /similarity_search`` + ``GET /`` serve a debug HTML UI when enabled
  (the reference's ``--http_interface`` mode).
* ``socket_name`` also serves the reference's binary local-socket protocol
  (:mod:`.socket_server`) beside HTTP.

HTTP and socket handler threads only enqueue on one
:class:`BatchingSearcher`, which runs every search on the device. Each HTTP
POST is a :class:`~.spans.Request` whose parse, batch wait and reply add
into the registry's counters (``/stats``); while a capture's window is open
(:mod:`.profiler`) it also runs inside a ``tpusim.request`` profiler span,
so a trace shows what a request spends around its search pass.
"""

from __future__ import annotations

import html
import json
import logging
import threading
import urllib.parse
from concurrent.futures import TimeoutError as FuturesTimeoutError
from email.parser import BytesParser
from email.policy import HTTP as HTTP_POLICY
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..models.registry import DatabaseRegistry
from ..ops.scan import TANIMOTO, TVERSKY
from ..utils.fingerprints import (
    BITCOUNT,
    FingerprintError,
    compatible_generators,
    fingerprint_bin_to_words,
    generator_tag,
    smiles_to_query_words,
)
from . import spans
from .batching import DEFAULT_RESULT_TIMEOUT_S, BatchingSearcher
from .profiler import REQUEST_SPAN

# request-size guard: the largest top-k a client may ask for
MAX_RETURN_COUNT = 10_000

log = logging.getLogger("tpusimilarity.http")


class RequestError(ValueError):
    """400-class client error."""


def parse_form(content_type: str, body: bytes) -> dict[str, str]:
    """Parse a POST body: urlencoded, JSON or multipart/form-data."""
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct in ("application/x-www-form-urlencoded", ""):
        return {k: v[-1] for k, v in parse_qs(body.decode("utf-8", "replace")).items()}
    if ct == "application/json":
        try:
            data = json.loads(body.decode("utf-8"))
        except json.JSONDecodeError as e:
            raise RequestError(f"bad JSON body: {e}") from e
        if not isinstance(data, dict):
            raise RequestError("JSON body must be an object")
        return {str(k): str(v) for k, v in data.items()}
    if ct == "multipart/form-data":
        msg = BytesParser(policy=HTTP_POLICY).parsebytes(
            b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
        )
        out = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name:
                value = part.get_content()
                if isinstance(value, bytes):
                    value = value.decode("utf-8", "replace")
                out[name] = value.strip()
        return out
    raise RequestError(f"unsupported content type {content_type!r}")


class SearchService:
    """Protocol-independent request handling shared by HTTP and tests."""

    def __init__(
        self,
        registry: DatabaseRegistry,
        max_batch: int = 64,
        window_ms: float = 2.0,
        search_timeout_s: float = DEFAULT_RESULT_TIMEOUT_S,
    ):
        self.registry = registry
        self.searcher = BatchingSearcher(
            registry, max_batch, window_ms, result_timeout_s=search_timeout_s
        )
        self._svg_cache: dict[str, str] = {}

    def close(self):
        self.searcher.close()

    def resolve_dbnames(self, form: dict, url_db: str | None) -> list[str]:
        raw = form.get("dbnames", "") or (url_db or "")
        if not raw or raw == "all":
            names = self.registry.names()
            if not names:
                raise RequestError("no databases loaded")
            return names
        return raw.split(",")

    def handle_search(self, form: dict[str, str], url_db: str | None = None,
                      request: spans.Request | None = None) -> dict:
        dbnames = self.resolve_dbnames(form, url_db)
        dbkeys = form.get("dbkeys", "")
        dbkeys = dbkeys.split(",") if dbkeys else [""] * len(dbnames)
        if len(dbkeys) == 1 and len(dbnames) > 1:
            dbkeys = dbkeys * len(dbnames)  # one key broadcasts to every DB
        if len(dbkeys) != len(dbnames):
            raise RequestError("need one dbkey per database")

        try:
            k = int(form.get("return_count", "20"))
            cutoff = float(form.get("similarity_cutoff", "0"))
            alpha = float(form.get("alpha", "1"))
            beta = float(form.get("beta", "1"))
        except ValueError as e:
            raise RequestError(f"bad numeric parameter: {e}") from e
        if k < 1:
            raise RequestError("return_count must be >= 1")
        if k > MAX_RETURN_COUNT:
            raise RequestError(f"return_count must be <= {MAX_RETURN_COUNT}")
        similarity = form.get("similarity", TANIMOTO).lower()
        if similarity not in (TANIMOTO, TVERSKY):
            raise RequestError(f"unknown similarity {similarity!r}")

        src_smiles = form.get("smiles", "").strip()
        fp_hex = form.get("fp_hex", "").strip()
        if src_smiles and not fp_hex:
            # provenance guard: a SMILES query is fingerprinted by this
            # process's generator; an incompatible database would return
            # quietly wrong neighbours (untagged databases are not checked)
            mine = generator_tag()
            ok_tags = compatible_generators(mine)
            for name in dbnames:
                if name not in self.registry:
                    continue
                theirs = self.registry.get(name).generator
                if theirs and theirs not in ok_tags:
                    raise RequestError(
                        f"database {name!r} was built with fingerprint "
                        f"generator {theirs!r} but this server generates "
                        f"{mine!r}; results would be meaningless. Re-fetch "
                        "with fp_hex, or serve with a matching generator."
                    )
        widths = {
            self.registry.get(n).bitcount for n in dbnames if n in self.registry
        }
        if len(widths) > 1:
            raise RequestError(
                f"queried databases have mixed fingerprint widths "
                f"{sorted(widths)}; query them separately"
            )
        bitcount = widths.pop() if widths else BITCOUNT
        if fp_hex:
            try:
                query = fingerprint_bin_to_words(bytes.fromhex(fp_hex), bitcount)
            except ValueError as e:
                raise RequestError(f"bad fp_hex: {e}") from e
            canonical = ""
        elif src_smiles:
            try:
                query, canonical = smiles_to_query_words(
                    src_smiles, bitcount=bitcount
                )
            except FingerprintError as e:
                raise RequestError(str(e)) from e
        else:
            raise RequestError("missing 'smiles' (or 'fp_hex') field")

        result = self.searcher.search(
            dbnames, dbkeys, query, k=k, cutoff=cutoff,
            similarity=similarity, alpha=alpha, beta=beta, request=request,
        )
        return {
            "approximate_count": result.approximate_count,
            "results": result.rows(),
            "query": src_smiles,
            "query_canonical": canonical,
        }

    def index_html(self) -> str:
        names = ",".join(self.registry.names())
        return _INDEX_TEMPLATE.format(dbnames=html.escape(names or "all"))

    def results_html(self, payload: dict) -> str:
        """Debug HTML with inline-SVG structure depictions per result
        (reference renders RDKit PNGs into a tempdir image cache,
        ``gpusim_server.py:171-252``; inline SVG needs no files/escaping).
        Depictions are memoized per canonical SMILES across requests."""
        rows = "\n".join(
            "<tr><td>{}</td><td>{}<br>{}</td><td>{:.4f}</td></tr>".format(
                _linkify(cid), self._depict(smi), html.escape(smi), score
            )
            for cid, smi, score in payload["results"]
        )
        query_smiles = payload.get("query_canonical") or payload.get("query", "")
        query_cell = (
            f"<p>Query: {self._depict(query_smiles)} "
            f"{html.escape(query_smiles)}</p>"
            if query_smiles
            else ""
        )
        return (
            self.index_html()
            + query_cell
            + f"<p>Approximate Total Matching Compounds: "
            f"{payload['approximate_count']}, returning "
            f"{len(payload['results'])}</p>"
            f"<table border=1><tr><th>ID</th><th>Structure / SMILES</th>"
            f"<th>Score</th></tr>"
            f"{rows}</table>"
        )

    def _depict(self, smiles: str) -> str:
        svg = self._svg_cache.get(smiles)
        if svg is None:
            from ..utils.depict import smiles_to_svg

            svg = smiles_to_svg(smiles, size=160)
            if len(self._svg_cache) > 4096:  # bound the memo like the
                self._svg_cache.clear()  # reference's tempdir cache
            self._svg_cache[smiles] = svg
        return svg


def _linkify(cid: str) -> str:
    safe = html.escape(cid)
    if cid.startswith("ZINC"):
        # quoted attribute + URL-encoded fragment: html.escape alone leaves
        # spaces unescaped, letting a hostile ID inject attributes/handlers
        frag = urllib.parse.quote(cid[4:], safe="")
        return f'<a href="http://zinc.docking.org/substance/{frag}">{safe}</a>'
    return safe


_INDEX_TEMPLATE = """<title>tpusimilarity</title>
<h3>tpusimilarity debug interface</h3>
<form action="/similarity_search" method="post">
  SMILES: <input type="text" name="smiles">
  Cutoff: <input type="text" name="similarity_cutoff" value="0.5">
  <input type="hidden" name="return_count" value="20">
  <input type="hidden" name="dbnames" value="{dbnames}">
  <input type="hidden" name="dbkeys" value="">
  <input type="submit" value="HTML search">
</form>
<form action="/similarity_search_json" method="post">
  SMILES: <input type="text" name="smiles">
  Cutoff: <input type="text" name="similarity_cutoff" value="0.5">
  <input type="hidden" name="return_count" value="20">
  <input type="hidden" name="dbnames" value="{dbnames}">
  <input type="hidden" name="dbkeys" value="">
  <input type="submit" value="JSON search">
</form>
"""


def make_handler(service: SearchService, debug_ui: bool = False):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            log.info("%s - %s", self.address_string(), fmt % args)

        def _send(self, code: int, content_type: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, payload: dict):
            self._send(code, "application/json", json.dumps(payload).encode())

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(
                    200, {"status": "ok", "databases": service.registry.names()}
                )
            elif self.path == "/stats":
                self._send_json(200, service.registry.stats())
            elif debug_ui and self.path in ("/", "/index.html"):
                self._send(200, "text/html", service.index_html().encode())
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            with spans.profiler_span(REQUEST_SPAN):
                request = spans.Request()
                self._post(request)
                spans.replied(service.registry.counters, request)

        def _post(self, request):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                form = parse_form(self.headers.get("Content-Type", ""), body)
                if self.path.startswith("/similarity_search_json"):
                    url_db = (
                        self.path[len("/similarity_search_json"):].lstrip("_")
                        or None
                    )
                    self._send_json(200, service.handle_search(form, url_db, request))
                elif debug_ui and self.path.startswith("/similarity_search"):
                    payload = service.handle_search(form, None, request)
                    self._send(200, "text/html",
                               service.results_html(payload).encode())
                else:
                    self._send_json(404, {"error": "not found"})
            except RequestError as e:
                self._send_json(400, {"error": str(e)})
            except KeyError as e:
                self._send_json(400, {"error": str(e.args[0]) if e.args else str(e)})
            except (TimeoutError, FuturesTimeoutError):
                self._send_json(503, {"error": "search timed out"})
            except Exception as e:  # boundary: report, keep serving
                log.exception("internal error")
                self._send_json(500, {"error": f"internal error: {e}"})

    return Handler


class SimilarityServer:
    """Owns the HTTP server, the optional socket server and the batching
    service."""

    def __init__(
        self,
        registry: DatabaseRegistry,
        hostname: str = "localhost",
        port: int = 8080,
        debug_ui: bool = False,
        max_batch: int = 64,
        window_ms: float = 2.0,
        socket_name: str | None = None,
        search_timeout_s: float = DEFAULT_RESULT_TIMEOUT_S,
    ):
        self.service = SearchService(
            registry, max_batch, window_ms, search_timeout_s=search_timeout_s
        )

        # a burst of concurrent clients must not overflow the default
        # listen backlog of 5
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = _Server(
            (hostname, port), make_handler(self.service, debug_ui)
        )
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None
        self.socket_server = None
        if socket_name:
            from .socket_server import SocketProtocolServer

            self.socket_server = SocketProtocolServer(
                self.service.searcher, socket_name=socket_name
            )
            self.socket_server.start_background()

    def serve_forever(self):
        log.info("serving on port %d", self.port)
        self.httpd.serve_forever()

    def start_background(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        # only a loop on another thread needs stopping: shutdown() waits for
        # a loop to end, forever if none ever started (a SIGINT just before
        # serve_forever)
        if self._thread:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self.socket_server:
            self.socket_server.close()
        self.service.close()
        if self._thread:
            self._thread.join(timeout=5)
