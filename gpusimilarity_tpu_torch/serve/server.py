"""HTTP/JSON similarity-search service (twin of
``gpusimilarity_tpu/serve/server.py``), with the same wire contract:

* ``POST /similarity_search_json[_<db>]`` with form fields ``smiles`` (or
  ``fp_hex``), ``return_count``, ``similarity_cutoff``, ``dbnames`` and
  ``dbkeys`` (comma-separated), plus the extensions ``similarity``
  (``tanimoto``/``tversky``), ``alpha`` and ``beta`` → JSON
  ``{"approximate_count": N, "results": [[id, smiles, score], ...]}``.
  The URL suffix names the databases for clients that post no ``dbnames``;
  ``all`` means every loaded database.
* ``GET /healthz`` and ``GET /stats`` (which also reports the kernel's
  launch count).

The debug HTML UI and the reference's binary socket protocol are not
ported yet (``ROADMAP.md`` Queue 1 #13).
"""

from __future__ import annotations

import json
import logging
import threading
from concurrent.futures import TimeoutError as FuturesTimeoutError
from email.parser import BytesParser
from email.policy import HTTP as HTTP_POLICY
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from gpusimilarity_tpu.utils.fingerprints import (
    BITCOUNT,
    FingerprintError,
    compatible_generators,
    fingerprint_bin_to_words,
    generator_tag,
    smiles_to_query_words,
)

from ..models.registry import DatabaseRegistry
from ..ops.scan import TANIMOTO, TVERSKY
from .batching import BatchingSearcher

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
    ):
        self.registry = registry
        self.searcher = BatchingSearcher(registry, max_batch, window_ms)

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

    def handle_search(self, form: dict[str, str], url_db: str | None = None) -> dict:
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
            similarity=similarity, alpha=alpha, beta=beta,
        )
        return {
            "approximate_count": result.approximate_count,
            "results": result.rows(),
            "query": src_smiles,
            "query_canonical": canonical,
        }


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            log.info("%s - %s", self.address_string(), fmt % args)

        def _send_json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(
                    200, {"status": "ok", "databases": service.registry.names()}
                )
            elif self.path == "/stats":
                self._send_json(200, service.registry.stats())
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                form = parse_form(self.headers.get("Content-Type", ""), body)
                if self.path.startswith("/similarity_search_json"):
                    url_db = (
                        self.path[len("/similarity_search_json"):].lstrip("_")
                        or None
                    )
                    self._send_json(200, service.handle_search(form, url_db))
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
    """Owns the HTTP server + batching service."""

    def __init__(
        self,
        registry: DatabaseRegistry,
        hostname: str = "localhost",
        port: int = 8080,
        max_batch: int = 64,
        window_ms: float = 2.0,
    ):
        self.service = SearchService(registry, max_batch, window_ms)

        # a burst of concurrent clients must not overflow the default
        # listen backlog of 5
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self.httpd = _Server((hostname, port), make_handler(self.service))
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def serve_forever(self):
        log.info("serving on port %d", self.port)
        self.httpd.serve_forever()

    def start_background(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()
        if self._thread:
            self._thread.join(timeout=5)
