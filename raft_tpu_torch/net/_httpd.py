"""Shared stdlib HTTP server plumbing — one server pattern, not two.

The port's own copy of raft_tpu/net/_httpd.py. Both the obs exporter
(:mod:`raft_tpu_torch.obs.http`) and the net front door
(:mod:`raft_tpu_torch.net.server`) serve from a daemon-threaded stdlib
``http.server`` with the same conventions:

- **routing table** — an explicit ``{(method, path): handler}`` dict;
  handlers take a parsed :class:`Request` and return a :class:`Response`;
- **404 contract** — unknown paths fail loudly with the endpoint listing
  (in registration order) so a scrape-config or client-URL typo surfaces
  at deploy time instead of silently hitting a catch-all;
- **ephemeral-port bind** — ``port=0`` binds an OS-assigned port, read it
  off ``.port`` (tests and multi-worker meshes never race on a fixed
  port);
- **clean shutdown** — ``stop()`` shuts the listener down and joins the
  serving thread; also a context manager. Threads are daemons, so an
  unstopped server never blocks interpreter exit.

This module is intentionally dependency-free (stdlib only, no imports
from the rest of the package, no torch) so the import graph stays
acyclic: ``obs.http`` imports it while ``net.server`` imports
:mod:`raft_tpu_torch.serve`, which imports :mod:`raft_tpu_torch.obs`.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Mapping

__all__ = ["Request", "Response", "json_response", "Httpd",
           "JSON_TYPE", "TEXT_TYPE"]

JSON_TYPE = "application/json; charset=utf-8"
TEXT_TYPE = "text/plain; charset=utf-8"


class Request:
    """One parsed HTTP request as handed to a route handler."""

    __slots__ = ("method", "path", "query", "headers", "body")

    def __init__(self, method: str, path: str, query: dict,
                 headers, body: bytes):
        self.method = method
        self.path = path            # path only, query string stripped
        self.query = query          # parse_qs dict: key -> [values]
        self.headers = headers      # email.message.Message (case-insensitive)
        self.body = body

    def param(self, key: str, default=None):
        """Last query-string value for ``key`` (or ``default``)."""
        vals = self.query.get(key)
        return vals[-1] if vals else default

    def json(self):
        """Decode the body as JSON (raises ``ValueError`` on garbage)."""
        return json.loads(self.body.decode("utf-8"))


class Response:
    """What a route handler returns: status, body, content type, extra
    headers (``Content-Type``/``Content-Length`` are set by the server)."""

    __slots__ = ("code", "content_type", "body", "headers")

    def __init__(self, code: int, body, content_type: str = TEXT_TYPE,
                 headers: Mapping[str, str] | None = None):
        self.code = int(code)
        self.body = body.encode() if isinstance(body, str) else bytes(body)
        self.content_type = content_type
        self.headers = dict(headers) if headers else {}


def json_response(code: int, obj,
                  headers: Mapping[str, str] | None = None) -> Response:
    """A :class:`Response` carrying ``obj`` as JSON (numpy scalars and
    other floatables serialize via ``default=float``)."""
    return Response(code, json.dumps(obj, default=float).encode(),
                    JSON_TYPE, headers)


class Httpd:
    """A routed ``ThreadingHTTPServer`` on a daemon thread.

    ``routes`` maps ``(method, path)`` — e.g. ``("GET", "/metrics")``,
    ``("POST", "/v1/search")`` — to ``handler(Request) -> Response``.
    A handler that raises is answered with a 500 JSON error body rather
    than a hung socket. The 404 body lists the registered endpoints in
    registration order.
    """

    def __init__(self, routes: Mapping[tuple[str, str],
                                       Callable[[Request], Response]],
                 *, port: int = 0, host: str = "127.0.0.1",
                 name: str = "raft-httpd"):
        table = dict(routes)
        # registration order, deduped across methods — the 404 listing
        listing = ", ".join(dict.fromkeys(p for _, p in table))

        class Handler(BaseHTTPRequestHandler):
            def _dispatch(self, method: str) -> None:
                split = urllib.parse.urlsplit(self.path)
                handler = table.get((method, split.path))
                if handler is None:
                    resp = Response(
                        404,
                        f"unknown path {split.path!r}; endpoints: "
                        f"{listing}\n")
                else:
                    n = int(self.headers.get("Content-Length") or 0)
                    req = Request(method, split.path,
                                  urllib.parse.parse_qs(split.query),
                                  self.headers,
                                  self.rfile.read(n) if n else b"")
                    try:
                        resp = handler(req)
                    except Exception as exc:  # noqa: BLE001 - 500, not a hang
                        resp = json_response(
                            500, {"error": f"{type(exc).__name__}: {exc}"})
                self.send_response(resp.code)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(resp.body)))
                for k, v in resp.headers.items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(resp.body)

            def do_GET(self):  # noqa: N802 - http.server API
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802 - http.server API
                self._dispatch("POST")

            def log_message(self, fmt, *args):
                # request-per-query traffic must not spam stderr; counts
                # are observable via metrics on the app side
                pass

        self._server = ThreadingHTTPServer((host, int(port)), Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"{name}-{self.port}", daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Shut the listener down and join the serving thread. Idempotent."""
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        self._thread.join(timeout_s)

    def __enter__(self) -> "Httpd":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
