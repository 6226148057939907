"""Client library for the net front door.

The port's own copy of raft_tpu/net/client.py (stdlib and numpy only).
Wraps stdlib ``urllib`` around the :mod:`~raft_tpu_torch.net.wire` schemas and
re-raises the EXACT serve-taxonomy exception the server refused with —
status + structured JSON body → :func:`wire.decode_error` — so a caller's
existing ``except OverloadedError`` / ``except DeadlineExceededError``
fences work unchanged over the wire, structured fields
(``budget_bytes``, ``fenced``, ...) intact.

:meth:`NetClient.submit` is shaped exactly like
:meth:`SearchService.submit` (raises admission refusals synchronously,
returns a Future) — which makes
:func:`raft_tpu_torch.serve.submit_with_retry` the client-side retry
discipline with NO wire-specific fork:

    client = NetClient(f"http://127.0.0.1:{server.port}")
    fut = serve.submit_with_retry(client, "corpus", q, k=10, timeout_s=0.2)
    dists, ids = fut.result()

The server's ``Retry-After`` hint rides the refusal as
``retry_after_s``, which ``submit_with_retry`` prefers over blind
exponential backoff; ``timeout_s`` becomes the ``X-Raft-Deadline-Ms``
header (remaining budget, re-computed per attempt by the retry loop), so
the server's deadline accounting stays truthful across retries.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from concurrent.futures import Future

from ..core.errors import RaftError
from ..serve.errors import ServiceClosedError
from . import wire

__all__ = ["NetClient"]


class NetClient:
    """One front door endpoint (``base_url`` like ``http://host:port``).

    ``http_timeout_s`` bounds the socket when the caller gives no
    deadline; a request WITH ``timeout_s`` uses that budget plus a small
    margin (the server, not the socket, should win the deadline race and
    answer 504 with a trace id)."""

    def __init__(self, base_url: str, *, http_timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.http_timeout_s = float(http_timeout_s)

    # -- low-level -----------------------------------------------------------
    def _post(self, path: str, payload: dict, headers: dict,
              timeout_s: float | None):
        body = json.dumps(payload, default=float).encode()
        req = urllib.request.Request(
            self.base_url + path, data=body, method="POST",
            headers={"Content-Type": "application/json", **headers})
        sock_timeout = (self.http_timeout_s if timeout_s is None
                        else float(timeout_s) + 5.0)
        try:
            with urllib.request.urlopen(req, timeout=sock_timeout) as resp:
                return (resp.status, json.loads(resp.read().decode()),
                        dict(resp.headers))
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                err_body = json.loads(raw.decode())
            except ValueError:
                err_body = {"error": {"type": "", "message":
                                      raw.decode(errors="replace")}}
            exc = wire.decode_error(err_body, status=e.code)
            if not hasattr(exc, "retry_after_s"):
                ra = e.headers.get(wire.H_RETRY_AFTER)
                if ra is not None:
                    try:
                        exc.retry_after_s = float(ra)
                    except ValueError:
                        pass
            raise exc from None
        except urllib.error.URLError as e:
            # connection-level failure: the front door itself is gone —
            # the closest taxonomy fact (callers' shutdown fences apply)
            raise ServiceClosedError(
                f"front door unreachable at {self.base_url}: "
                f"{e.reason}") from None

    def _get(self, path: str):
        try:
            with urllib.request.urlopen(self.base_url + path,
                                        timeout=self.http_timeout_s) as resp:
                return resp.status, json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read().decode())
            except ValueError:
                return e.code, {}
        except urllib.error.URLError as e:
            raise ServiceClosedError(
                f"front door unreachable at {self.base_url}: "
                f"{e.reason}") from None

    # -- read path -----------------------------------------------------------
    def request(self, name: str, queries, k: int = 10, *,
                timeout_s: float | None = None, rid: str | None = None):
        """One wire search; returns ``(dists, ids, meta)`` where ``meta``
        carries ``rid`` (server-confirmed) and ``spans`` (the server's
        wire/queue/flush decomposition when available). Raises the
        reconstructed taxonomy error on refusal."""
        headers = {}
        if rid is not None:
            headers[wire.H_REQUEST_ID] = str(rid)
        if timeout_s is not None:
            headers[wire.H_DEADLINE_MS] = f"{float(timeout_s) * 1e3:.3f}"
        _, body, resp_headers = self._post(
            "/v1/search", wire.encode_query_batch(name, queries, k),
            headers, timeout_s)
        dists, ids = wire.decode_candidates(body)
        meta = {"rid": resp_headers.get(wire.H_REQUEST_ID),
                "spans": wire.decode_spans(resp_headers.get(wire.H_SPANS))}
        return dists, ids, meta

    def submit(self, name: str, queries, k: int = 10, *,
               timeout_s: float | None = None,
               rid: str | None = None) -> Future:
        """``SearchService.submit``-shaped: refusals raise synchronously
        (reconstructed taxonomy type, ``retry_after_s`` hint attached on
        429s), success returns an already-resolved Future of
        ``(dists, ids)`` — hand this object to
        :func:`raft_tpu_torch.serve.submit_with_retry` as the service."""
        dists, ids, _ = self.request(name, queries, k,
                                     timeout_s=timeout_s, rid=rid)
        fut: Future = Future()
        fut.set_result((dists, ids))
        return fut

    def search(self, name: str, queries, k: int = 10, *,
               timeout_s: float | None = None):
        """Blocking convenience: ``(dists, ids)``."""
        dists, ids, _ = self.request(name, queries, k, timeout_s=timeout_s)
        return dists, ids

    # -- write / control path ------------------------------------------------
    def upsert(self, name: str, rows, ids=None):
        payload = wire.encode_control(
            "upsert", name=name, rows=wire.encode_array(rows),
            ids=None if ids is None else wire.encode_array(ids))
        _, body, _ = self._post("/v1/control", payload, {}, None)
        return wire.decode_array(body["ids"])

    def delete(self, name: str, ids) -> int:
        payload = wire.encode_control("delete", name=name,
                                      ids=wire.encode_array(ids))
        _, body, _ = self._post("/v1/control", payload, {}, None)
        return int(body["deleted"])

    def flush(self) -> int:
        _, body, _ = self._post("/v1/control", wire.encode_control("flush"),
                                {}, None)
        return int(body["flushed"])

    # -- introspection -------------------------------------------------------
    def healthz(self):
        """-> ``(status_code, body)`` — 503 means eject this endpoint."""
        return self._get("/healthz")

    def stats(self) -> dict:
        code, body = self._get("/v1/stats")
        if code != 200:
            raise RaftError(f"/v1/stats answered HTTP {code}: {body}")
        return body
