"""The network front door: an HTTP/JSON surface over ``SearchService``.

The port's own copy of raft_tpu/net/server.py. The port's service resolves
each request to host numpy, so the candidate set is encoded from the
arrays the future holds, with no device copy here.

Zero dependencies — the same stdlib server pattern as the obs exporter
(shared :class:`~raft_tpu_torch.net._httpd.Httpd`). Routes:

- ``POST /v1/search`` — a :mod:`~raft_tpu_torch.net.wire` query batch in, a
  candidate set out. The admission taxonomy maps to HTTP status
  (``OverloadedError``→429 with ``Retry-After`` from
  :meth:`~raft_tpu_torch.serve.SearchService.retry_after_hint`,
  ``DeadlineExceededError``→504, ``MemoryBudgetError``→507,
  ``ReplicaUnavailableError``→503, ``ServiceClosedError``→503,
  validation→400) with the structured error body
  :func:`~raft_tpu_torch.net.wire.decode_error` reconstructs exactly.
  ``X-Raft-Request-Id`` threads the wire id into the request log
  (one trace spans wire→queue→flush); ``X-Raft-Deadline-Ms`` carries
  the client's REMAINING budget, which becomes the submit's
  ``timeout_s`` — the server's deadline accounting is the client's.
- ``POST /v1/control`` — the write/flush path as explicit wire control:
  ``{"op": "upsert", "rows": <array>, "ids": <array>?}``,
  ``{"op": "delete", "ids": <array>}``, ``{"op": "flush"}`` (drains a
  ``start_workers=False`` service via ``pump(force=True)``; a no-op
  with live workers). Publish stays a process-local act — an index
  never crosses the wire (candidates-only rule; workers publish at
  boot, see :mod:`~raft_tpu_torch.net.mesh`).
- ``GET /healthz`` — ready verdict + queue depth; a backend exposing
  ``health()`` (the process mesh) folds per-worker breaker health in,
  with the same zero-pickable-twins→503 rule as the obs exporter.
- ``GET /v1/stats`` — queue depth plus whatever the ``stats=`` callable
  reports (the mesh wires compile-attribution counters through here for
  the zero-cold-compile proof).

The backend is anything submit-shaped: a
:class:`~raft_tpu_torch.serve.SearchService` or a
:class:`~raft_tpu_torch.net.mesh.ProcessMesh` router — the front door is a
layer, not a fork.
"""

from __future__ import annotations

import functools
import itertools
import os
import time

from ..core.errors import RaftError
from ..obs import metrics
from ..serve.errors import OverloadedError
from . import wire
from ._httpd import Httpd, Response, json_response

__all__ = ["NetServer"]


@functools.lru_cache(maxsize=None)
def _c_requests():
    return metrics.counter(
        "raft_tpu_net_requests_total",
        "wire requests served by the net front door, by route and HTTP "
        "status code")


@functools.lru_cache(maxsize=None)
def _g_inflight():
    return metrics.gauge(
        "raft_tpu_net_inflight",
        "wire requests currently inside the net front door "
        "(decode → submit → resolve → encode)")


@functools.lru_cache(maxsize=None)
def _h_wire():
    return metrics.histogram(
        "raft_tpu_net_wire_seconds",
        "server-side wire wall per request (decode → submit → resolve → "
        "encode), by route — subtract the serve queue/flush spans for "
        "the pure wire overhead", unit="seconds")


class NetServer:
    """One front door over one backend (see module doc).

    ``request_log=`` should be the SAME log the backend's service was
    built with — the front door adopts/mints the wire request id, passes
    it to ``submit(rid=)``, and lands the ``wire`` span on the completed
    trace (best-effort: the batcher logs completions after futures
    resolve, so a span header can miss a just-resolved entry; the bench
    reads p99 decomposition from the histograms, not headers).
    """

    def __init__(self, service, *, port: int = 0, host: str = "127.0.0.1",
                 request_log=None, stats=None):
        self.service = service
        self.request_log = request_log
        self._stats = stats
        self._rid = itertools.count(1)
        self._pid = os.getpid()
        self._server = Httpd({
            ("POST", "/v1/search"): self._wrap("/v1/search", self._search),
            ("POST", "/v1/control"): self._wrap("/v1/control", self._control),
            ("GET", "/healthz"): self._healthz,
            ("GET", "/v1/stats"): self._stats_route,
        }, port=port, host=host, name="raft-net-front")
        self.host = host
        self.port = self._server.port

    # -- plumbing ------------------------------------------------------------
    def _wrap(self, route: str, fn):
        """Meter a handler: requests by status, inflight, wire wall."""
        def handler(req) -> Response:
            t0 = time.perf_counter()
            if metrics._enabled:
                _g_inflight().inc(1)
            resp = None
            try:
                resp = fn(req, t0)
                return resp
            finally:
                if metrics._enabled:
                    _g_inflight().inc(-1)
                    code = resp.code if resp is not None else 500
                    _c_requests().inc(1, route=route, code=str(code))
                    _h_wire().observe(time.perf_counter() - t0, route=route)
        return handler

    def _error(self, exc: BaseException, hdrs: dict) -> Response:
        retry_after = None
        if (isinstance(exc, OverloadedError)
                and hasattr(self.service, "retry_after_hint")):
            retry_after = float(self.service.retry_after_hint())
            hdrs[wire.H_RETRY_AFTER] = f"{retry_after:.3f}"
        code, body = wire.encode_error(exc, retry_after_s=retry_after)
        return json_response(code, body, hdrs)

    def _rid_of(self, req) -> str:
        return (req.headers.get(wire.H_REQUEST_ID)
                or f"wire-{self._pid}-{next(self._rid):08d}")

    # -- routes --------------------------------------------------------------
    def _search(self, req, t0: float) -> Response:
        rid = self._rid_of(req)
        hdrs = {wire.H_REQUEST_ID: rid}
        timeout_s = None
        deadline_ms = req.headers.get(wire.H_DEADLINE_MS)
        if deadline_ms is not None:
            try:
                timeout_s = float(deadline_ms) / 1e3
            except ValueError:
                return self._error(RaftError(
                    f"malformed {wire.H_DEADLINE_MS} header: "
                    f"{deadline_ms!r}"), hdrs)
        try:
            name, queries, k = wire.decode_query_batch(req.json())
        except RaftError as exc:
            return self._error(exc, hdrs)
        except ValueError as exc:
            return self._error(RaftError(f"body is not JSON: {exc}"), hdrs)
        try:
            fut = self.service.submit(name, queries, k,
                                      timeout_s=timeout_s, rid=rid)
            dists, ids = fut.result()
        except Exception as exc:  # noqa: BLE001 - taxonomy → status
            return self._error(exc, hdrs)
        wire_s = time.perf_counter() - t0
        if self.request_log is not None:
            # best-effort: lands the wire span on the completed trace and
            # surfaces the queue/flush decomposition to the client. The
            # batcher logs the completion just AFTER resolving the future,
            # so one bounded wait covers the common race without ever
            # blocking the response on the log.
            if self.request_log.get(rid) is None:
                time.sleep(0.002)
            self.request_log.attach_span(rid, "wire", wire_s)
            entry = self.request_log.get(rid)
            if entry is not None:
                spans = {n: ms / 1e3
                         for n, ms in entry.get("spans_ms", {}).items()
                         if n in ("queue", "flush")}
                spans["wire"] = wire_s
                hdrs[wire.H_SPANS] = wire.encode_spans(spans)
        return json_response(200, wire.encode_candidates(dists, ids), hdrs)

    def _control(self, req, t0: float) -> Response:
        rid = self._rid_of(req)
        hdrs = {wire.H_REQUEST_ID: rid}
        try:
            op, payload = wire.decode_control(req.json())
        except RaftError as exc:
            return self._error(exc, hdrs)
        except ValueError as exc:
            return self._error(RaftError(f"body is not JSON: {exc}"), hdrs)
        try:
            if op == "upsert":
                rows = wire.decode_array(payload["rows"])
                ids = (wire.decode_array(payload["ids"])
                       if payload.get("ids") is not None else None)
                out = self.service.upsert(payload.get("name", "default"),
                                          rows, ids)
                return json_response(
                    200, {"v": wire.WIRE_VERSION,
                          "ids": wire.encode_array(out)}, hdrs)
            if op == "delete":
                ids = wire.decode_array(payload["ids"])
                n = self.service.delete(payload.get("name", "default"), ids)
                return json_response(
                    200, {"v": wire.WIRE_VERSION, "deleted": int(n)}, hdrs)
            if op == "flush":
                n = (self.service.pump(force=True)
                     if hasattr(self.service, "pump") else 0)
                return json_response(
                    200, {"v": wire.WIRE_VERSION, "flushed": int(n)}, hdrs)
            return self._error(
                RaftError(f"unknown control op {op!r} (ops: upsert, "
                          "delete, flush)"), hdrs)
        except KeyError as exc:
            return self._error(
                RaftError(f"control op {op!r} missing field {exc}"), hdrs)
        except Exception as exc:  # noqa: BLE001 - taxonomy → status
            return self._error(exc, hdrs)

    def _healthz(self, req) -> Response:
        body = {"status": "ready"}
        code = 200
        if hasattr(self.service, "queue_depth"):
            body["queue_depth"] = int(self.service.queue_depth())
        if hasattr(self.service, "health"):
            # same fold as the obs exporter: zero pickable twins in any
            # group is an outage (503), fenced-but-surviving degrades
            from ..obs.http import _fold_replica_health

            code, body = _fold_replica_health(code, body,
                                              self.service.health())
        return json_response(code, body)

    def _stats_route(self, req) -> Response:
        body = {"v": wire.WIRE_VERSION}
        if hasattr(self.service, "queue_depth"):
            body["queue_depth"] = int(self.service.queue_depth())
        if self._stats is not None:
            body.update(self._stats())
        return json_response(200, body)

    # -- lifecycle -----------------------------------------------------------
    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the listener (the backend service is the caller's to
        shut down — the front door never owns it). Idempotent."""
        server, self._server = self._server, None
        if server is not None:
            server.stop(timeout_s)

    def __enter__(self) -> "NetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
