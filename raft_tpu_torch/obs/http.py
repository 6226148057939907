"""Opt-in stdlib HTTP endpoint: metrics scrape, health verdict, request log.

The port's own copy of raft_tpu/obs/http.py: the same routes, bodies,
status codes and 404 listing (stdlib only, no device work).

``start_http_exporter(port)`` serves three explicitly routed paths from a
daemon-threaded stdlib ``http.server``:

- ``/metrics`` — the Prometheus text exposition of the registry;
- ``/healthz`` — the SLO verdict (ready/degraded/failing as JSON; 503 on
  failing so load balancers eject the replica) when an
  :class:`raft_tpu_torch.obs.slo.SLOTracker` is attached, else a bare
  ``{"status": "ready"}``; with ``replicas=`` attached (a
  :class:`~raft_tpu_torch.stream.ReplicatedShard` /
  :class:`~raft_tpu_torch.stream.ShardedMutableIndex`), per-replica breaker
  health folds into the verdict — fenced twins degrade, a group at zero
  pickable twins fails;
- ``/debug/requests`` — the request-trace ring
  (:class:`raft_tpu_torch.obs.requestlog.RequestLog`) when one is attached;
- ``/debug/mem`` — the memory ledger (:mod:`raft_tpu_torch.obs.mem`): totals +
  peaks, per-component aggregates, top allocations by
  ``(component, name, shard, epoch)``, retirement-audit status and
  per-device HBM stats where the backend reports them. Always routed —
  the ledger is a process singleton, nothing to attach.
- ``/debug/events`` — the operations event journal
  (:mod:`raft_tpu_torch.obs.events`): the causally-ordered ring of advisory /
  transition events, filterable by query string (``kind=``,
  ``severity=``, ``component=``, ``name=``, ``since_seq=``, ``limit=``).
  ``since_seq`` is exclusive — poll with the last seen ``seq`` to page
  the tail without gaps or repeats. Always routed (process singleton).
- ``/debug/control`` — the closed-loop controller
  (:class:`raft_tpu_torch.control.Controller`) when one is attached via
  ``controller=``: its :meth:`~raft_tpu_torch.control.Controller.status`
  (cooldowns, in-flight actuation, last action + outcome) plus the most
  recent ``control/*`` journal events.

Every other path is a 404 — a scrape-config typo fails loudly at
deploy time instead of silently scraping metrics from ``/metrcs`` forever
(earlier revisions served the exposition on every GET path; the lint
value of the 404 outweighs the curl convenience). Nothing starts unless
the process asks: no port is opened at import, and the exporter holds no
lock while rendering beyond the registry's own snapshot lock.

The server plumbing itself (routing table, 404 contract, ephemeral-port
bind, clean shutdown) is the shared :class:`raft_tpu_torch.net._httpd.Httpd` —
the same stack that serves the net front door, one server pattern, not
two.

    from raft_tpu_torch import obs

    exp = obs.start_http_exporter(9100, slo=tracker, request_log=rlog)
    ...        # scrape http://host:exp.port/metrics; probe /healthz
    exp.stop()  # clean shutdown (also a context manager; atexit not
                # required — the thread is a daemon)
"""

from __future__ import annotations

import threading

from ..net._httpd import Httpd, Response, json_response
from . import metrics

__all__ = ["MetricsExporter", "start_http_exporter", "stop_http_exporter"]

# Prometheus text exposition content type (version 0.0.4 is the text format)
_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_lock = threading.Lock()
_active: "MetricsExporter | None" = None


def _fold_replica_health(code: int, body: dict, h: dict) -> tuple[int, dict]:
    """Merge a replica-health payload (:meth:`ReplicatedShard.health` or
    :meth:`ShardedMutableIndex.health`) into the ``/healthz`` verdict: a
    group with ZERO pickable twins fails queries — that is an outage
    (``failing``/503, load balancers eject the process); fenced-but-
    surviving twins degrade a ``ready`` verdict (capacity is down, data
    is not)."""
    groups = h["shards"] if "shards" in h else [h]
    body["replicas"] = h
    if h.get("reshard") is not None:
        # a live topology migration folds into the verdict payload
        # (informational — the old topology keeps serving until the flip,
        # so a migration is not degradation)
        body["reshard"] = h["reshard"]
    healthy_min = min((g["healthy"] for g in groups), default=1)
    fenced = sum(1 for g in groups
                 for r in g.get("replicas", []) if r["fenced"])
    if healthy_min == 0:
        return 503, dict(body, status="failing")
    if fenced and body.get("status") == "ready":
        body["status"] = "degraded"
    return code, body


class MetricsExporter:
    """One running exporter: a routed :class:`~raft_tpu_torch.net._httpd.Httpd`
    on a daemon thread. ``slo``/``request_log`` are optional sources for
    ``/healthz`` and ``/debug/requests`` (see module doc)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: metrics.Registry | None = None,
                 slo=None, request_log=None, replicas=None,
                 controller=None):
        self._registry = registry or metrics.default_registry()
        self.slo = slo
        self.request_log = request_log
        self.replicas = replicas
        self.controller = controller
        # registration order is the 404 listing order
        self._server = Httpd({
            ("GET", "/metrics"): self._metrics,
            ("GET", "/healthz"): self._healthz,
            ("GET", "/debug/requests"): self._debug_requests,
            ("GET", "/debug/mem"): self._debug_mem,
            ("GET", "/debug/events"): self._debug_events,
            ("GET", "/debug/control"): self._debug_control,
        }, port=port, host=host, name="raft-obs-exporter")
        self.host = host
        self.port = self._server.port

    # -- route handlers ------------------------------------------------------
    def _metrics(self, req) -> Response:
        return Response(200, self._registry.to_prometheus().encode(),
                        _CONTENT_TYPE)

    def _healthz(self, req) -> Response:
        if self.slo is None:
            code, body = 200, {"status": "ready", "slo": None,
                               "note": "no SLO tracker attached"}
        else:
            code, body = self.slo.healthz()
        if self.replicas is not None:
            code, body = _fold_replica_health(
                code, dict(body), self.replicas.health())
        if self.controller is not None:
            # compact controller state rides the health body
            # (informational — an automated actuation is not degradation;
            # its failures journal as control/action_failed)
            st = self.controller.status()
            body = dict(body)
            body["control"] = {
                "enabled": st["enabled"],
                "dry_run": st["dry_run"],
                "inflight": st["inflight"],
                "last_action": st["last_action"],
                "degraded": st["degraded"],
            }
        return json_response(code, body)

    def _debug_mem(self, req) -> Response:
        from . import mem as obs_mem

        return json_response(200, obs_mem.debug_payload())

    def _debug_events(self, req) -> Response:
        from . import events as obs_events

        try:
            since = int(req.param("since_seq") or 0)
            limit = (int(req.param("limit"))
                     if req.param("limit") is not None else None)
        except ValueError:
            return json_response(400, {"error": "since_seq and limit must "
                                                "be integers"})
        evs = obs_events.query(
            kind=req.param("kind"), severity=req.param("severity"),
            component=req.param("component"), name=req.param("name"),
            since_seq=since, limit=limit)
        return json_response(200, {"events": evs,
                                   "last_seq": obs_events.last_seq(),
                                   "counts_by_kind":
                                       obs_events.counts_by_kind()})

    def _debug_control(self, req) -> Response:
        if self.controller is None:
            return json_response(404, {"error": "no controller attached — "
                                                "pass controller= to the "
                                                "exporter"})
        from . import events as obs_events

        return json_response(200, {"controller": self.controller.status(),
                                   "recent": obs_events.query(
                                       component="control", limit=50)})

    def _debug_requests(self, req) -> Response:
        if self.request_log is None:
            return json_response(404, {"error": "no request log attached — "
                                                "pass request_log= to the "
                                                "exporter"})
        return json_response(200, self.request_log.to_json())

    # -- lifecycle -----------------------------------------------------------
    def stop(self, timeout_s: float = 5.0) -> None:
        """Shut the listener down and join the serving thread. Idempotent."""
        server, self._server = self._server, None
        if server is None:
            return
        server.stop(timeout_s)

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def start_http_exporter(port: int = 0, host: str = "127.0.0.1",
                        registry: metrics.Registry | None = None,
                        slo=None, request_log=None,
                        replicas=None, controller=None) -> MetricsExporter:
    """Start (or return the already-running) obs HTTP endpoint.

    ``port=0`` binds an ephemeral port (read it off the returned
    ``.port``); ``host`` defaults to loopback — bind "0.0.0.0" explicitly
    to expose beyond the machine. ``slo=``/``request_log=`` attach the
    ``/healthz`` and ``/debug/requests`` sources; ``replicas=`` (a
    :class:`~raft_tpu_torch.stream.ReplicatedShard` or
    :class:`~raft_tpu_torch.stream.ShardedMutableIndex`) folds per-replica
    breaker health into the ``/healthz`` verdict — any group at zero
    pickable twins is ``failing``/503. ``controller=`` (a
    :class:`raft_tpu_torch.control.Controller`) routes ``/debug/control``
    (status + recent ``control/*`` journal events) and folds compact
    controller state into the ``/healthz`` body. One exporter per process
    through this module-level entry (a second call returns the live one —
    attach sources on the first call); construct :class:`MetricsExporter`
    directly for multiples or custom registries.
    """
    global _active
    with _lock:
        if _active is not None:
            return _active
        _active = MetricsExporter(port=port, host=host, registry=registry,
                                  slo=slo, request_log=request_log,
                                  replicas=replicas, controller=controller)
        return _active


def stop_http_exporter() -> None:
    """Stop the module-level exporter (no-op when none is running)."""
    global _active
    with _lock:
        exp, _active = _active, None
    if exp is not None:
        exp.stop()
