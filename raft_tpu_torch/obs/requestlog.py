"""Request-level tracing: a request id minted at admission, span timings
through the serve/stream pipeline, and a /debug/requests ring buffer.

The port's own copy of raft_tpu/obs/requestlog.py.

Histograms answer "how slow is p99"; they cannot answer "WHY was *that*
request slow". Dapper (Sigelman et al., 2010) is the template: give every
request an id at the door, record per-stage span timings against it, and
keep the recent ones queryable. This module is the stdlib, in-process
version for the serve+stream stack:

- :meth:`RequestLog.begin` mints the id when
  :meth:`~raft_tpu_torch.serve.SearchService.submit` admits a request;
- the batcher records the **queue** span (admission → flush pickup) and
  the **flush** span (flush_fn wall) per request;
- inside the flush, :func:`add_span`/:func:`annotate` accumulate into a
  thread-local collector (:func:`collect`): the service's flush function
  records ``serve/lease`` and ``serve/search``, and
  ``stream.MutableIndex`` carves the search into ``stream/sealed`` /
  ``stream/delta`` / ``stream/merge`` dispatch walls plus the registry
  version the flush leased — so a slow or wrong answer is attributable to
  a specific queue, flush, index epoch, or stream stage;
- completed requests land in a bounded ring served at ``/debug/requests``
  (``obs.start_http_exporter(port, request_log=log)``), with the
  slowest-recent requests and a per-latency-bucket **exemplar** map — each
  bucket of the ``raft_tpu_serve_*_seconds`` histograms links to the most
  recent request id that landed in it, which is how a histogram spike
  turns into a concrete trace to read.

Requests in one flush batch share the flush-level spans (they WERE served
by the same dispatch) and keep per-request queue spans. Span walls inside
a CUDA pipeline are host dispatch walls — kernel launches are async — so
the flush span (which materializes) bounds them; the decomposition is still
the right attribution order-of-magnitude on the host side, and the device
side belongs to a ``torch.profiler`` trace.
"""

from __future__ import annotations

import collections
import functools
import os
import threading
import time
from typing import Callable

from . import metrics
from .metrics import DEFAULT_BUCKETS, _fmt_le

__all__ = ["RequestLog", "collect", "add_span", "annotate", "prefix"]


@functools.lru_cache(maxsize=None)
def _c_logged():
    return metrics.counter(
        "raft_tpu_requestlog_requests_total",
        "requests recorded in the /debug/requests ring, by stream and "
        "outcome (ok/error/expired)")


# -- thread-local span collector ---------------------------------------------

_tls = threading.local()


class _Collector:
    __slots__ = ("spans", "notes", "pre", "pid")

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.notes: dict[str, object] = {}
        self.pre = ""  # active span/note name prefix (see `prefix`)
        # owning process: `collect(resume=)` is a SINGLE-PROCESS contract
        # (thread-local handoff, never concurrent) — a collector carried
        # across a fork/spawn boundary must not be resumed there
        self.pid = os.getpid()


class collect:
    """Context manager opening a span collector on the current thread —
    the batcher wraps each flush_fn call in one; :func:`add_span` and
    :func:`annotate` anywhere below (service flush, registry lease, stream
    search) accumulate into it. Reentrant-safe (inner scopes shadow) and a
    no-op-cost check when no scope is open.

    ``resume=`` re-opens an EXISTING collector instead of a fresh one —
    how the pipelined batcher's completion stage (possibly on another
    thread, never concurrently with dispatch) lands its spans on the same
    batch's trace as the dispatch-side ones. The handoff contract is
    same-process only: dispatch and completion are threads of one service.
    A collector that crossed a process boundary (fork-inherited, or
    unpickled in a mesh worker's response path) must NOT be mutated —
    the parent may still complete the same batch, and two processes
    appending to one span dict corrupts the trace. ``__enter__`` checks
    the collector's owning pid and degrades to a FRESH collector (noted
    ``resume_degraded: cross-process``) so wire traces lose the resumed
    spans instead of corrupting them."""

    def __init__(self, resume: _Collector | None = None):
        self._resume = resume

    def __enter__(self) -> _Collector:
        self._prev = getattr(_tls, "collector", None)
        resume = self._resume
        if resume is not None and resume.pid != os.getpid():
            # cross-process resume: the collector belongs to another
            # process's trace — start fresh, mark the degrade
            resume = None
        _tls.collector = resume if resume is not None else _Collector()
        if resume is None and self._resume is not None:
            _tls.collector.notes["resume_degraded"] = "cross-process"
        return _tls.collector

    def __exit__(self, *exc) -> None:
        _tls.collector = self._prev


def add_span(name: str, seconds: float) -> None:
    """Accumulate a span wall into the active collector (no-op without
    one — the stream/serve call sites pay one getattr when tracing is
    off)."""
    c = getattr(_tls, "collector", None)
    if c is not None:
        name = c.pre + name
        c.spans[name] = c.spans.get(name, 0.0) + float(seconds)


def annotate(key: str, value) -> None:
    """Attach a non-timing fact (e.g. the leased registry version) to the
    active collector."""
    c = getattr(_tls, "collector", None)
    if c is not None:
        c.notes[c.pre + key] = value


class prefix:
    """Scope a span/note name prefix on the active collector — how the
    sharded stream tier turns one code path's ``stream/sealed`` /
    ``stream/delta`` spans into per-shard ``stream/shard<i>/...`` entries,
    so ``/debug/requests`` attributes tail latency to the straggler shard.
    Nests (inner prefixes append) and costs one getattr when no collector
    is open."""

    def __init__(self, p: str):
        self._p = str(p)

    def __enter__(self) -> "prefix":
        c = getattr(_tls, "collector", None)
        self._prev = c.pre if c is not None else None
        if c is not None:
            c.pre = c.pre + self._p
        return self

    def __exit__(self, *exc) -> None:
        c = getattr(_tls, "collector", None)
        if c is not None and self._prev is not None:
            c.pre = self._prev


# -- the log -----------------------------------------------------------------

class RequestLog:
    """Bounded ring of completed request traces (see module doc).

    ``capacity`` bounds the completed-trace ring (one small dict per
    request); ``in_flight_capacity`` separately bounds the pending map and
    should cover the service's admission bound (``max_queue_rows``, default
    4096) — sizing it BELOW the queue bound would evict exactly the
    oldest/wedged requests the in-flight view exists to expose. ``clock``
    is injected for deterministic tests. All methods are thread-safe;
    :meth:`begin` is the only hot-path touch (a dict insert under a
    lock)."""

    def __init__(self, capacity: int = 256, *,
                 in_flight_capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self.capacity = int(capacity)
        self.in_flight_capacity = int(in_flight_capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._next = 0
        # rid -> admission context of requests begun but not yet completed
        # (visible as "in_flight" at /debug/requests — a wedged flush shows
        # up HERE, not in the completed ring). Oldest-first eviction only
        # past in_flight_capacity: with the cap at/above the service's
        # queue bound, eviction touches only LEAKED entries (a drain=False
        # shutdown fails futures without complete()), which are by
        # construction the oldest once real traffic resumes.
        self._pending: dict[str, dict] = {}
        # latency-bucket upper bound -> the most recent request that landed
        # there: the exemplar link from the serve latency histograms
        self._exemplars: dict[str, dict] = {}

    # -- lifecycle -----------------------------------------------------------
    def begin(self, stream: str, rows: int, *,
              rid: str | None = None) -> str:
        """Mint a request id at admission and record it in flight.

        ``rid=`` adopts an EXTERNALLY minted id instead (the net front
        door threads the wire request id — ``X-Raft-Request-Id`` — here,
        so one trace spans wire→queue→flush under the id the client
        logged). Adopted ids are recorded as given; uniqueness is the
        caller's contract (a reused id overwrites the pending entry)."""
        now = self._clock()
        with self._lock:
            if rid is None:
                self._next += 1
                rid = f"req-{self._next:08d}"
            else:
                rid = str(rid)
            self._pending[rid] = {"rid": rid, "stream": stream,
                                  "rows": int(rows), "admitted_at": now}
            while len(self._pending) > self.in_flight_capacity:
                self._pending.pop(next(iter(self._pending)))
            return rid

    def attach_span(self, rid: str | None, name: str,
                    seconds: float) -> None:
        """Attach a span to an ALREADY COMPLETED request's ring entry —
        how the net front door lands the ``wire`` span (measured around
        the whole submit→resolve window, so it bounds queue+flush) on a
        trace after the batcher completed it. Searches the ring newest-
        first; a no-op when the rid has been evicted (or ``None``), so
        wire tracing degrades instead of raising."""
        if rid is None:
            return
        with self._lock:
            for entry in reversed(self._ring):
                if entry["rid"] == rid:
                    entry["spans_ms"][name] = round(float(seconds) * 1e3, 4)
                    return

    def complete(self, rid: str | None, *, stream: str, rows: int,
                 spans: dict, bucket: int | None = None, notes: dict = None,
                 outcome: str = "ok") -> None:
        """Record one finished request (rid None → no-op, so call sites
        need no attached-log check). ``spans`` carries at least the queue
        span; the total used for slowest/exemplar ranking is queue +
        flush."""
        if rid is None:
            return
        total = float(spans.get("queue", 0.0)) + float(spans.get("flush", 0.0))
        entry = {
            "rid": rid, "stream": stream, "rows": int(rows),
            "bucket": bucket, "outcome": outcome,
            "spans_ms": {k: round(v * 1e3, 4) for k, v in spans.items()},
            "total_ms": round(total * 1e3, 4),
            "ts": self._clock(),
        }
        if notes:
            entry["notes"] = dict(notes)
        with self._lock:
            self._pending.pop(rid, None)
            self._ring.append(entry)
            if outcome == "ok":
                self._exemplars[_bucket_le(total)] = {
                    "rid": rid, "stream": stream,
                    "total_ms": entry["total_ms"], "ts": entry["ts"]}
        if metrics._enabled:
            _c_logged().inc(1, stream=stream, outcome=outcome)

    # -- read side -----------------------------------------------------------
    def get(self, rid: str) -> dict | None:
        """The completed ring entry for ``rid`` (newest first), or ``None``
        when it never completed / was evicted — the net front door's span
        lookup, deliberately miss-tolerant."""
        with self._lock:
            for entry in reversed(self._ring):
                if entry["rid"] == rid:
                    return dict(entry)
        return None

    def recent(self, n: int = 50) -> list[dict]:
        """The most recent completed requests, oldest first."""
        with self._lock:
            return list(self._ring)[-int(n):]

    def slowest(self, n: int = 10) -> list[dict]:
        """The slowest requests still in the ring (recent by construction —
        the ring is bounded), worst first."""
        with self._lock:
            entries = list(self._ring)
        return sorted(entries, key=lambda e: -e["total_ms"])[:int(n)]

    def exemplars(self) -> dict:
        """{histogram bucket ``le`` → most recent request landing there} —
        the link from a ``raft_tpu_serve_*_seconds`` bucket to a concrete
        trace."""
        with self._lock:
            return dict(self._exemplars)

    def in_flight(self) -> list[dict]:
        """Requests admitted but not yet completed, oldest first — a
        wedged flush shows up here, not in the completed ring."""
        with self._lock:
            return list(self._pending.values())

    def to_json(self, recent: int = 50, slowest: int = 10) -> dict:
        """The /debug/requests payload."""
        return {
            "capacity": self.capacity,
            "in_flight": self.in_flight(),
            "recent": self.recent(recent),
            "slowest": self.slowest(slowest),
            "exemplars": self.exemplars(),
        }


def _bucket_le(total_s: float) -> str:
    """The latency-histogram bucket (upper bound, formatted by the SAME
    ``le``-string rule the metrics exposition uses — ``metrics._fmt_le`` —
    so exemplar keys can never drift out of byte-match with the
    ``raft_tpu_serve_*_seconds`` bucket labels) a request total falls in."""
    for ub in DEFAULT_BUCKETS:
        if total_s <= ub:
            return _fmt_le(ub)
    return _fmt_le(float("inf"))
