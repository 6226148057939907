"""SearchService: batcher + registry + admission control.

Counterpart of raft_tpu/serve/service.py, the front door of the serving
layer. One service owns:

- an :class:`~raft_tpu_torch.serve.registry.IndexRegistry` (shared or
  private) — publish/hot-swap the indexes it serves;
- one :class:`~raft_tpu_torch.serve.batcher.MicroBatcher` per *stream* (an
  index name at one ``k``), created lazily — submissions to the same
  stream share shapes, so they can share batches;
- **admission control**: a bounded queue (``max_queue_rows`` across all
  streams). At the bound, :meth:`submit` raises
  :class:`~raft_tpu_torch.serve.errors.OverloadedError` synchronously. Each
  request may carry a deadline; requests that expire while queued are
  dropped at drain, BEFORE any device work is spent on them.

The flush path resolves the registry lease per flush, so a
:meth:`publish` hot-swap takes effect on the next flush while in-flight
batches finish on the version they started with.

Two flush modes. ``pipeline_depth=0``: the flush searches and copies the
results to the host before it returns. ``pipeline_depth > 0`` (default 2):
the flush dispatches on the flush worker's current CUDA stream, starts the
device-to-host copy into pinned buffers (``non_blocking=True``) and records
an event; the batcher's completion stage waits on that event, on another
thread, and the registry lease is held until then. No flush calls
``torch.cuda.synchronize()``: it would also wait for other streams' work.

The write path: publishing a :class:`raft_tpu_torch.stream.MutableIndex`
(or its own ``searcher()`` hook, which a ``stream.Compactor`` republishes
after each swap) under a name opens :meth:`upsert` / :meth:`delete` for
it; publishing anything else under that name closes them again.

The online-quality hooks: ``canary=`` (a
:class:`raft_tpu_torch.obs.quality.RecallCanary`) samples the flushes of its
published name, ``slo=`` (a :class:`raft_tpu_torch.obs.slo.SLOTracker`) gets
every admission and every served request's latency, ``request_log=`` (a
:class:`raft_tpu_torch.obs.requestlog.RequestLog`) the request traces. A
tiered mutable index publishes its ``refined_searcher()`` like any hook.
``publish(tuned=...)`` serves a plain index at a pinned tune decision.

Determinism for tests: pass ``start_workers=False`` plus an injected
``clock`` and drive the queues with :meth:`pump`.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch

from ..core import tracing
from ..core.errors import expects
from ..obs import dispatch as obs_dispatch
from ..obs import metrics, requestlog
from .batcher import MicroBatcher, PendingFlush, _deadline_total, _host, bucket_sizes
from .errors import (DeadlineExceededError, OverloadedError,
                     ServiceClosedError)
from .registry import IndexRegistry
from .staging import StagingBuffers, warm_staging

__all__ = ["SearchService"]


@functools.lru_cache(maxsize=None)
def _overload_total():
    return metrics.counter(
        "raft_tpu_serve_overload_total",
        "requests refused at admission (queue at max_queue_rows)")


@functools.lru_cache(maxsize=None)
def _requests_total():
    return metrics.counter(
        "raft_tpu_serve_requests_total", "requests admitted per stream")


def _start_copy_to_host(out):
    """Start copying a searcher's result tensors to pinned host memory;
    returns ``(host tensors, event)``. The event (None when nothing was on
    a CUDA device) is recorded on the current stream after the copies."""
    host, dev = [], None
    for a in out:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            h.copy_(a, non_blocking=True)
            dev = a.device
            a = h
        host.append(a)
    if dev is None:
        return host, None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return host, done


class _RowCounter:
    """Service-wide queued-row count with an atomic bounded add.

    LEAF lock: it is touched from under the service lock (submit) and from
    under batcher condition locks (drain callbacks), so it must never take
    another lock itself — that is what keeps the lock order acyclic."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._n = 0
        self._lock = threading.Lock()

    def try_add(self, n: int) -> bool:
        with self._lock:
            if self._n + n > self.limit:
                return False
            self._n += n
            return True

    def sub(self, n: int) -> None:
        with self._lock:
            self._n = max(self._n - n, 0)

    def value(self) -> int:
        with self._lock:
            return self._n


class SearchService:
    """Online k-NN serving over the registry's indexes (see module doc).

    ``max_batch`` fixes the bucket ladder (and therefore the warmed shape
    set) for every stream; ``max_wait_us`` is the batching latency budget —
    a lone request waits at most this long before flushing under-full.
    ``default_timeout_s`` applies to requests submitted without an explicit
    timeout (``None`` = no deadline).

    The online-quality hooks (all optional): ``canary`` (a
    :class:`raft_tpu_torch.obs.quality.RecallCanary`: ``offer()`` / ``name``
    / ``k``) taps every flush of the canary's published name at its own k;
    ``slo`` (a :class:`raft_tpu_torch.obs.slo.SLOTracker`) receives every
    admission outcome and every served request's queue-wait/flush split; ``request_log`` (an
    :class:`raft_tpu_torch.obs.requestlog.RequestLog`) mints a request id at
    admission and collects span timings through queue → flush → registry
    lease → index search.

    ``pipeline_depth`` (default 2) bounds the pipelined flush path's
    in-flight completion stage (module doc): the flush worker dispatches
    the search and the copy of its results to the host, hands the pending
    result off, and drains the next batch, with queries staged through
    reusable per-bucket buffers. ``0`` restores the fully synchronous flush.
    ``staging_device`` names the device the staging uploads to (default:
    the published searcher's ``device``) and also warms the searcher on
    device-resident queries at publish.
    """

    def __init__(self, registry: IndexRegistry | None = None, *,
                 max_batch: int = 64, max_wait_us: float = 1000.0,
                 max_queue_rows: int = 4096,
                 default_timeout_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 start_workers: bool = True,
                 canary=None, slo=None, request_log=None,
                 pipeline_depth: int = 2, staging_device=None):
        self.buckets = bucket_sizes(max_batch)
        self.registry = registry or IndexRegistry(buckets=self.buckets,
                                                  clock=clock)
        # an externally-built registry must warm every shape this service's
        # streams flush, or publish()'s warm-swap guarantee is
        # silently void
        expects(set(self.buckets) <= set(self.registry.buckets),
                "registry buckets %s do not cover the service ladder %s",
                self.registry.buckets, self.buckets)
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self.max_queue_rows = int(max_queue_rows)
        # a bound below max_batch would refuse every full-bucket request
        # forever, even on an idle service — a config error, not overload
        expects(self.max_queue_rows >= self.max_batch,
                "max_queue_rows (%d) must be >= max_batch (%d)",
                self.max_queue_rows, self.max_batch)
        self._rows = _RowCounter(max_queue_rows)  # O(1) admission bound
        self.default_timeout_s = default_timeout_s
        self._clock = clock
        self._start_workers = start_workers
        expects(int(pipeline_depth) >= 0, "pipeline_depth must be >= 0")
        self.pipeline_depth = int(pipeline_depth)
        self._staging_device = staging_device
        expects(canary is None or (hasattr(canary, "offer")
                                   and hasattr(canary, "name")),
                "canary must be an obs.quality.RecallCanary (offer()/name)")
        expects(slo is None or hasattr(slo, "record_admission"),
                "slo must be an obs.slo.SLOTracker (record_admission())")
        expects(request_log is None or hasattr(request_log, "begin"),
                "request_log must be an obs.requestlog.RequestLog (begin())")
        self._canary = canary
        self._slo = slo
        self._request_log = request_log
        # guards the batcher map + the closed flag; admission uses the
        # leaf-locked _RowCounter instead, so submit never holds this lock
        # across an enqueue
        self._lock = threading.Lock()
        self._batchers: dict[tuple, MicroBatcher] = {}
        # writable (stream.MutableIndex) handles per name: the write path
        # (upsert / delete) routes through these
        self._mutables: dict[str, object] = {}
        self._closed = False

    # -- publish ------------------------------------------------------------
    def publish(self, name: str, index, *, search_params=None,
                k: int | tuple = 10, version: int | None = None,
                warm: bool = True, warm_data=None, tuned=None,
                res=None, warm_hook=None, cause: dict | None = None) -> dict:
        """Publish/hot-swap through the service's registry, warming against
        the SERVICE's bucket ladder (the shapes its streams actually flush).
        Safe under load: in-flight requests finish on the old version.
        ``warm_data`` (optional (rows, dim) sample in the serving dtype)
        draws the warmup queries from real data — see
        :func:`raft_tpu_torch._warmup.warm_buckets`. Publishing a
        ``stream.MutableIndex`` (or its own ``searcher()`` hook) opens the
        write path for ``name``; anything else closes it. ``tuned`` (a
        ``tune.DecisionLog`` / ``Decision`` / its dict / ``True``) serves
        the index at its pinned operating point; the warm ladder covers the
        tuned searcher, so applying a decision is as hiccup-free as any
        other publish (:meth:`IndexRegistry.publish`).
        ``res`` carries ``memory_budget_bytes`` for the publish admission
        gate (:meth:`IndexRegistry.publish`); over budget raises
        :class:`~raft_tpu_torch.serve.errors.MemoryBudgetError` with zero
        partial state.

        ``warm_hook`` (``fn(searcher, ks)``) forwards to the registry's
        pre-flip seam (:meth:`IndexRegistry.publish`), composed AFTER the
        pipelined flush path's own staging warm. Its return value lands in
        ``report["warm_hook"]``. ``cause`` forwards to the registry and
        rides the ``serve_published`` event's evidence."""
        with tracing.range("serve/publish/%s", name):
            with self.registry.publish_lock(name):
                # the staging leg of the warm ladder rides the registry's
                # pre-flip warm_hook, so a hot-swap under live pipelined
                # load never serves the new version before its staging
                # path ran once: serving traffic takes no publish lock
                hooks = []
                if self.pipeline_depth > 0:
                    def staging_hook(searcher, ks):
                        return warm_staging(
                            self.buckets, searcher.dim,
                            searcher.query_dtype,
                            device=(self._staging_device
                                    or getattr(searcher, "device", None)),
                            searcher=(searcher
                                      if self._staging_device is not None
                                      else None),
                            ks=ks)

                    hooks.append(("staging_warmed", staging_hook))
                if warm_hook is not None:
                    # the caller's hook runs LAST
                    hooks.append(("warm_hook", warm_hook))
                combined = None
                if hooks:
                    def combined(searcher, ks, _hooks=tuple(hooks)):
                        return {key: fn(searcher, ks) for key, fn in _hooks}
                report = self.registry.publish(
                    name, index, search_params=search_params, k=k,
                    version=version, warm=warm, warm_data=warm_data,
                    tuned=tuned, res=res, warm_hook=combined, cause=cause)
                parts = report.pop("warm_hook", None)
                if parts:
                    report.update(parts)
                with self._lock:
                    mut = getattr(index, "mutable", None)
                    if hasattr(index, "upsert") and hasattr(index, "searcher"):
                        self._mutables[name] = index
                    elif mut is not None and hasattr(mut, "upsert"):
                        # a MutableIndex's OWN hook (marked by searcher(),
                        # what a stream.Compactor republishes after each
                        # swap): the write path follows it
                        self._mutables[name] = mut
                    else:
                        # a plain index or an unmarked hook closes the write
                        # path: a stale handle would route upserts to an
                        # index nobody serves
                        self._mutables.pop(name, None)
            return report

    # -- serving ------------------------------------------------------------
    def _stream(self, name: str, k: int, dim: int | None = None,
                qdtype: str | None = None, device=None) -> MicroBatcher:
        key = (name, int(k))
        with self._lock:
            # re-checked under the lock: a submit racing shutdown() must not
            # create a batcher shutdown will never close
            if self._closed:
                raise ServiceClosedError("service is shut down")
            b = self._batchers.get(key)
            if b is None:
                staging = None
                if self.pipeline_depth > 0 and dim is not None:
                    staging = StagingBuffers(
                        self.buckets, dim, qdtype,
                        depth=self.pipeline_depth,
                        device=self._staging_device or device,
                        stream=f"{name}.k{k}")
                # the canary taps only its own name's flushes AT ITS OWN
                # WIDTH — another stream's results (or the same name served
                # at a different k) scored against this oracle would be a
                # category error, not a recall estimate: |top-k' ∩ exact
                # top-k| / k inflates toward 1 for k' > k and caps at k'/k
                # below it, and either way feeds false slots into the SLO
                # quality objective
                canary = self._canary
                on_result = None
                if (canary is not None and canary.name == name
                        and int(canary.k) == int(k)):
                    def on_result(queries, out, _c=canary):
                        _c.offer(queries, out[1])
                b = MicroBatcher(
                    self._make_flush(name, int(k)),
                    max_batch=self.max_batch, max_wait_us=self.max_wait_us,
                    clock=self._clock, stream=f"{name}.k{k}",
                    start=self._start_workers, on_dequeue=self._rows.sub,
                    request_log=self._request_log, slo=self._slo,
                    on_result=on_result,
                    pipeline_depth=self.pipeline_depth, staging=staging)
                self._batchers[key] = b
        return b

    def _make_flush(self, name: str, k: int):
        if self.pipeline_depth == 0:
            # synchronous flush: lease, search, copy the results to the host
            def flush(padded_queries):
                t0 = time.perf_counter()
                with self.registry.lease(name) as v:
                    # span collector no-ops unless this flush is traced;
                    # the leased version pins which index epoch answered
                    requestlog.add_span("serve/lease",
                                        time.perf_counter() - t0)
                    requestlog.annotate("version", v.version)
                    t1 = time.perf_counter()
                    # materialize before scattering: a future that resolves
                    # is a result the caller can use at memcpy cost, and
                    # the latency histograms measure real work, not async
                    # launches
                    out = tuple(_host(a) for a in v.searcher(padded_queries, k))
                    requestlog.add_span("serve/search",
                                        time.perf_counter() - t1)
                return out

            return flush

        def flush(padded_queries):
            # pipelined flush: dispatch the search and the copy of its
            # results to the host, and hand the pending result to the
            # batcher's completion stage. The registry lease is held until
            # materialization — an in-flight flush still finishes on the
            # version it leased, and retire-after-drain waits for it
            t0 = time.perf_counter()
            stack = contextlib.ExitStack()
            v = stack.enter_context(self.registry.lease(name))
            try:
                requestlog.add_span("serve/lease", time.perf_counter() - t0)
                requestlog.annotate("version", v.version)
                t1 = time.perf_counter()
                with obs_dispatch.count() as dc:
                    out = v.searcher(padded_queries, k)
                host, done = _start_copy_to_host(out)
                requestlog.add_span("serve/dispatch",
                                    time.perf_counter() - t1)
            except BaseException:
                # a dispatch that raises fails only its own batch — and
                # must not strand the lease (the version could never
                # retire)
                stack.close()
                raise

            def materialize(_host_out=host, _done=done, _t1=t1, _stack=stack):
                try:
                    if _done is not None:
                        _done.synchronize()
                    res = tuple(_host(a) for a in _host_out)
                    requestlog.add_span("serve/search",
                                        time.perf_counter() - _t1)
                    return res
                finally:
                    _stack.close()

            # uninstrumented searchers (plain sealed indexes) count as one
            # dispatch site — the searcher call itself
            return PendingFlush(materialize,
                                dispatches=dc.total if dc.total else 1)

        return flush

    def submit(self, name: str, queries, k: int = 10, *,
               timeout_s: float | None = None,
               rid: str | None = None) -> Future:
        """Enqueue a ``(rows, d)`` query block (rows <= ``max_batch``) for
        index ``name`` at width ``k``; returns a Future resolving to
        ``(distances (rows, k), ids (rows, k))``.

        Fast-fail admission: raises :class:`ServiceClosedError` after
        shutdown, :class:`OverloadedError` at the queue bound, and
        :class:`DeadlineExceededError` when ``timeout_s <= 0``. A queued
        request whose deadline passes before it is drained fails its future
        with :class:`DeadlineExceededError` without touching the device.

        ``rid=`` adopts an externally minted request id for the trace
        (the net front door passes the wire ``X-Raft-Request-Id`` so one
        trace spans wire→queue→flush); ignored when no request log is
        attached.

        Queries are staged as host NumPy (submit never touches the device;
        the flush dispatches one padded bucket-shaped array) and results
        resolve to host NumPy arrays — the serving contract is materialized
        results, not tensors still being written.
        """
        if self._closed:
            raise ServiceClosedError("service is shut down")
        # lease for the validation reads: a concurrent publish may retire
        # the version (nulling its searcher) the instant it is unleased
        with self.registry.lease(name) as v:  # raises for unknown names
            dim, qdtype, ks = v.searcher.dim, v.searcher.query_dtype, v.ks
            device = getattr(v.searcher, "device", None)
        # only published widths are served: an unwarmed k would pay its
        # first calls ON the hot path (and leak a worker thread per stray
        # k). Publish with k=(10, 5, ...) to serve several widths.
        expects(int(k) in ks,
                "k=%d was not published for %r (published widths: %s)",
                k, name, ks)
        q = np.asarray(queries)
        expects(q.ndim == 2, "queries must be (rows, d); got ndim=%d", q.ndim)
        expects(q.shape[1] == dim,
                "query dim %d != index dim %d", q.shape[1], dim)
        if qdtype == "float32":
            q = np.asarray(q, np.float32)
        else:
            expects(str(q.dtype) == qdtype,
                    "byte index %r serves %s queries, got %s", name,
                    qdtype, str(q.dtype))
        n = int(q.shape[0])
        timeout_s = (self.default_timeout_s if timeout_s is None
                     else timeout_s)
        deadline = None
        if timeout_s is not None:
            if timeout_s <= 0:
                if metrics._enabled:
                    _deadline_total().inc(1, stream=f"{name}.k{k}")
                raise DeadlineExceededError("timeout_s <= 0 at submit")
            deadline = self._clock() + timeout_s
        b = self._stream(name, k, dim, qdtype, device)  # re-checks _closed in-lock
        # atomic bounded reservation — the bound is a hard invariant, not a
        # hint, and it is O(1) regardless of how many streams are live;
        # the batcher's on_dequeue callback releases rows at drain
        if not self._rows.try_add(n):
            if metrics._enabled:
                _overload_total().inc(1, name=name)
            if self._slo is not None:
                # the availability objective IS the non-overload admission
                # fraction: shed load burns error budget
                self._slo.record_admission(False)
            raise OverloadedError(
                f"queue at {self._rows.value()}/{self.max_queue_rows} rows; "
                f"request of {n} refused")
        rid = (self._request_log.begin(f"{name}.k{k}", n, rid=rid)
               if self._request_log is not None else None)
        try:
            fut = b.submit(q, deadline=deadline, rid=rid)
        except BaseException:  # closed/shape refusal: release the rows
            self._rows.sub(n)
            raise
        if self._slo is not None:
            self._slo.record_admission(True)
        if metrics._enabled:
            _requests_total().inc(1, stream=f"{name}.k{k}")
        return fut

    # -- write path (stream.MutableIndex names) -------------------------------
    def _mutable(self, name: str):
        if self._closed:
            raise ServiceClosedError("service is shut down")
        with self._lock:
            m = self._mutables.get(name)
        expects(m is not None,
                "%r is not a mutable (stream) index — publish a "
                "raft_tpu_torch.stream.MutableIndex under this name to open "
                "the write path", name)
        return m

    def upsert(self, name: str, rows, ids=None, res=None):
        """Insert/upsert rows into the mutable index published under
        ``name``; returns the global ids. Synchronous, with read-your-writes
        at the service boundary: when this returns, the rows win every later
        search, except during a compaction swap's publish window, where
        flushes still leasing the pre-swap epoch serve its frozen view for
        one flush. Admission as in :meth:`submit`:
        :class:`ServiceClosedError` after shutdown, and a full delta
        memtable raises :class:`raft_tpu_torch.stream.DeltaFullError`, an
        :class:`OverloadedError`, so callers shed write load as they shed
        refused reads. ``res`` carries ``memory_budget_bytes``: a write
        whose delta growth would exceed it raises
        :class:`~raft_tpu_torch.serve.errors.MemoryBudgetError` (also an
        ``OverloadedError``) with nothing written."""
        return self._mutable(name).upsert(rows, ids, res=res)

    def delete(self, name: str, ids) -> int:
        """Tombstone ids on the mutable index published under ``name``;
        returns how many were live. Visible to the very next search (the
        same one-flush swap window as :meth:`upsert`); unknown ids are a
        counted no-op."""
        return self._mutable(name).delete(ids)

    def search(self, name: str, queries, k: int = 10, *,
               timeout_s: float | None = None):
        """Blocking convenience: :meth:`submit` + ``Future.result()``.
        Requires running workers (``start_workers=True``); deterministic
        tests use :meth:`submit` + :meth:`pump` instead."""
        expects(self._start_workers,
                "search() blocks on the worker thread; with "
                "start_workers=False use submit() + pump()")
        return self.submit(name, queries, k, timeout_s=timeout_s).result()

    # -- test / drain hooks -------------------------------------------------
    def pump(self, *, force: bool = False) -> int:
        """Drain-and-flush every stream once, synchronously; returns total
        rows flushed. The deterministic substitute for the worker threads."""
        with self._lock:
            batchers = list(self._batchers.values())
        return sum(b.pump(force=force) for b in batchers)

    def queue_depth(self) -> int:
        return self._rows.value()

    def retry_after_hint(self) -> float:
        """How long an admission-refused caller should wait before
        retrying, from the CURRENT queue depth: the queued rows drain in
        ``ceil(depth / max_batch)`` flushes of at most ``max_wait_us``
        each, so that product is when the queue has provably had a chance
        to empty. Floored at one flush window, capped at 250 ms so a
        momentarily deep queue never tells clients to go away for whole
        seconds (the queue drains far faster than it fills under shed
        load). :func:`~raft_tpu_torch.serve.submit_with_retry` prefers it
        over blind exponential backoff."""
        flushes = max(1, -(-self._rows.value() // self.max_batch))
        return min(0.25, flushes * (self.max_wait_us * 1e-6))

    def staging_stats(self) -> dict:
        """Per-stream staging-buffer counters (uploads, slot reuses,
        accounted byte levels); empty in sync mode (``pipeline_depth=0``)."""
        with self._lock:
            batchers = dict(self._batchers)
        return {f"{name}.k{k}": b._staging.stats()
                for (name, k), b in batchers.items()
                if b._staging is not None}

    # -- shutdown -----------------------------------------------------------
    def shutdown(self, *, drain: bool = True, timeout_s: float = 10.0) -> None:
        """Stop the service. New submits fail fast with
        :class:`ServiceClosedError`; ``drain=True`` completes everything
        already queued (each pending future resolves normally),
        ``drain=False`` fails pending futures with
        :class:`ServiceClosedError`. Idempotent."""
        self._closed = True
        with self._lock:
            batchers = list(self._batchers.values())
        for b in batchers:
            b.close(drain=drain, timeout_s=timeout_s)
