"""Dynamic micro-batcher: many callers, few batch shapes.

Counterpart of raft_tpu/serve/batcher.py, with the same bucket ladder,
deadlines, overload rule, padding and scatter. Every search entry point is
a bare library call with a static batch shape; the host-side leverage is to
aggregate concurrent single-query callers into a SMALL FIXED SET of padded
batch shapes, so the serving path runs exactly the shapes the registry
warmed (on the card: the kernels built, the allocator's blocks cached,
cuBLAS handles made) and nothing else.

Mechanics: callers :meth:`MicroBatcher.submit` row blocks and get
``concurrent.futures.Future`` objects; a background worker drains the queue
into the next power-of-two *bucket* (1, 2, 4, ... ``max_batch``), flushing
when ``max_batch`` rows are pending or the oldest request has waited
``max_wait_us``, pads the concatenated rows up to the bucket, runs the flush
function ONCE, and scatters per-row results back to the futures. The bucket
ladder bounds the shape set to ``log2(max_batch)+1`` shapes per stream —
the set :meth:`raft_tpu_torch.serve.registry.IndexRegistry.publish`
pre-warms so a hot-swap never pays a first call on the serving path.

**Pipelined flushes** (``pipeline_depth > 0``): the flush worker does not
block on the device — a flush function may return a :class:`PendingFlush`
(results whose device-to-host copy is in flight plus a ``materialize()``
hook), which the worker hands to a bounded in-flight completion stage and
immediately drains the next batch. Kernel launches are asynchronous, so the
host-to-device copy, compute and device-to-host copy of consecutive flushes
overlap as far as the searcher itself does not wait on the card; a
completion worker materializes results in FIFO order and resolves each
batch's futures. Failure semantics are per-batch on both sides of the
handoff. ``staging=`` (a :class:`~raft_tpu_torch.serve.staging.StagingBuffers`)
replaces the per-flush concat/pad allocations with reusable per-bucket
buffers and starts the device upload at drain time.

Determinism for tests: the wall clock is injected (``clock``) and the worker
thread is optional (``start=False``); :meth:`pump` performs one synchronous
drain-and-flush, so every queue policy (deadline expiry, bucket choice,
occupancy) is assertable without sleeping. In pipelined mode :meth:`pump`
also drains the completion stage (pass ``complete=False`` to hold flushes
in flight and :meth:`complete` them explicitly).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..core import tracing
from ..core.errors import expects
from ..obs import dispatch as obs_dispatch
from ..obs import metrics, requestlog
from .errors import DeadlineExceededError, ServiceClosedError

__all__ = ["MicroBatcher", "PendingFlush", "bucket_sizes", "bucket_for"]

# occupancy = valid rows / bucket rows, in (0, 1]; the ladder resolves the
# half-full-vs-full distinction that drives padding waste
_OCCUPANCY_BUCKETS = (0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


@functools.lru_cache(maxsize=None)
def _queue_depth():
    return metrics.gauge(
        "raft_tpu_serve_queue_depth",
        "rows currently queued in a serve stream (pre-batching)")


@functools.lru_cache(maxsize=None)
def _queue_wait_seconds():
    # paired with _flush_seconds below so a request's p99 decomposes into
    # queue wait vs device/compute — the attribution the autotuner and SLO
    # debugging both read
    return metrics.histogram(
        "raft_tpu_serve_queue_wait_seconds",
        "per-request queue wait from admission (submit) to flush pickup — "
        "the queue share of request latency, device time excluded",
        unit="seconds")


@functools.lru_cache(maxsize=None)
def _flush_seconds():
    return metrics.histogram(
        "raft_tpu_serve_flush_seconds",
        "flush_fn wall per flush (search + materialize) — the "
        "device/compute share of request latency", unit="seconds")


@functools.lru_cache(maxsize=None)
def _occupancy():
    return metrics.histogram(
        "raft_tpu_serve_batch_occupancy",
        "valid rows / bucket rows per flush (1.0 = no padding waste)",
        buckets=_OCCUPANCY_BUCKETS)


@functools.lru_cache(maxsize=None)
def _flush_total():
    return metrics.counter(
        "raft_tpu_serve_flush_total", "flushes per serve stream and bucket")


@functools.lru_cache(maxsize=None)
def _deadline_total():
    return metrics.counter(
        "raft_tpu_serve_deadline_expired_total",
        "requests dropped at drain (or refused at submit) past deadline")


@functools.lru_cache(maxsize=None)
def _error_total():
    return metrics.counter(
        "raft_tpu_serve_flush_errors_total",
        "flushes whose flush_fn raised (all rows in the batch fail)")


@functools.lru_cache(maxsize=None)
def _inflight_gauge():
    return metrics.gauge(
        "raft_tpu_serve_inflight_flushes",
        "flushes dispatched but not yet materialized in a serve stream's "
        "bounded completion stage (pipelined mode; bounded by "
        "pipeline_depth)")


@functools.lru_cache(maxsize=None)
def _dispatches_hist():
    # the scatter-gather fusion meter (obs/dispatch.py): instrumented
    # dispatch sites — searcher calls + host->device transfers on the
    # serve/stream path — executed per flush
    return metrics.histogram(
        "raft_tpu_serve_dispatches_per_flush",
        "instrumented device dispatches (searcher calls + transfers at the "
        "serve/stream sites) per flush — relative fusion meter, not a "
        "kernel-launch count",
        buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0))


def _fail(future: Future, exc: Exception) -> None:
    """set_exception tolerant of a caller's concurrent ``cancel()`` — a
    cancelled future is already resolved, and failing to fail it must not
    kill the worker thread (the rest of the batch still needs its results)."""
    try:
        future.set_exception(exc)
    except Exception:  # cancelled/already-resolved: the caller moved on
        pass


def _host(a):
    """One flush result as a host NumPy array (a CUDA tensor is copied)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def bucket_sizes(max_batch: int) -> tuple[int, ...]:
    """The power-of-two bucket ladder ``(1, 2, 4, ..., max_batch)``."""
    expects(max_batch >= 1 and (max_batch & (max_batch - 1)) == 0,
            "max_batch must be a power of two, got %d", max_batch)
    sizes, b = [], 1
    while b <= max_batch:
        sizes.append(b)
        b *= 2
    return tuple(sizes)


def bucket_for(n_rows: int, max_batch: int) -> int:
    """Smallest ladder bucket holding ``n_rows``."""
    b = 1
    while b < n_rows:
        b *= 2
    return min(b, max_batch)


@dataclass
class _Request:
    rows: object           # (r, d) array, r >= 1
    n: int
    future: Future
    enqueued: float        # clock() at submit
    deadline: float | None  # clock()-domain absolute deadline, or None
    rid: str | None = None  # request-log id minted at admission


@dataclass
class _Drained:
    """One drain's outcome: the batch to flush + expired requests to fail."""

    batch: list = field(default_factory=list)
    rows: int = 0
    expired: list = field(default_factory=list)


class PendingFlush:
    """An un-materialized flush result — what a flush function returns to
    opt into the pipelined completion stage. ``materialize()`` blocks until
    the device work completes and returns the tuple of host result arrays
    (leading dimension = the bucket); it also owns releasing any resource
    the dispatch pinned (the service's flush holds its registry lease until
    here, so an in-flight flush still finishes on the version it leased).
    ``dispatches`` optionally carries the flush's instrumented dispatch
    count (:mod:`raft_tpu_torch.obs.dispatch`) for the per-flush histogram.

    A flush function may return one of these in SYNC mode too (the batcher
    materializes inline, identical semantics) — which is how the service
    ships one flush implementation for both modes."""

    __slots__ = ("materialize", "dispatches")

    def __init__(self, materialize: Callable[[], Sequence],
                 dispatches: int | None = None):
        self.materialize = materialize
        self.dispatches = dispatches


@dataclass
class _InFlight:
    """One dispatched-but-unmaterialized flush in the completion stage."""

    result: object        # PendingFlush, or an already-materialized tuple
    batch: list
    q_host: object        # host view of the padded queries (canary tap)
    n_valid: int
    bucket: int
    now: float            # drain pickup instant (queue-wait boundary)
    t_flush: float        # dispatch start (flush-wall start)
    col: object           # requestlog collector to resume, or None


class MicroBatcher:
    """Thread-safe dynamic micro-batcher for one serve stream.

    ``flush_fn(padded_queries) -> tuple_of_arrays`` receives a
    ``(bucket, d)`` array (zero-padded past the valid rows) and must return
    a tuple/list of arrays whose leading dimension is ``bucket`` (e.g.
    ``(distances, ids)``); the batcher slices rows back per request. Rows
    beyond the valid count are padding — their results are discarded, so
    the flush function never needs a mask.

    One batcher serves ONE stream (one index name at one ``k``): all
    submissions must share ``d`` and dtype, otherwise they could not share
    a batch shape. The service layer keys batchers by ``(name, k)``.

    ``pipeline_depth`` bounds the in-flight completion stage (0 = fully
    synchronous, the pre-pipeline behavior): a flush function returning a
    :class:`PendingFlush` is handed off un-materialized and the worker
    immediately drains the next batch; a dedicated completion worker
    (``start=True``) materializes FIFO. ``staging`` (a
    :class:`~raft_tpu_torch.serve.staging.StagingBuffers` matching this stream's
    bucket ladder and row contract) replaces concat/pad assembly with
    reusable buffers and an early device upload.
    """

    def __init__(self, flush_fn: Callable[[object], Sequence],
                 *, max_batch: int = 64, max_wait_us: float = 1000.0,
                 clock: Callable[[], float] = time.monotonic,
                 stream: str = "default", start: bool = True,
                 on_dequeue: Callable[[int], None] | None = None,
                 request_log=None, slo=None,
                 on_result: Callable | None = None,
                 pipeline_depth: int = 0, staging=None):
        expects(max_wait_us >= 0, "max_wait_us must be >= 0")
        expects(pipeline_depth >= 0, "pipeline_depth must be >= 0")
        self._flush_fn = flush_fn
        # observability taps (all optional, all OFF the result path):
        # request_log records per-request span traces, slo feeds the
        # latency objective from the queue-wait/flush decomposition, and
        # on_result(valid_queries, valid_outputs) is the recall canary's
        # flush tap — a raising tap must never fail the batch
        self._request_log = request_log
        self._slo = slo
        self._on_result = on_result
        self.max_batch = int(max_batch)
        self.buckets = bucket_sizes(self.max_batch)
        self.max_wait_s = float(max_wait_us) * 1e-6
        self._clock = clock
        self.stream = stream
        self._cond = threading.Condition()
        self._pending: list[_Request] = []
        self._pending_rows = 0
        # rows must share one batch shape: the first submission pins the
        # stream's (d, dtype) and mismatches fail at the door — a mismatch
        # reaching batch assembly would kill the worker mid-flush instead
        self._row_shape: tuple | None = None
        # notified (rows removed) whenever queued rows leave the queue —
        # the service's O(1) admission counter; must only take leaf locks
        self._on_dequeue = on_dequeue
        self._closed = False
        self.pipeline_depth = int(pipeline_depth)
        self._staging = staging
        # the bounded in-flight completion stage: dispatched flushes whose
        # device results have not materialized yet (pipelined mode only)
        self._inflight: collections.deque = collections.deque()
        self._inflight_cond = threading.Condition()
        # set (under _inflight_cond) when the flush worker's final drain is
        # done — the completion worker must outlive the PRODUCER, not just
        # the closed flag: exiting on a momentarily-empty stage while the
        # worker still drains backlog would strand it blocked on the bound
        self._flush_worker_done = False
        self._worker: threading.Thread | None = None
        self._completer: threading.Thread | None = None
        if start:
            self._worker = threading.Thread(
                target=self._run, name=f"raft-serve-{stream}", daemon=True)
            self._worker.start()
            if self.pipeline_depth > 0:
                self._completer = threading.Thread(
                    target=self._run_completions,
                    name=f"raft-serve-{stream}-complete", daemon=True)
                self._completer.start()

    # -- submission ---------------------------------------------------------
    def submit(self, rows, *, deadline: float | None = None,
               rid: str | None = None) -> Future:
        """Enqueue a ``(r, d)`` row block; returns a Future resolving to the
        per-row slice of the flush result. ``deadline`` is absolute, in the
        injected clock's domain; ``rid`` is the request-log id minted at
        admission (traced through the flush). Raises
        :class:`ServiceClosedError` after :meth:`close`; a request wider
        than ``max_batch`` is refused (split at the caller — one request
        never spans two flushes)."""
        expects(getattr(rows, "ndim", 0) == 2,
                "submit expects a (rows, d) block")
        n = int(rows.shape[0])
        expects(1 <= n <= self.max_batch,
                "request rows (%d) must be in [1, max_batch=%d]",
                n, self.max_batch)
        shape = (int(rows.shape[1]), str(rows.dtype))
        fut: Future = Future()
        now = self._clock()
        with self._cond:
            if self._closed:
                raise ServiceClosedError(f"stream {self.stream!r} is closed")
            if self._row_shape is None:
                self._row_shape = shape
            else:
                expects(shape == self._row_shape,
                        "stream %r batches (*, %d) %s rows; got (*, %d) %s",
                        self.stream, self._row_shape[0], self._row_shape[1],
                        shape[0], shape[1])
            self._pending.append(_Request(rows, n, fut, now, deadline, rid))
            self._pending_rows += n
            if metrics._enabled:
                _queue_depth().set(self._pending_rows, stream=self.stream)
            self._cond.notify()
        return fut

    def pending_rows(self) -> int:
        with self._cond:
            return self._pending_rows

    # -- draining -----------------------------------------------------------
    def _next_deadline_locked(self) -> float | None:
        dls = [r.deadline for r in self._pending if r.deadline is not None]
        return min(dls) if dls else None

    def _ready_locked(self, now: float) -> bool:
        if not self._pending:
            return False
        if self._closed or self._pending_rows >= self.max_batch:
            return True
        return now - self._pending[0].enqueued >= self.max_wait_s

    def _sweep_expired_locked(self, now: float) -> list:
        """Remove expired requests ANYWHERE in the queue — before batching,
        so they consume no device time. Expiry is decoupled from flush
        readiness on purpose: one tight-deadline client must not trigger an
        early under-full flush of its fresh queue-mates (the worker wakes
        for the earliest deadline, sweeps, and goes back to waiting)."""
        expired = [r for r in self._pending
                   if r.deadline is not None and now >= r.deadline]
        if not expired:
            return []
        self._pending = [r for r in self._pending
                         if r.deadline is None or now < r.deadline]
        removed = sum(r.n for r in expired)
        self._pending_rows = max(self._pending_rows - removed, 0)
        if metrics._enabled:
            _queue_depth().set(self._pending_rows, stream=self.stream)
            _deadline_total().inc(len(expired), stream=self.stream)
        if self._on_dequeue is not None:
            self._on_dequeue(removed)
        return expired

    def _drain_locked(self, now: float) -> _Drained:
        """Pop up to ``max_batch`` rows of whole requests (expired ones were
        already swept by the caller at the same ``now``). Caller-cancelled
        futures are dropped (cancellation is honored as long as the request
        has not been drained; once drained, ``set_running_or_notify_cancel``
        pins the future so the flush's ``set_result`` cannot race a late
        ``cancel()``)."""
        out = _Drained()
        removed_start = self._pending_rows
        while self._pending:
            r = self._pending[0]
            if out.rows + r.n > self.max_batch:
                break
            self._pending.pop(0)
            if not r.future.set_running_or_notify_cancel():
                self._pending_rows -= r.n  # cancelled while queued: drop
                continue
            out.batch.append(r)
            out.rows += r.n
        self._pending_rows = max(self._pending_rows - out.rows, 0)
        if metrics._enabled:
            _queue_depth().set(self._pending_rows, stream=self.stream)
        removed = removed_start - self._pending_rows
        if removed and self._on_dequeue is not None:
            self._on_dequeue(removed)
        return out

    def _flush_expired(self, drained: _Drained, now: float) -> None:
        for r in drained.expired:
            if self._request_log is not None:
                self._request_log.complete(
                    r.rid, stream=self.stream, rows=r.n,
                    spans={"queue": now - r.enqueued},
                    outcome="expired")
            if self._slo is not None:
                # an expired request IS a latency-bad outcome: the caller
                # waited its full deadline and got an error — a saturated
                # service shedding at the deadline must burn the latency
                # budget, not report 'ready' over the surviving minority
                self._slo.record_request(now - r.enqueued, float("inf"))
            _fail(r.future, DeadlineExceededError(
                f"deadline expired after {now - r.enqueued:.6f}s in queue "
                f"(stream {self.stream!r})"))

    def _flush(self, drained: _Drained, now: float) -> int:
        # Batch assembly and result scatter are PURE NumPy on purpose: the
        # device sees only the padded (bucket, d) array, one upload a flush,
        # at a shape the registry warmed.
        self._flush_expired(drained, now)
        batch = drained.batch
        if not batch:
            return 0
        n_valid = drained.rows
        bucket = bucket_for(n_valid, self.max_batch)
        if metrics._enabled:
            # `now` is the drain/pickup instant: submit -> here is pure
            # queueing; dispatch->materialize below is the flush share, so
            # the two histograms decompose the request's latency
            for r in batch:
                _queue_wait_seconds().observe(now - r.enqueued,
                                              stream=self.stream)
            _occupancy().observe(n_valid / bucket, stream=self.stream)
            _flush_total().inc(1, stream=self.stream, bucket=bucket)
        t_flush = now  # assembly failures still get a sane flush wall
        col = None
        try:
            # assembly stays INSIDE the guard: the drained futures are
            # already pinned (set_running_or_notify_cancel), so any escape
            # here would kill the worker and strand them unresolved
            staged_dispatches = 0
            if self._staging is not None:
                # reusable per-bucket staging: rows written in place, pad
                # zeroed, device upload started at drain time (the H2D for
                # this flush overlaps the previous flush's compute). The
                # upload is a counted dispatch site, but the flush_fn's
                # counter is not open yet — meter it here and fold it into
                # this flush's dispatch observation below
                with obs_dispatch.count() as sdc:
                    q_host, q = self._staging.stage(
                        [np.asarray(r.rows) for r in batch], n_valid,
                        bucket)
                staged_dispatches = sdc.total
            else:
                q = (np.asarray(batch[0].rows) if len(batch) == 1
                     else np.concatenate([np.asarray(r.rows) for r in batch]))
                if n_valid < bucket:
                    pad = np.zeros((bucket - n_valid,) + q.shape[1:], q.dtype)
                    q = np.concatenate([q, pad])
                q_host = q
            with tracing.range("serve/flush/%d", bucket):
                t_flush = self._clock()
                # span collector: the flush fn (and anything below it —
                # registry lease, stream search) records its stage walls
                # against this batch's request ids; completion RESUMES it
                collector = (requestlog.collect()
                             if self._request_log is not None
                             else contextlib.nullcontext())
                with collector as col:
                    res = self._flush_fn(q)
        except Exception as e:
            _error_total().inc(1, stream=self.stream)
            flush_dt = self._clock() - t_flush
            for r in batch:
                _fail(r.future, e)
            spans, notes = (col.spans, col.notes) if col is not None \
                else ({}, {})
            self._observe_batch(batch, now, bucket, flush_dt, spans, notes,
                                outcome="error")
            return n_valid
        if metrics._enabled:
            d = getattr(res, "dispatches", None)
            if d is not None:
                _dispatches_hist().observe(d + staged_dispatches,
                                           stream=self.stream)
        entry = _InFlight(res, batch, q_host, n_valid, bucket, now, t_flush,
                          col)
        if self.pipeline_depth > 0 and isinstance(res, PendingFlush):
            # async dispatch: the device result rides to the bounded
            # completion stage and THIS thread immediately drains the next
            # batch — consecutive flushes overlap under async kernel launches
            self._hand_off(entry)
        else:
            self._complete_entry(entry)
        return n_valid

    # -- completion stage ----------------------------------------------------
    def _complete_entry(self, e: _InFlight) -> None:
        """Materialize one flush and resolve exactly its batch's futures.
        Runs inline (sync mode / pump) or on the completion worker; a
        materialize that raises fails ONLY this batch — per-batch failure
        attribution survives the handoff."""
        batch = e.batch
        try:
            # resume the dispatch-time span collector so completion-side
            # spans (serve/search) land on the same batch's trace
            collector = (requestlog.collect(resume=e.col)
                         if e.col is not None else contextlib.nullcontext())
            with collector:
                res = e.result
                if isinstance(res, PendingFlush):
                    res = res.materialize()
                out = tuple(_host(a) for a in res)
            flush_dt = self._clock() - e.t_flush
            if metrics._enabled:
                # flush share = dispatch -> materialized (includes any wait
                # in the completion stage): queue_wait + flush still covers
                # a request's life exactly
                _flush_seconds().observe(flush_dt, stream=self.stream)
        except Exception as exc:
            _error_total().inc(1, stream=self.stream)
            flush_dt = self._clock() - e.t_flush
            for r in batch:
                _fail(r.future, exc)
            spans, notes = (e.col.spans, e.col.notes) if e.col is not None \
                else ({}, {})
            self._observe_batch(batch, e.now, e.bucket, flush_dt, spans,
                                notes, outcome="error")
            return
        off = 0
        for r in batch:
            r.future.set_result(tuple(a[off:off + r.n] for a in out))
            off += r.n
        # observability taps run AFTER the futures resolve: the request
        # log / SLO loops and the canary's per-row sampling must never add
        # to any caller's observed latency
        spans, notes = (e.col.spans, e.col.notes) if e.col is not None \
            else ({}, {})
        self._observe_batch(batch, e.now, e.bucket, flush_dt, spans, notes,
                            outcome="ok")
        if self._on_result is not None:
            try:
                # the staging host view stays valid through completion (the
                # buffer rotation covers the in-flight window) and the
                # canary copies the rows it keeps
                self._on_result(e.q_host[:e.n_valid],
                                tuple(a[:e.n_valid] for a in out))
            except Exception:  # a canary tap must never fail the batch
                pass

    def _set_inflight_gauge(self, n: int) -> None:
        if metrics._enabled:
            _inflight_gauge().set(n, stream=self.stream)

    def _hand_off(self, entry: _InFlight) -> None:
        """Queue one dispatched flush for completion, enforcing the bound:
        with a live completion worker the flush worker BLOCKS here when
        ``pipeline_depth`` flushes are in flight (backpressure keeps the
        device queue bounded); without one (pump-driven tests) the oldest
        entry completes inline to preserve the bound deterministically."""
        to_complete = []
        with self._inflight_cond:
            if self._completer is not None:
                # the bound holds even while closing: the shutdown drain
                # flushes the backlog through this same path, and an
                # unbounded stage would outrun the staging-buffer
                # rotation (sized depth+2). Blocking stays live — the
                # completion worker only exits once the stage is empty,
                # so it keeps popping while anything is in flight
                while len(self._inflight) >= self.pipeline_depth:
                    self._inflight_cond.wait()
            else:
                while len(self._inflight) >= self.pipeline_depth:
                    to_complete.append(self._inflight.popleft())
            self._inflight.append(entry)
            n = len(self._inflight)
            self._inflight_cond.notify_all()
        self._set_inflight_gauge(n)
        for e in to_complete:
            self._complete_entry(e)

    def complete(self, max_n: int | None = None) -> int:
        """Materialize up to ``max_n`` in-flight flushes inline, oldest
        first (all of them when ``None``); returns how many completed. The
        deterministic test/drain hook for pipelined mode — with running
        workers the completion thread does this continuously."""
        done = 0
        while max_n is None or done < max_n:
            with self._inflight_cond:
                if not self._inflight:
                    break
                e = self._inflight.popleft()
                n = len(self._inflight)
                self._inflight_cond.notify_all()
            self._set_inflight_gauge(n)
            self._complete_entry(e)
            done += 1
        return done

    def inflight(self) -> int:
        with self._inflight_cond:
            return len(self._inflight)

    def _run_completions(self) -> None:
        while True:
            with self._inflight_cond:
                # exit requires closed AND the flush worker finished its
                # final drain: a momentarily-empty stage mid-shutdown does
                # not mean the producer is done, and leaving early would
                # strand it blocked on the in-flight bound
                while not self._inflight and not (self._closed
                                                  and self._flush_worker_done):
                    self._inflight_cond.wait()
                if not self._inflight:
                    return  # closed and the producer drained
                e = self._inflight.popleft()
                n = len(self._inflight)
                self._inflight_cond.notify_all()
            self._set_inflight_gauge(n)
            try:
                self._complete_entry(e)
            except BaseException:  # pragma: no cover - _complete_entry
                pass  # already guards; the completion worker must not die

    def _observe_batch(self, batch, now: float, bucket: int, flush_dt: float,
                       spans: dict, notes: dict, outcome: str) -> None:
        """Per-request observability after one flush: the request-log trace
        (queue span per request + the batch's shared flush/stage spans) and
        the SLO latency objective (queue wait + flush wall vs the bound; a
        failed flush counts as latency-bad — the caller got an error after
        waiting)."""
        if self._request_log is None and self._slo is None:
            return
        for r in batch:
            wait = now - r.enqueued
            if self._request_log is not None:
                self._request_log.complete(
                    r.rid, stream=self.stream, rows=r.n, bucket=bucket,
                    spans={"queue": wait, "flush": flush_dt, **spans},
                    notes=notes, outcome=outcome)
            if self._slo is not None:
                self._slo.record_request(
                    wait, flush_dt if outcome == "ok" else float("inf"))

    def pump(self, *, force: bool = False, complete: bool = True) -> int:
        """Synchronously sweep expired requests, then drain-and-flush once if
        the flush condition holds; returns rows flushed (0 when nothing
        flushed — pass ``force=True`` to flush regardless, e.g. when
        draining at shutdown). This is the deterministic test/drain entry;
        the worker thread uses the same sweep/drain path. In pipelined mode
        the completion stage is drained afterwards so a pumped flush's
        futures are resolved on return; ``complete=False`` leaves flushes
        in flight (drive them with :meth:`complete` — the out-of-order
        completion test hook). With a live completion worker that thread
        owns completion and ``complete`` is ignored."""
        now = self._clock()
        with self._cond:
            expired = self._sweep_expired_locked(now)
            drained = (self._drain_locked(now)
                       if force or self._ready_locked(now) else _Drained())
            drained.expired = expired
        n = self._flush(drained, now)
        if complete and self._completer is None:
            self.complete()
        return n

    # -- worker -------------------------------------------------------------
    def _run(self) -> None:
        try:
            self._run_loop()
        finally:
            # however this thread exits (clean drain or an escape), the
            # completion worker may now stop once the stage empties
            with self._inflight_cond:
                self._flush_worker_done = True
                self._inflight_cond.notify_all()

    def _run_loop(self) -> None:
        while True:
            with self._cond:
                now = self._clock()
                expired = self._sweep_expired_locked(now)
                while (not expired and not self._closed
                       and not self._ready_locked(now)):
                    if self._pending:
                        elapsed = now - self._pending[0].enqueued
                        timeout = self.max_wait_s - elapsed
                        nd = self._next_deadline_locked()
                        if nd is not None:  # wake for the earliest deadline
                            timeout = min(timeout, nd - now)
                        self._cond.wait(max(timeout, 0.0))
                    else:
                        self._cond.wait()
                    now = self._clock()
                    expired = self._sweep_expired_locked(now)
                if self._closed and not self._pending and not expired:
                    return
                drained = (self._drain_locked(now)
                           if self._closed or self._ready_locked(now)
                           else _Drained())
                drained.expired = expired
            self._flush(drained, now)

    def close(self, *, drain: bool = True, timeout_s: float = 10.0) -> None:
        """Stop the stream. ``drain=True`` flushes everything still queued
        (each remaining request completes normally); ``drain=False`` fails
        pending futures with :class:`ServiceClosedError`. Idempotent."""
        with self._cond:
            self._closed = True
            if not drain:
                pending, self._pending = self._pending, []
                cleared, self._pending_rows = self._pending_rows, 0
                if metrics._enabled:
                    _queue_depth().set(0, stream=self.stream)
                if cleared and self._on_dequeue is not None:
                    self._on_dequeue(cleared)
            self._cond.notify_all()
        with self._inflight_cond:
            # wake the completion worker's idle wait (it checks _closed);
            # a flush worker blocked on backpressure stays bounded and is
            # released flush by flush as the completer drains the stage
            self._inflight_cond.notify_all()
        if not drain:
            for r in pending:
                _fail(r.future, ServiceClosedError(
                    f"stream {self.stream!r} shut down with drain=False"))
        if self._worker is not None:
            self._worker.join(timeout_s)
            self._worker = None
        if self._completer is not None:
            # after the flush worker joined nothing appends; the completion
            # worker drains the stage and exits
            self._completer.join(timeout_s)
            self._completer = None
        if drain:
            # whether or not a worker existed, anything still queued (e.g.
            # submitted in the join race, or no-worker mode) flushes here
            while self.pump(force=True):
                pass
        # in-flight flushes complete either way: their futures are already
        # pinned running, and no future is ever left unresolved
        self.complete()
        if self._staging is not None:
            self._staging.release()
