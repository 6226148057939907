"""Versioned index registry with warm, atomic hot-swap.

Counterpart of raft_tpu/serve/registry.py. A production index is rebuilt
continuously; the serving fleet must replace it UNDER LOAD. Three
properties make a swap safe:

1. **Warm before visible** — :meth:`IndexRegistry.publish` runs the new
   index's searcher at every serving bucket shape for every ``k``
   (``_warmup.warm_buckets``) BEFORE flipping the active pointer, so the
   kernels are built and loaded, and the allocator's blocks and cuBLAS
   handles exist, before the first request reaches the new version. The
   report carries each bucket's build attribution
   (:mod:`raft_tpu_torch.obs.compile`): a publish against built kernels
   reports zero builds.
2. **Atomic flip, lease-pinned flushes** — the active pointer changes under
   a lock; an in-flight FLUSH holds a :meth:`lease` on the version it
   resolved and finishes on it. No request ever sees half a swap.
3. **Retire after drain** — an unpublished version is dropped (its
   searcher closure, and with it the registry's reference to the index
   tensors, released) only when its lease count reaches zero.

The registry dispatches through each index module's ``batched_searcher``
hook, so it works uniformly for brute-force, IVF-Flat, IVF-PQ and CAGRA —
including the int8/uint8 byte-dataset variants, whose warmup queries are
drawn in the index's own query dtype.

A :class:`raft_tpu_torch.stream.MutableIndex` publishes through its own
current-epoch searcher. Not yet ported (raises ``RaftError("not yet
ported")``): ``tuned=`` (``tune/apply.py``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from ..core.errors import RaftError, expects, fail
from ..core.resources import default_resources
from ..obs import events as obs_events
from ..obs import mem as obs_mem
from ..obs import metrics

__all__ = ["IndexRegistry", "make_searcher", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


@functools.lru_cache(maxsize=None)
def _swap_total():
    return metrics.counter(
        "raft_tpu_serve_swap_total",
        "hot-swaps (publishes that replaced a live version)")


@functools.lru_cache(maxsize=None)
def _retired_total():
    return metrics.counter(
        "raft_tpu_serve_retired_total",
        "index versions retired after their last lease drained")


@functools.lru_cache(maxsize=None)
def _versions_live():
    return metrics.gauge(
        "raft_tpu_serve_versions_live", "live (leasable) versions per name")


def _not_ported(what: str):
    fail("serve: %s is not yet ported to raft_tpu_torch", what)


def make_searcher(index, search_params=None) -> Callable:
    """Resolve an index object to its module's ``batched_searcher`` hook:
    a ``fn(queries, k) -> (distances, ids)`` closure carrying ``.kind``,
    ``.dim``, ``.query_dtype`` and ``.device`` attributes. Raises for
    unknown types. A :class:`raft_tpu_torch.stream.MutableIndex`
    (duck-typed, so serve never imports stream) resolves to its
    current-epoch searcher; its search params were baked in at wrap time."""
    from ..neighbors import brute_force, cagra, ivf_flat, ivf_pq

    if hasattr(index, "upsert") and hasattr(index, "searcher"):
        expects(search_params is None,
                "a MutableIndex bakes its search params at wrap time; "
                "search_params here would be silently ignored")
        return index.searcher()
    for mod, cls in ((brute_force, brute_force.BruteForce),
                     (ivf_flat, ivf_flat.IvfFlatIndex),
                     (ivf_pq, ivf_pq.IvfPqIndex),
                     (cagra, cagra.CagraIndex)):
        if isinstance(index, cls):
            return mod.batched_searcher(index, search_params)
    raise RaftError(
        f"no serving hook for index type {type(index).__name__!r} "
        "(expected BruteForce, IvfFlatIndex, IvfPqIndex, CagraIndex or "
        "stream.MutableIndex)")


@dataclass
class _Version:
    """One published version of one name. ``leases`` counts in-flight
    flushes pinned to it; ``active=False`` + ``leases==0`` → retire."""

    name: str
    version: int
    searcher: Callable
    published_at: float
    ks: tuple = (10,)  # serving widths this version was published (warmed) for
    active: bool = True
    leases: int = 0
    warm_report: dict = field(default_factory=dict)
    # obs.mem ledger token (owner = the searcher closure): retired at
    # retire-after-drain, released when the closure is actually collected
    # — the gap between the two is the leak the retirement audit catches
    mem: object = None


class IndexRegistry:
    """Thread-safe name → versioned-searcher registry (see module doc)."""

    def __init__(self, *, buckets: tuple = DEFAULT_BUCKETS,
                 clock: Callable[[], float] = time.monotonic):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        expects(bool(self.buckets) and self.buckets[0] >= 1,
                "buckets must be positive batch sizes")
        self._clock = clock
        self._lock = threading.Lock()
        self._active: dict[str, _Version] = {}
        self._versions: dict[str, list[_Version]] = {}
        # publishes serialize PER NAME (warm-then-flip must not interleave
        # for one name), but a slow warm of one index must not block an
        # urgent hot-swap of another; reentrant so service-layer wrappers
        # can hold it around publish() (see publish_lock)
        self._publish_locks: dict[str, threading.RLock] = {}

    # -- publish / swap -----------------------------------------------------
    def publish(self, name: str, index, *, search_params=None,
                k: int | tuple = 10, version: int | None = None,
                warm: bool = True, warm_data=None, tuned=None,
                res=None, warm_hook=None, cause: dict | None = None) -> dict:
        """Make ``(index, search_params)`` the active version of ``name``.

        Warms the searcher at every registry bucket shape for every ``k``
        (pass the tuple of widths production serves) BEFORE the flip, so the
        swap is invisible to the hot path; returns a report with the new
        version number and per-``k`` per-bucket build attribution — a
        publish against built kernels reports ``programs == 0`` and
        ``cache_misses == 0`` everywhere, the hiccup-free-swap proof.
        ``warm=False`` skips warmup. ``warm_data`` (optional (rows, dim)
        sample in the serving query dtype) draws the warmup queries from
        real data instead of uniform noise — the same kernels, representative
        warm-time walls in the report
        (:func:`raft_tpu_torch._warmup.warm_buckets`).

        ``tuned`` (a tune decision) raises "not yet ported": ``tune/apply.py``
        waits for a later slice.

        ``res`` (a :class:`raft_tpu_torch.core.Resources`, default the process
        handle) carries ``memory_budget_bytes``: a publish whose index
        would push the accounted device bytes past the budget raises
        :class:`~raft_tpu_torch.serve.errors.MemoryBudgetError` BEFORE the warm
        spend and before any registry mutation — zero partial state, the
        same whole-or-nothing contract as every admission refusal.

        ``warm_hook`` (``fn(searcher, ks) -> Any``, run only when
        ``warm=True``) extends the warm ladder: it runs on the RESOLVED
        searcher after the bucket warm and, critically, BEFORE the flip —
        the seam a wrapper uses to warm extra serving paths (e.g. the
        pipelined flush path's staging) without a cold window between the
        flip and its own post-publish warm. Its return value lands in
        ``report["warm_hook"]``.

        ``cause`` (a small dict — e.g. the control plane's trigger/decision
        journal seqs) rides the ``serve_published`` event's evidence
        verbatim: an automated republish stays causally chained in the
        journal to the sensor event that advised it.
        """
        from .._warmup import warm_buckets

        src_index = index  # the pre-resolution object, for the budget gate
        if tuned is not None:
            _not_ported("publish(tuned=...) (tune.apply)")
        if callable(index) and hasattr(index, "kind"):
            # pre-built hook: its params are baked into the closure, so a
            # search_params here would be silently ignored — refuse instead
            expects(search_params is None,
                    "search_params has no effect on a pre-built hook "
                    "(%r bakes its own); build the hook with them",
                    getattr(index, "kind", "?"))
            searcher = index
        else:
            searcher = make_searcher(index, search_params)
        # memory-budget admission (no-op unless res.memory_budget_bytes is
        # set): a plain index counts the device bytes the ledger has not
        # already accounted (an obs-enabled build's bytes are in the totals
        # the gate compares); hooks/mutables carry their bytes in their own
        # stream/index entries and add nothing new at publish
        obs_mem.gate(res or default_resources(),
                     lambda: obs_mem.unaccounted_index_bytes(src_index),
                     site="publish", detail=f"publish {name!r}")
        # an admitted plain index joins the ledger under its serving name
        # (idempotent — an obs-enabled build's entry just re-attributes):
        # without this, a SECOND dark-built publish would gate against a
        # total that never learned about the first
        obs_mem.account_index(src_index, name=name)
        ks = (k,) if isinstance(k, int) else tuple(k)
        with self.publish_lock(name):
            # a replacement must preserve the stream contract: batchers pin
            # (d, dtype) per stream and queued requests flush on the version
            # active at drain, so a dim/dtype-changing republish would fail
            # queued batches and wedge the stream. A new contract is a new
            # NAME, validated here BEFORE the warmup spend.
            with self._lock:
                prev = self._active.get(name)
            if prev is not None:
                expects(
                    searcher.dim == prev.searcher.dim
                    and searcher.query_dtype == prev.searcher.query_dtype,
                    "publish(%r): new version serves (%d, %s) but the live "
                    "version serves (%d, %s) — a changed stream contract "
                    "must be published under a new name", name,
                    searcher.dim, searcher.query_dtype,
                    prev.searcher.dim, prev.searcher.query_dtype)
                # widths are part of the contract too: narrowing would serve
                # queued requests of a dropped width unwarmed (flushes lease
                # the NEW version) and lock that width's live callers out
                expects(set(prev.ks) <= set(int(kk) for kk in ks),
                        "publish(%r): live widths %s must be kept (got %s) "
                        "— dropping a width orphans its live stream",
                        name, prev.ks, tuple(ks))
            report: dict = {"name": name, "warmed": warm, "warm": {},
                            # decision key when the hook runs a tune pin
                            # — the publish report says which operating
                            # point went live
                            "tuned": getattr(searcher, "tuned", None)}
            if warm:
                for kk in ks:
                    report["warm"][int(kk)] = warm_buckets(
                        searcher, dim=searcher.dim,
                        dtype=searcher.query_dtype,
                        buckets=self.buckets, k=int(kk),
                        sample=warm_data)
                if warm_hook is not None:
                    report["warm_hook"] = warm_hook(
                        searcher, tuple(int(kk) for kk in ks))
            to_retire: list[_Version] = []
            with self._lock:
                old = self._active.get(name)
                if version is None:
                    version = (old.version + 1) if old is not None else 1
                else:
                    expects(old is None or version > old.version,
                            "version %d must exceed the active version %d",
                            version, old.version if old else -1)
                v = _Version(name, int(version), searcher,
                             self._clock(), ks=tuple(int(kk) for kk in ks),
                             warm_report=report["warm"])
                # liveness entry for the retirement audit (bytes ride the
                # index entries; this tracks the closure that pins them)
                v.mem = obs_mem.account("serve/version", name=name,
                                        epoch=v.version, owner=searcher)
                self._versions.setdefault(name, []).append(v)
                self._active[name] = v
                if old is not None:
                    old.active = False
                    _swap_total().inc(1, name=name)
                    if old.leases == 0:
                        to_retire.append(old)
                        self._versions[name].remove(old)
                _versions_live().set(len(self._versions[name]), name=name)
            for dead in to_retire:
                self._retire(dead)
            report["version"] = v.version
            obs_events.emit(
                "serve_published",
                subject=("serve", name, None, v.version),
                evidence={"swap": old is not None, "warmed": warm,
                          "ks": list(v.ks),
                          **({"cause": dict(cause)} if cause else {})})
            return report

    def publish_lock(self, name: str) -> threading.RLock:
        """The per-name publish serialization lock (reentrant — publish()
        takes it itself). Wrappers that keep name-keyed state consistent
        with the flip (e.g. SearchService's write-path handles) hold it
        AROUND their publish() call so no concurrent publish can interleave
        between the flip and their bookkeeping."""
        with self._lock:
            return self._publish_locks.setdefault(name, threading.RLock())

    def _retire(self, v: _Version) -> None:
        # retirement audit: from here the searcher closure SHOULD become
        # unreachable — obs.mem.audit() reports it as a leak while anything
        # (a cache, a stray strong ref) still pins it
        obs_mem.retire(v.mem)
        # drop the searcher closure — it owns the only registry reference
        # to the index arrays, so this releases them to the allocator
        v.searcher = None
        _retired_total().inc(1, name=v.name)
        obs_events.emit(
            "serve_retired",
            subject=("serve", v.name, None, v.version),
            evidence={"leases": v.leases})

    # -- read side ----------------------------------------------------------
    def active(self, name: str) -> _Version:
        """Metadata access ONLY (``version``/``ks``/``published_at``): the
        returned object is live, and a concurrent publish may retire it —
        nulling ``searcher`` — the instant it is replaced. To CALL the
        searcher, hold a :meth:`lease`."""
        with self._lock:
            v = self._active.get(name)
        if v is None:
            raise RaftError(f"no index published under {name!r}")
        return v

    @contextlib.contextmanager
    def lease(self, name: str):
        """Pin the active version for one flush: yields the version object
        (use ``.searcher``); the version cannot be retired while leased — a
        flush finishes on the version it leased even if a publish flips the
        pointer mid-flush. (Queued requests not yet flushed lease whatever
        is active at their drain; publish enforces that replacements keep
        the stream contract, so that is indistinguishable to callers.)"""
        with self._lock:
            v = self._active.get(name)
            if v is None:
                raise RaftError(f"no index published under {name!r}")
            v.leases += 1
        try:
            yield v
        finally:
            retire = None
            with self._lock:
                v.leases -= 1
                if not v.active and v.leases == 0:
                    retire = v
                    self._versions[v.name].remove(v)
                    _versions_live().set(
                        len(self._versions[v.name]), name=v.name)
            if retire is not None:
                self._retire(retire)

    def names(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._active))

    def live_versions(self, name: str) -> tuple:
        """Version numbers still leasable (active + draining)."""
        with self._lock:
            return tuple(v.version for v in self._versions.get(name, ()))
