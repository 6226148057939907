"""Background compaction: watermark-triggered delta folds with a warm hot-swap.

Counterpart of raft_tpu/stream/compactor.py, the compaction half of the LSM
lifecycle: a :class:`Compactor` watches one
:class:`~raft_tpu_torch.stream.MutableIndex` and, when a watermark trips,
folds the delta memtable into a new sealed index off the serving path, then
republishes through a :class:`~raft_tpu_torch.serve.IndexRegistry` /
:class:`~raft_tpu_torch.serve.SearchService`, so the swap is warm before it
is visible and in-flight leases drain on the old epoch.

Watermarks (:class:`CompactionPolicy`):

- ``delta_fill`` — the memtable is nearly full: fold before writers meet
  :class:`~raft_tpu_torch.stream.DeltaFullError` (extend compaction for the
  IVF kinds: encode and re-pack, no retraining).
- ``tombstone_ratio`` — dead sealed slots waste scan work: reclaim them
  with a rebuild (the only mode that drops tombstoned rows). Armed only
  when the index ``can_rebuild``.
- ``max_age_s`` — freshness bound: a trickle of writes that never fills the
  memtable is still folded within this horizon (on an injected clock).

The worker thread is a thin poll loop around :meth:`Compactor.run_once`,
which tests and ``chip_smoke.py``'s churn phase drive directly.

A :class:`~raft_tpu_torch.stream.ShardedMutableIndex` is driven unchanged:
its ``stats()`` reports the binding shard's watermarks and its ``compact()``
folds one shard a call, so one ``run_once`` is one staggered shard fold and
one warm republish. Over a mesh the policy's reshard watermarks
(``reshard_rows_per_shard`` / ``reshard_min_rows_per_shard``) also arm the
reshard advisory (``last_advice``, the ``reshard_advised`` /
``reshard_advice_cleared`` events): advice only, applied by whoever calls
``reshard``. ``drift=`` (an :class:`raft_tpu_torch.obs.quality.DriftDetector`)
gets the corpus-side feed of each fold.
"""

from __future__ import annotations

import functools
import inspect
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable

from ..core.errors import expects
from ..obs import events as obs_events
from ..obs import metrics
from .mutable import MutableIndex

__all__ = ["CompactionPolicy", "Compactor"]

# per-Compactor journal transition keys (see last_advice)
_compactor_ids = itertools.count()


@functools.lru_cache(maxsize=None)
def _c_compactions():
    return metrics.counter(
        "raft_tpu_stream_compactions_total",
        "compactions by trigger watermark and fold mode")


@functools.lru_cache(maxsize=None)
def _h_wall():
    return metrics.histogram(
        "raft_tpu_stream_compaction_seconds",
        "compaction wall seconds (fold + warm + publish, off the hot path)",
        unit="seconds")


@functools.lru_cache(maxsize=None)
def _c_compile():
    return metrics.counter(
        "raft_tpu_stream_compaction_compile_seconds_total",
        "kernel-build seconds spent inside compactions (publish warms "
        "the new sealed index here, never on the search hot path)",
        unit="seconds")


@functools.lru_cache(maxsize=None)
def _c_swaps():
    return metrics.counter(
        "raft_tpu_stream_swap_total",
        "compaction hot-swaps published through the serve registry")


@functools.lru_cache(maxsize=None)
def _c_failures():
    return metrics.counter(
        "raft_tpu_stream_compaction_failures_total",
        "compaction attempts that raised (see last_error and the WARNING "
        "log line)")


@functools.lru_cache(maxsize=None)
def _c_reshard_advised():
    return metrics.counter(
        "raft_tpu_reshard_advised_total",
        "reshard advisories emitted by the Compactor's per-shard row "
        "watermarks (once per transition; auto_apply is always False — an "
        "operator or controller calls ShardedMutableIndex.reshard)")


@functools.lru_cache(maxsize=None)
def _c_deferred():
    return metrics.counter(
        "raft_tpu_stream_compaction_deferred_total",
        "due compactions deferred by the external pacing hint (a "
        "controller's SLO-burn signal — compaction waits out a latency "
        "burn instead of competing with the serve path)")


@dataclass(frozen=True)
class CompactionPolicy:
    """Watermarks that arm :meth:`Compactor.run_once` (see module doc).
    ``None`` disables a watermark; see docs/streaming.md for tuning.

    ``reshard_rows_per_shard`` / ``reshard_min_rows_per_shard`` are the
    ADVISORY topology watermarks of a sharded mesh: when the mean live rows
    per shard cross the high (low) mark, the Compactor emits one
    ``reshard_advised`` event per transition recommending a power-of-two
    split (merge). Advice only (``auto_apply: False``): the fold stays in
    :meth:`raft_tpu_torch.stream.ShardedMutableIndex.reshard`."""

    delta_fill: float | None = 0.75
    tombstone_ratio: float | None = 0.25
    max_age_s: float | None = None
    reshard_rows_per_shard: int | None = None
    reshard_min_rows_per_shard: int | None = None


class Compactor:
    """Watermark-driven compaction for one mutable index (see module doc).

    ``publisher`` is optional: a :class:`~raft_tpu_torch.serve.SearchService`
    or :class:`~raft_tpu_torch.serve.IndexRegistry` (anything with ``publish``) plus
    ``name``/``ks`` — each compaction then republishes the post-swap
    searcher, warming the new sealed shapes BEFORE the flip (the zero-cold-
    build swap). Without one, the swap still happens atomically and direct
    ``MutableIndex.search`` callers pay their own first calls.

    ``drift`` (an :class:`raft_tpu_torch.obs.quality.DriftDetector`) re-runs
    the tune family classifier on compaction-time corpus stats: each fold
    that leaves a retained row store feeds a corpus subsample plus the live
    row count into :meth:`DriftDetector.check` (the corpus-side half of the
    drift -> retune loop; the query-side half rides the recall canary).

    ``clock`` is injected for the age watermark and the tests; the
    background worker (``start()``) polls ``run_once`` on the real wall
    clock and exists for deployments — tests drive :meth:`run_once`
    directly, with no sleeps.
    """

    def __init__(self, mutable: MutableIndex, *, publisher=None,
                 name: str | None = None, ks=(10,),
                 policy: CompactionPolicy = CompactionPolicy(),
                 warm_data=None, drift=None, pacing=None,
                 clock: Callable[[], float] | None = None,
                 poll_interval_s: float = 0.05):
        expects(publisher is None or hasattr(publisher, "publish"),
                "publisher must expose publish() (SearchService or "
                "IndexRegistry)")
        expects(publisher is None or name is not None,
                "a publisher needs the published name")
        self._mutable = mutable
        # a sharded index picks WHICH shard to fold from the tripped
        # watermark (an age trip chases the stalest shard); a plain
        # MutableIndex.compact takes no trigger
        self._compact_takes_trigger = (
            "trigger" in inspect.signature(mutable.compact).parameters)
        self._publisher = publisher
        self._pub_name = name
        self._ks = (ks,) if isinstance(ks, int) else tuple(ks)
        self.policy = policy
        self._warm_data = warm_data
        expects(drift is None or hasattr(drift, "check"),
                "drift must be an obs.quality.DriftDetector (check())")
        self._drift = drift
        # external pacing hint (zero-arg callable -> truthy = defer):
        # wired by a controller feeding its SLO-burn signal so a due fold
        # waits out a latency burn (run_once; force= overrides). Default
        # None = scheduling behavior unchanged.
        expects(pacing is None or callable(pacing),
                "pacing must be a zero-arg callable returning truthy to "
                "defer (e.g. control.Controller wires one)")
        self._pacing = pacing
        self.last_deferred: str | None = None
        # default to the MUTABLE's clock: the age watermark subtracts this
        # clock's now from delta_oldest_at stamps taken with the mutable's —
        # two different time bases would silently disable (or constantly
        # trip) max_age_s
        self._clock = mutable._clock if clock is None else clock
        self._poll_s = float(poll_interval_s)
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        self.last_report: dict | None = None
        self.last_error: BaseException | None = None
        # the standing reshard advisory lives in the event journal's
        # transition store, keyed per instance; last_advice reads it
        self._advice_tkey = ("compactor/reshard_advice",
                             next(_compactor_ids))

    # -- pacing --------------------------------------------------------------
    def set_pacing(self, fn) -> None:
        """(Re)wire the external pacing hint after construction — what
        :meth:`raft_tpu_torch.control.Controller.attach_compactor` calls.
        ``None`` unwires it (default scheduling restored)."""
        expects(fn is None or callable(fn),
                "pacing must be a zero-arg callable or None")
        self._pacing = fn

    def _defer(self) -> bool:
        if self._pacing is None:
            return False
        try:
            return bool(self._pacing())
        except Exception:  # a broken hint must never stall compaction
            return False

    # -- watermarks ---------------------------------------------------------
    def due(self) -> str | None:
        """The tripped watermark name, or None. Priority order: reclaim
        (rebuild) beats fold (extend) beats freshness — a rebuild subsumes
        the other two anyway."""
        p = self.policy
        st = self._mutable.stats()
        if (p.tombstone_ratio is not None
                and st["tombstone_ratio"] >= p.tombstone_ratio
                and self._mutable.can_rebuild):
            return "tombstone_ratio"
        if (p.delta_fill is not None and st["delta_fill"] >= p.delta_fill):
            return "delta_fill"
        if (p.max_age_s is not None and st["delta_oldest_at"] is not None
                and self._clock() - st["delta_oldest_at"] >= p.max_age_s):
            return "age"
        return None

    @property
    def last_advice(self) -> dict | None:
        """The STANDING reshard advisory: a dict while a topology watermark
        stays crossed, None once it clears (and always None for an index
        that cannot reshard). A view over the event journal's transition
        store, consistent with the ``reshard_advised`` /
        ``reshard_advice_cleared`` events."""
        return obs_events.transition_payload(self._advice_tkey)

    def _check_reshard(self) -> dict | None:
        """Evaluate the advisory topology watermarks: updates
        :attr:`last_advice` and emits ``reshard_advised`` (journal entry,
        counter and WARNING) or ``reshard_advice_cleared`` exactly once per
        transition. None for an index without ``reshard``."""
        p = self.policy
        if (p.reshard_rows_per_shard is None
                and p.reshard_min_rows_per_shard is None):
            return None
        if not hasattr(self._mutable, "reshard"):
            return None
        st = self._mutable.stats()
        shards = st.get("shards")
        if not shards:
            return None
        per = st["live"] / shards
        advice = None
        if (p.reshard_rows_per_shard is not None
                and per >= p.reshard_rows_per_shard):
            advice = {"action": "split", "target": 2 * shards,
                      "watermark": "reshard_rows_per_shard",
                      "threshold": p.reshard_rows_per_shard}
        elif (p.reshard_min_rows_per_shard is not None and shards > 1
                and shards % 2 == 0  # reshard() halves even counts only
                and per <= p.reshard_min_rows_per_shard):
            advice = {"action": "merge", "target": shards // 2,
                      "watermark": "reshard_min_rows_per_shard",
                      "threshold": p.reshard_min_rows_per_shard}
        key = ((advice["action"], advice["target"])
               if advice is not None else None)
        # the payload carries the measured evidence inline, so a controller
        # decides (and a postmortem replays) from the journal alone
        payload = None if advice is None else dict(
            advice, name=self._mutable.name, shards=shards,
            live=int(st["live"]),
            rows_per_shard=round(per, 1), auto_apply=False)
        if not obs_events.transition(self._advice_tkey, key, payload):
            return self.last_advice
        if advice is None:
            obs_events.emit(
                "reshard_advice_cleared",
                subject=("compactor", self._mutable.name, None, None),
                evidence={"shards": shards,
                          "rows_per_shard": round(per, 1)})
            return None
        obs_events.emit(
            "reshard_advised",
            subject=("compactor", self._mutable.name, None, None),
            evidence=payload,
            counter=_c_reshard_advised,
            counter_labels={"name": self._mutable.name,
                            "action": advice["action"]},
            message=(
                "reshard advised for %r: %s to %d shards (%.0f live "
                "rows/shard crossed %s=%d); advisory only — call "
                "reshard(%d) to apply"),
            log_args=(self._mutable.name, advice["action"],
                      advice["target"], per, advice["watermark"],
                      advice["threshold"], advice["target"]))
        return self.last_advice

    # -- one compaction cycle ----------------------------------------------
    def run_once(self, *, force: bool = False, mode: str | None = None,
                 res=None) -> dict | None:
        """Check watermarks and run one fold+swap(+publish) if due; returns
        the compaction report (with ``trigger`` and, when publishing, the
        publish report under ``publish``) or None when nothing was due.
        ``force=True`` compacts regardless; ``mode`` overrides the
        trigger's fold mode."""
        trigger = self.due()
        # the advisory rides every poll, due or not: a mesh that outgrew its
        # shard count must not wait for a fold watermark to be advised
        advice = self._check_reshard()
        if trigger is None:
            if not force:
                return None
            trigger = "forced"
        elif not force and self._defer():
            # a due fold waits out the pacing signal (a controller's SLO
            # latency burn); the tripped watermark stays tripped and the
            # next poll retries — reclaim is deferred, never lost
            self.last_deferred = trigger
            if metrics._enabled:
                _c_deferred().inc(1, name=self._mutable.name,
                                  trigger=trigger)
            return None
        if mode is None:
            mode = "rebuild" if trigger == "tombstone_ratio" else "auto"
        from ..obs import compile as obs_compile

        name = self._mutable.name
        obs_events.emit("compaction_started",
                        subject=("compactor", name, None, None),
                        evidence={"trigger": trigger, "mode": mode})
        t0 = time.perf_counter()
        with obs_compile.attribution() as rec:
            kw = {"trigger": trigger} if self._compact_takes_trigger else {}
            report = self._mutable.compact(mode=mode, res=res, **kw)
            report["trigger"] = trigger
            if self._publisher is not None:
                # publish AFTER the swap: the registry warms the new epoch's
                # searcher at every bucket BEFORE flipping its pointer, so
                # the serving hot path never meets a first call; in-flight
                # leases drain on the pre-compaction epoch's hook
                report["publish"] = self._publisher.publish(
                    self._pub_name, self._mutable.searcher(),
                    k=self._ks, warm_data=self._warm_data)
                if metrics._enabled:
                    _c_swaps().inc(1, name=name)
        wall = time.perf_counter() - t0
        report["wall_s"] = round(wall, 3)
        report["compile_s"] = round(rec.compile_s, 3)
        if advice is not None:
            report["reshard_advised"] = advice
        if self._drift is not None:
            # compaction-time corpus stats: the retained store is the live
            # corpus' raw rows (the classifier subsamples them; a few
            # tombstoned rows not yet reclaimed are noise at its margins).
            # No store: the query-side canary feed still covers the pin
            store = self._mutable._drift_store()
            if store is not None:
                report["drift"] = self._drift.check(
                    rows=store, n_rows=max(self._mutable.size, 1),
                    dim=self._mutable.dim, source="compaction")
        if metrics._enabled:
            _c_compactions().inc(1, name=name, trigger=trigger,
                                 mode=report["mode"])
            _h_wall().observe(wall, name=name)
            if rec.compile_s:
                _c_compile().inc(rec.compile_s, name=name)
        obs_events.emit(
            "compaction_completed",
            subject=("compactor", name, None, None),
            evidence={"trigger": trigger, "mode": report["mode"],
                      "wall_s": report["wall_s"],
                      "compile_s": report["compile_s"],
                      "published": "publish" in report})
        self.last_report = report
        return report

    # -- background worker --------------------------------------------------
    def start(self) -> "Compactor":
        """Start the background poll loop (idempotent). A worker that a
        timed-out close() left draining is reaped here once it exits; while
        it is still alive, clearing the stop flag resumes it instead of
        spawning a second concurrent poller."""
        if self._worker is not None and not self._worker.is_alive():
            self._worker = None
        self._stop.clear()  # resumes a still-draining worker too
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, name=f"raft-compactor-{self._mutable.name}",
                daemon=True)
            self._worker.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.run_once()
                self.last_error = None
            except Exception as e:  # keep the loop alive, but NEVER
                # silently: a misconfigured fold (e.g. a tombstone trigger
                # without rebuild inputs) would otherwise retry every poll
                # forever while writers march toward DeltaFullError
                first = not isinstance(self.last_error, type(e))
                self.last_error = e
                if metrics._enabled:
                    _c_failures().inc(1, name=self._mutable.name)
                if first:  # emit once per failure kind, not per poll tick
                    obs_events.emit(
                        "compaction_failed",
                        subject=("compactor", self._mutable.name,
                                 None, None),
                        evidence={"error": repr(e),
                                  "poll_s": self._poll_s},
                        message=(
                            "compaction of %r failed (will keep retrying "
                            "every %.2fs; see Compactor.last_error): %s"),
                        log_args=(self._mutable.name, self._poll_s, e))

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the worker (a fold in flight finishes first). Idempotent.
        If the join times out (a fold longer than ``timeout_s``), the worker
        handle is KEPT so a later ``start()`` cannot spawn a second
        concurrent poller next to the still-draining one — call close()
        again (or with a larger timeout) to finish the drain."""
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout_s)
            if not self._worker.is_alive():
                self._worker = None
