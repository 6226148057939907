"""Online quality: a live recall canary and dataset-family drift detection.

Counterpart of raft_tpu/obs/quality.py, with its metric names, event kinds,
error texts and sampling: the reservoir draws from a ``random.Random``
seeded as the JAX module's, so the same seed over the same flushes samples
the same queries. The shadow rerank runs the port's exact search (the
``fused_knn`` kernel on a card), and warm-up queries come from a seeded
``torch.Generator``.

Everything before this module measured recall OFFLINE — bench runs against
a frozen ground truth. A serving stack whose indexes mutate under load
(delta memtable, tombstones, compaction hot-swaps, pinned tune decisions)
can rot silently: FreshDiskANN (Singh et al., 2021) measures recall
degrading under streaming insert/delete churn unless actively monitored,
and BASELINE round 5's negative result — operating points do NOT transfer
across dataset families — means a pinned tune decision is only valid while
live traffic stays in the family it was measured on. This module closes
both gaps online:

- :class:`RecallCanary` — reservoir-samples a configurable fraction of
  live queries at the serve flush path (host-side, microseconds), then
  shadow-reranks them OFF the hot path with the exact fused kNN over the
  *live* corpus (sealed rows + delta memtable, tombstones applied) at
  warmed power-of-two bucket shapes, and publishes a streaming recall@k
  estimate with a Wilson confidence interval (``raft_tpu_quality_*``).
  The rerank batches ride the same bucket discipline as everything else in
  the serving stack, so a warmed canary builds no kernel on or off the hot
  path.
- :class:`DriftDetector` — re-runs :mod:`raft_tpu_torch.tune`'s family
  classifier (local-scale CV of nearest-neighbor radii; the measured
  heavytail discriminator) on canary query samples and on compaction-time
  corpus stats, and raises ``raft_tpu_quality_family_drift`` plus a
  ``retune_advised`` structured event when the live distribution leaves
  the pinned decision's ``(kind, dtype, family)`` key. It NEVER applies a
  decision across balance classes itself — the r5 non-transfer collapse
  (0.31 vs 0.82 recall) is exactly why a drift is an *advice to re-sweep*,
  not a pin to borrow.

Wiring: ``SearchService(canary=...)`` taps flushes into
:meth:`RecallCanary.offer`; ``stream.Compactor(drift=...)`` feeds
compaction-time corpus stats; ``slo=`` forwards per-query rerank outcomes
into the quality objective of an :class:`raft_tpu_torch.obs.slo.SLOTracker`.
"""

from __future__ import annotations

import functools
import itertools
import math
import random
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..core.errors import expects
from . import events as obs_events
from . import metrics

__all__ = ["RecallCanary", "DriftDetector", "exact_oracle", "wilson_interval"]

# per-DriftDetector journal tags (see DriftDetector.events)
_detector_ids = itertools.count()

# the canary's rerank-batch ladder (power-of-two query buckets, mirroring
# serve's): every rerank dispatch is one of these shapes, so warm() bounds
# the canary's program set exactly like the batcher bounds the hot path's
DEFAULT_CANARY_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


# -- metrics (catalogue: docs/observability.md) ------------------------------

@functools.lru_cache(maxsize=None)
def _g_recall():
    return metrics.gauge(
        "raft_tpu_quality_recall",
        "streaming canary recall@k point estimate (served ids vs the exact "
        "fused kNN over the live corpus)")


@functools.lru_cache(maxsize=None)
def _g_wilson_low():
    return metrics.gauge(
        "raft_tpu_quality_recall_wilson_low",
        "lower bound of the 95% Wilson interval on the canary recall "
        "estimate")


@functools.lru_cache(maxsize=None)
def _g_wilson_high():
    return metrics.gauge(
        "raft_tpu_quality_recall_wilson_high",
        "upper bound of the 95% Wilson interval on the canary recall "
        "estimate")


@functools.lru_cache(maxsize=None)
def _c_sampled():
    return metrics.counter(
        "raft_tpu_quality_canary_sampled_total",
        "live queries reservoir-sampled into the canary at the flush path")


@functools.lru_cache(maxsize=None)
def _c_reranked():
    return metrics.counter(
        "raft_tpu_quality_canary_reranked_total",
        "sampled queries shadow-reranked against the exact live-corpus kNN")


@functools.lru_cache(maxsize=None)
def _c_dropped():
    return metrics.counter(
        "raft_tpu_quality_canary_dropped_total",
        "sampled queries displaced from a full canary reservoir before "
        "rerank (raise reservoir= or drain more often)")


@functools.lru_cache(maxsize=None)
def _h_canary_recall():
    return metrics.histogram(
        "raft_tpu_quality_canary_recall",
        "per-query canary recall@k observations (0-1 ratio buckets; the "
        "per-bucket series ride BENCH artifacts via obs.to_json)",
        buckets=metrics.RATIO_BUCKETS)


@functools.lru_cache(maxsize=None)
def _g_drift():
    return metrics.gauge(
        "raft_tpu_quality_family_drift",
        "1 while the measured live family differs from the pinned tune "
        "decision's family, else 0")


@functools.lru_cache(maxsize=None)
def _c_retune():
    return metrics.counter(
        "raft_tpu_quality_retune_advised_total",
        "drift transitions that emitted a retune_advised event (advice "
        "only — decisions never auto-apply across balance classes)")


# -- statistics --------------------------------------------------------------

def wilson_interval(successes: float, trials: float,
                    z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion (default z=1.96,
    the two-sided 95% level). Unlike the normal approximation it stays
    inside [0, 1] and behaves at p near 1 — where recall lives — and at
    small n. ``trials == 0`` returns the vacuous (0, 1)."""
    n = float(trials)
    if n <= 0:
        return (0.0, 1.0)
    p = float(successes) / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    return (max(0.0, center - half), min(1.0, center + half))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# -- the shadow oracle -------------------------------------------------------

def exact_oracle(index, dataset=None) -> Callable:
    """Resolve an index to its exact shadow-rerank oracle: a
    ``fn(queries, k) -> (distances, ids)`` over the LIVE corpus.

    A :class:`raft_tpu_torch.stream.MutableIndex` (duck-typed: obs never
    imports stream) resolves to its ``exact_search``:
    the exact fused kNN over the retained sealed rows (tombstones applied
    via the same keep mask the serving path uses) merged with the delta
    scan, so the oracle tracks every upsert/delete/compaction the served
    index sees. A plain sealed index needs its raw rows via ``dataset=``
    (PQ codes cannot reconstruct them) and reranks with
    ``brute_force.knn`` in the index's own metric, on the index's device."""
    if hasattr(index, "upsert") and hasattr(index, "exact_search"):
        fn = index.exact_search
        fn_dim, fn_dtype = index.dim, index.query_dtype
    else:
        expects(dataset is not None,
                "exact_oracle needs the raw rows for a sealed %s index — "
                "pass dataset= (or wrap in stream.MutableIndex with a "
                "retained store)", type(index).__name__)
        from ..core.resources import Resources
        from ..distance.types import resolve_metric
        from ..neighbors import brute_force

        dev = getattr(index, "device", None)
        if dev is None and isinstance(getattr(index, "dataset", None),
                                      torch.Tensor):
            dev = index.dataset.device
        res = Resources(device=dev if dev is not None else "cpu")
        ds = res.put(_host(dataset))
        metric = resolve_metric(getattr(index, "metric", "sqeuclidean"))
        # parameterized metrics (lp) carry their exponent on the index —
        # an L2 "oracle" for an L3 index would report a spurious deficit
        metric_arg = float(getattr(index, "metric_arg", 2.0))
        dk = str(ds.dtype)
        fn_dim = int(ds.shape[1])
        fn_dtype = dk if dk in ("int8", "uint8") else "float32"

        def fn(queries, k):
            return brute_force.knn.native(ds, queries, int(k), metric, metric_arg,
                                   res=res)

    fn = _wrap_oracle(fn, fn_dim, fn_dtype)
    return fn


def _wrap_oracle(fn, dim: int, query_dtype: str):
    def oracle(queries, k):
        return fn(queries, int(k))

    oracle.dim = int(dim)
    oracle.query_dtype = query_dtype
    return oracle


# -- the canary --------------------------------------------------------------

class RecallCanary:
    """Live recall canary (see module doc).

    ``oracle`` is the exact shadow searcher (:func:`exact_oracle`);
    ``sample_rate`` is the fraction of served queries sampled at the flush
    path (0 disables sampling entirely — one float compare per flush);
    ``reservoir`` bounds pending host memory between drains (overflow
    displaces uniformly — algorithm R — and counts as dropped). ``buckets``
    is the rerank batch ladder; :meth:`warm` compiles the oracle at every
    bucket so a drain never cold-compiles. ``k`` must match the serving
    width whose results are offered. ``slo=`` forwards per-query outcomes
    to an :class:`~raft_tpu_torch.obs.slo.SLOTracker`'s quality objective;
    ``drift=`` forwards the sampled query rows to a
    :class:`DriftDetector`. Sampling (RNG) is seeded — deterministic for
    tests — and all entry points are thread-safe.
    """

    def __init__(self, oracle: Callable, *, k: int = 10,
                 sample_rate: float = 0.01, reservoir: int = 256,
                 buckets=DEFAULT_CANARY_BUCKETS, name: str = "default",
                 seed: int = 0, slo=None, drift=None,
                 clock: Callable[[], float] = time.monotonic):
        expects(callable(oracle), "oracle must be callable (exact_oracle())")
        expects(0.0 <= float(sample_rate) <= 1.0,
                "sample_rate must be in [0, 1], got %r", sample_rate)
        expects(int(reservoir) >= 1, "reservoir must be >= 1")
        self._oracle = oracle
        self.k = int(k)
        self.name = name
        self.reservoir = int(reservoir)
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        expects(bool(self._buckets) and self._buckets[0] >= 1,
                "buckets must be positive batch sizes")
        self._rate = float(sample_rate)
        self._rng = random.Random(seed)
        self._seed = int(seed)
        self._clock = clock
        self._slo = slo
        self._drift = drift
        self._lock = threading.Lock()
        self._pending: list = []
        self._cands = 0       # candidates offered to the reservoir this window
        self._seen = 0        # queries observed at the flush path (lifetime)
        self._successes = 0   # matched neighbor slots (lifetime)
        self._trials = 0      # scored neighbor slots (lifetime)
        self._reranked = 0
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()

    # -- hot-path tap --------------------------------------------------------
    def set_rate(self, sample_rate: float) -> None:
        expects(0.0 <= float(sample_rate) <= 1.0,
                "sample_rate must be in [0, 1], got %r", sample_rate)
        with self._lock:
            self._rate = float(sample_rate)

    def offer(self, queries, served_ids) -> int:
        """Reservoir-sample served (query, ids) rows — called by the serve
        flush path with the VALID rows of one flush. Host-side and bounded:
        one RNG draw per row, one row copy per kept sample. Returns how
        many rows were sampled. ``sample_rate == 0`` is a single compare."""
        if self._rate <= 0.0:
            return 0
        qs = _host(queries)
        ids = _host(served_ids)
        kept = dropped = 0
        with self._lock:
            for i in range(qs.shape[0]):
                self._seen += 1
                if self._rng.random() >= self._rate:
                    continue
                kept += 1
                self._cands += 1
                item = (qs[i].copy(), ids[i].copy())
                if len(self._pending) < self.reservoir:
                    self._pending.append(item)
                else:
                    # algorithm R over this drain window's candidates: the
                    # reservoir stays a uniform sample of them
                    j = self._rng.randrange(self._cands)
                    if j < self.reservoir:
                        self._pending[j] = item
                    dropped += 1
        if metrics._enabled and kept:
            _c_sampled().inc(kept, name=self.name)
            if dropped:
                _c_dropped().inc(dropped, name=self.name)
        return kept

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- the shadow rerank (off the hot path) --------------------------------
    def drain(self) -> int:
        """Shadow-rerank everything sampled since the last drain: batch the
        reservoir into power-of-two buckets (partial tails padded by
        repeating the first row — padding results are discarded), run the
        exact oracle, score served-vs-exact overlap per query, and publish
        the streaming estimate + Wilson interval. Returns queries reranked.
        Runs on the caller's thread — a background drainer (:meth:`start`)
        or a deterministic test loop."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._cands = 0
        if not pending:
            return 0
        max_b = self._buckets[-1]
        i = 0
        while i < len(pending):
            chunk = pending[i:i + max_b]
            i += len(chunk)
            b = next(bb for bb in self._buckets if bb >= len(chunk))
            q = np.stack([c[0] for c in chunk])
            if len(chunk) < b:
                pad = np.broadcast_to(q[:1], (b - len(chunk),) + q.shape[1:])
                q = np.concatenate([q, pad])
            _, oids = self._oracle(q, self.k)
            oids = _host(oids)[:len(chunk)]
            matched = scored = 0
            for (_, sids), orow in zip(chunk, oids):
                valid = orow[orow >= 0]
                if valid.size == 0:
                    continue  # empty live corpus: nothing to score
                m = len(set(np.asarray(sids).tolist())
                        & set(valid.tolist()))
                matched += m
                scored += int(valid.size)
                if metrics._enabled:
                    _h_canary_recall().observe(m / valid.size, name=self.name)
            with self._lock:
                self._successes += matched
                self._trials += scored
                self._reranked += len(chunk)
            if metrics._enabled:
                _c_reranked().inc(len(chunk), name=self.name)
            if self._slo is not None:
                self._slo.record_quality(matched, scored)
            if self._drift is not None:
                self._drift.offer_rows(np.stack([c[0] for c in chunk]))
        self._publish()
        return len(pending)

    def _publish(self) -> None:
        est = self.estimate()
        if metrics._enabled:
            _g_recall().set(est["recall"], name=self.name)
            _g_wilson_low().set(est["wilson_low"], name=self.name)
            _g_wilson_high().set(est["wilson_high"], name=self.name)

    # -- estimate ------------------------------------------------------------
    def estimate(self) -> dict:
        """The streaming recall estimate: point value, 95% Wilson bounds,
        and the sample counts that produced them."""
        with self._lock:
            s, t = self._successes, self._trials
            reranked, seen = self._reranked, self._seen
        low, high = wilson_interval(s, t)
        return {"recall": (s / t) if t else float("nan"),
                "wilson_low": low, "wilson_high": high,
                "matched_slots": int(s), "scored_slots": int(t),
                "reranked": int(reranked), "seen": int(seen)}

    def in_interval(self, recall: float) -> bool:
        """Whether an offline recall measurement falls inside the canary's
        current Wilson interval — the acceptance check that the live
        estimate tracks the fresh-oracle truth."""
        est = self.estimate()
        return est["wilson_low"] <= float(recall) <= est["wilson_high"]

    # -- warmup --------------------------------------------------------------
    def warm(self, sample=None) -> dict:
        """Run the oracle once at every rerank bucket (the canary analogue
        of ``_warmup.warm_buckets``): its kernels are built and its
        allocator blocks exist before a drain needs them. Queries come from
        a ``torch.Generator`` seeded with the canary's seed. Returns
        per-bucket build attribution."""
        from .._warmup import _random_queries, _wait
        from . import compile as obs_compile

        dim = int(getattr(self._oracle, "dim"))
        dtype = getattr(self._oracle, "query_dtype", "float32")
        out = {}
        gen = torch.Generator().manual_seed(self._seed)
        if sample is not None:
            sample = torch.as_tensor(_host(sample))
        for b in self._buckets:
            q = _random_queries(gen, b, dim, dtype, sample=sample)
            t0 = time.perf_counter()
            with obs_compile.attribution() as rec:
                _wait(self._oracle(q, self.k))
            out[b] = {"wall_s": round(time.perf_counter() - t0, 3),
                      **rec.summary()}
        return out

    # -- background drainer --------------------------------------------------
    def start(self, poll_interval_s: float = 0.05) -> "RecallCanary":
        """Run :meth:`drain` on a daemon poll loop (library mode; tests and
        the churn bench drive :meth:`drain` directly). Idempotent."""
        if self._worker is not None and not self._worker.is_alive():
            self._worker = None
        self._stop.clear()
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, args=(float(poll_interval_s),),
                name=f"raft-canary-{self.name}", daemon=True)
            self._worker.start()
        return self

    def _run(self, poll_s: float) -> None:
        from ..core.logger import logger

        while not self._stop.wait(poll_s):
            try:
                self.drain()
            except Exception as e:  # never kill the drainer; advise loudly
                logger.warning("canary %r drain failed (will retry): %s",
                               self.name, e)

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the background drainer and flush what is pending."""
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout_s)
            self._worker = None
        self.drain()


# -- drift detection ---------------------------------------------------------

class DriftDetector:
    """Detect the live distribution leaving a pinned decision's family.

    ``pinned_family`` is the tune decision's structured family key
    (``"100k-d128-bal"`` — :func:`raft_tpu_torch.tune.shape_family`);
    construct from a pinned :class:`~raft_tpu_torch.tune.Decision` via
    :meth:`from_decision`. Two feeds re-run the tune classifier:

    - **canary query samples** (:meth:`offer_rows` + :meth:`check`): the
      local-scale CV of nearest-neighbor radii over the buffered rows —
      the measured heavytail discriminator (isotropic ~0.4 vs lognormal
      scales ~1.5, threshold 0.75) — reclassifies the balance class.
      Queries cannot see the corpus' row count, so this feed holds the
      pinned size labels and moves only the balance class.
    - **compaction-time corpus stats** (:meth:`check` with ``rows=`` and
      ``n_rows=``/``dim=``, fed by ``stream.Compactor(drift=...)``): a
      corpus subsample plus the live row count, so size-decade drift is
      visible too.

    On a drift TRANSITION (family leaves the pin; re-entering clears it)
    the detector emits one ``retune_advised`` structured event (counter +
    WARNING log + :attr:`events`) and holds ``raft_tpu_quality_family_drift``
    at 1. It never applies another family's decision: cross-balance-class
    transfer is the measured r5 recall collapse, so the ONLY safe action
    is a fresh sweep (docs/tuning.md, "Drift → retune").
    """

    def __init__(self, pinned_family: str, *, name: str = "default",
                 min_rows: int = 256, sample_cap: int = 2048,
                 max_events: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        parts = str(pinned_family).split("-")
        expects(len(parts) == 3,
                "pinned_family must be a structured 'rows-dim-balance' key "
                "(tune.shape_family), got %r", pinned_family)
        self.pinned_family = str(pinned_family)
        self._n_lab, self._d_lab, self._balance = parts
        expects(self._balance in ("bal", "skew", "clump"),
                "unknown balance class %r in pinned family", self._balance)
        self.name = name
        self.min_rows = int(min_rows)
        self.sample_cap = int(sample_cap)
        self._clock = clock
        self._lock = threading.Lock()
        self._buf: list = []
        self._buf_rows = 0
        # drift state is PER FEED: the query-sample and compaction-stat
        # feeds observe different things (traffic vs corpus), and the
        # early-warning case is exactly query drift while the corpus is
        # still clean — a clean corpus check must not clear (and re-arm)
        # a standing query-side drift
        self._drifted: dict[str, bool] = {}
        # per-instance journal tag: the `events` view below filters the
        # process-wide journal by it, so two detectors sharing a name
        # (or test cases reusing one) never read each other's advisories
        self._jtag = f"{name}/{next(_detector_ids)}"
        self._max_events = int(max_events)
        self.last_report: dict | None = None

    @classmethod
    def from_decision(cls, decision, **kwargs) -> "DriftDetector":
        """Arm a detector for one pinned :class:`raft_tpu_torch.tune.Decision`."""
        return cls(decision.family, **kwargs)

    def offer_rows(self, rows) -> None:
        """Buffer live-sample rows (canary queries) for the next
        :meth:`check`; keeps the LATEST ``sample_cap`` rows."""
        arr = _host(rows)
        if arr.ndim != 2 or arr.shape[0] == 0:
            return
        with self._lock:
            self._buf.append(arr)
            self._buf_rows += arr.shape[0]
            while self._buf and self._buf_rows - self._buf[0].shape[0] \
                    >= self.sample_cap:
                self._buf_rows -= self._buf.pop(0).shape[0]

    def buffered(self) -> int:
        with self._lock:
            return self._buf_rows

    def check(self, rows=None, *, n_rows: int | None = None,
              dim: int | None = None, source: str = "queries") -> dict | None:
        """Re-run the tune family classifier and compare against the pin.

        With no ``rows``, classifies the buffered canary samples (returns
        None below ``min_rows`` — too few rows to trust the CV). With
        ``rows`` (plus ``n_rows``/``dim``), classifies that corpus
        subsample directly — the compaction-time feed. Returns the report
        dict (also kept as :attr:`last_report`)."""
        # lazy: obs must stay importable without dragging the tune package
        # in at obs-import time (tune itself imports obs.metrics)
        from ..tune import decisions

        if rows is None:
            with self._lock:
                if self._buf_rows < self.min_rows:
                    return None
                rows = np.concatenate(self._buf)[-self.sample_cap:]
        else:
            rows = _host(rows)
        cv = decisions.local_scale_cv(rows)
        balance = ("skew" if cv > decisions.SCALE_CV_THRESHOLD else "bal")
        if n_rows is not None and dim is not None:
            observed = decisions.shape_family(int(n_rows), int(dim), balance)
        else:
            # query samples carry no corpus size: hold the pinned size
            # labels, move only the measured balance class
            observed = f"{self._n_lab}-{self._d_lab}-{balance}"
        drifted = observed != self.pinned_family
        # the measured evidence rides the report (and the retune_advised
        # event) INLINE: the classifier value AND its threshold, plus both
        # balance classes — a controller (or a postmortem) replays the
        # decision from the journal alone, re-probing nothing
        report = {"drifted": drifted, "pinned": self.pinned_family,
                  "observed": observed, "scale_cv": round(float(cv), 4),
                  "scale_cv_threshold": decisions.SCALE_CV_THRESHOLD,
                  "pinned_balance": self._balance,
                  "observed_balance": balance,
                  "rows": int(rows.shape[0]), "source": source,
                  "at": self._clock()}
        was = self._drifted.get(source, False)
        self._drifted[source] = drifted
        if metrics._enabled:
            # the gauge reports drift on ANY feed: a clean corpus check
            # must not drop it while query-side drift stands
            _g_drift().set(1.0 if any(self._drifted.values()) else 0.0,
                           name=self.name)
        if drifted and not was:
            self._emit_retune_advised(report)
        self.last_report = report
        return report

    def drifted(self) -> bool:
        """Whether any feed currently observes the live family off the
        pin (what the ``raft_tpu_quality_family_drift`` gauge reports)."""
        return any(self._drifted.values())

    @property
    def events(self) -> list:
        """The retune-advised history, as a thin view over the process
        journal (:mod:`raft_tpu_torch.obs.events`) — legacy dict shape
        preserved (``{"event": "retune_advised", "name", "auto_apply",
        **report}``), newest last, capped at ``max_events``."""
        out = []
        for ev in obs_events.query(kind="retune_advised", name=self.name):
            e = ev["evidence"]
            if e.get("tag") != self._jtag:
                continue
            out.append({"event": "retune_advised", "name": self.name,
                        **{k: v for k, v in e.items() if k != "tag"}})
        return out[-self._max_events:]

    def _emit_retune_advised(self, report: dict) -> None:
        # one emit = journal entry + counter + WARNING, atomically (the
        # three can no longer disagree on re-arm paths); advice only:
        # applying another balance class's pin is the measured r5 recall
        # collapse — run a fresh sweep instead (auto_apply stays False)
        obs_events.emit(
            "retune_advised",
            subject=("quality", self.name),
            evidence={"auto_apply": False, "tag": self._jtag, **report},
            counter=_c_retune, counter_labels={"name": self.name},
            message=(
                "family drift on %r: live distribution measures %s but the "
                "pinned tune decision is keyed %s (scale_cv=%.3f, "
                "source=%s) — retune advised; decisions are never "
                "auto-applied across balance classes (BASELINE r5 "
                "non-transfer)"),
            log_args=(self.name, report["observed"], report["pinned"],
                      report["scale_cv"], report["source"]))
