"""ReplicatedShard: R MutableIndex twins behind one surface.

Counterpart of raft_tpu/stream/replicated.py: the availability half of the
sharded tier. The twins are ordinary
:class:`~raft_tpu_torch.stream.MutableIndex` objects (each on its own device
when ``devices=`` is given, ledger attribution under ``name/r<j>``); writes
reuse the hoisted whole-or-nothing admission of the sharded upsert, and the
scatter-gather composes a group where it composes a single shard.

- **Writes apply to every live twin.** Deterministic refusals
  (:class:`~raft_tpu_torch.stream.DeltaFullError`,
  :class:`~raft_tpu_torch.serve.errors.MemoryBudgetError`) are checked
  BEFORE any twin writes. A twin whose write RAISES past admission goes
  **stale** and is fenced from reads (it missed an acknowledged write); the
  write succeeds while one twin (plus the WAL, when armed) holds it. Stale
  lasts until the group is rebuilt: a re-probe heals a slow twin, not a
  diverged one.
- **Reads fan to ONE twin**, picked by health and recent latency: fenced
  and stale twins are excluded, and among the healthy the lowest scan-wall
  EWMA wins. A failed or deadline-slow scan strikes the twin's breaker
  (``FencingPolicy.max_consecutive`` strikes in a row fence it for
  ``backoff_s``, doubling per re-fence up to ``backoff_max_s``) and the
  SAME call retries a surviving twin. After the backoff the next pick
  half-opens the breaker as a probe. Only when every twin is fenced, stale
  or failed does the call raise
  :class:`~raft_tpu_torch.serve.errors.ReplicaUnavailableError`.
- **Durability is group-level.** ``wal=`` logs the group's write stream
  once, ``save()`` snapshots the primary twin with the group's WAL seq and
  truncates the log, and recovery is ``stream.load(path, wal=)``: a
  degraded-to-one restore holding every acknowledged write.

On one card (``devices=None``) every twin runs on the same device and the
same stream, so a real kernel fault fails both twins and the call raises:
failover covers a twin's own fault (an injected one, a bad state), not the
card's.

Fault points (:mod:`raft_tpu_torch.testing.faults`): ``replica/search`` (per
scan attempt; a callback that advances the injected clock simulates a
wedged twin) and ``replica/upsert`` / ``replica/delete`` (per twin write).
Metrics: ``raft_tpu_replica_*``, the JAX package's names.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import threading
import time
from typing import Callable, Sequence

import numpy as np

from ..core.errors import RaftError, expects
from ..core.resources import default_resources
from ..obs import events as obs_events
from ..obs import mem as obs_mem
from ..obs import metrics
from ..serve.errors import ReplicaUnavailableError
from ..testing import faults
from . import mutable as _mut
from .mutable import MutableIndex

__all__ = ["ReplicatedShard", "FencingPolicy"]


@functools.lru_cache(maxsize=None)
def _g_healthy():
    return metrics.gauge(
        "raft_tpu_replica_healthy",
        "replicas currently pickable for reads (not fenced, not stale)")


@functools.lru_cache(maxsize=None)
def _g_stale():
    return metrics.gauge(
        "raft_tpu_replica_stale",
        "replicas that missed an acknowledged write (fenced from reads "
        "until rebuilt — re-probing cannot heal divergence)")


@functools.lru_cache(maxsize=None)
def _c_fenced():
    return metrics.counter(
        "raft_tpu_replica_fenced_total",
        "replica fencings by reason (error/slow strikes tripping the "
        "breaker, write = missed write marked stale)")


@functools.lru_cache(maxsize=None)
def _c_failovers():
    return metrics.counter(
        "raft_tpu_replica_failovers_total",
        "reads retried on a surviving twin within the SAME flush after "
        "the picked replica failed")


@functools.lru_cache(maxsize=None)
def _c_probes():
    return metrics.counter(
        "raft_tpu_replica_probes_total",
        "half-open breaker probes by outcome (ok closes the breaker, "
        "fail re-fences with doubled backoff)")


@functools.lru_cache(maxsize=None)
def _c_reads():
    return metrics.counter(
        "raft_tpu_replica_reads_total",
        "scans served per replica (the read fan-out's pick distribution)")


@dataclasses.dataclass(frozen=True)
class FencingPolicy:
    """When a replica stops being trusted (see module doc).

    ``deadline_s``: a completed scan slower than this is a SLOW strike
    (None disables it); its result is still returned. ``max_consecutive``:
    strikes in a row before the breaker opens. ``backoff_s`` /
    ``backoff_max_s``: fence duration, doubling per re-fence.
    ``ewma_alpha``: smoothing of the scan-wall EWMA the read pick
    minimizes."""

    deadline_s: float | None = None
    max_consecutive: int = 2
    backoff_s: float = 1.0
    backoff_max_s: float = 60.0
    ewma_alpha: float = 0.2


class _Health:
    """One replica's breaker and latency state (mutated under the group's
    health lock only)."""

    __slots__ = ("consecutive", "fenced_until", "backoff", "stale", "ewma",
                 "strikes", "last_error")

    def __init__(self, backoff: float):
        self.consecutive = 0
        self.fenced_until = None  # None: breaker closed
        self.backoff = backoff
        self.stale = False
        self.ewma = None
        self.strikes = 0
        self.last_error = None


class _PinnedGroup:
    """A serving hook's frozen view of one replica group: each twin's state
    epoch pinned when the hook was made (the registry's lease-drain
    contract), with the failover live: health decisions read the CURRENT
    breaker state, so a hook issued before a fence avoids the fenced twin."""

    __slots__ = ("group", "states")

    def __init__(self, group: "ReplicatedShard", states: tuple):
        self.group = group
        self.states = states

    def scan_serving(self, queries, k, res=None, k_sealed_clamp=True):
        def scan(st, q, kk, res=None):
            ks = (min(int(kk), st.id_map.shape[0]) if k_sealed_clamp
                  else None)
            return _mut._scan_state(st, q, kk, res=res, k_sealed=ks)

        return self.group._failover(self.states, queries, k, scan, res=res)

    def search(self, queries, k, res=None):
        return self.group._failover(
            self.states, queries, k,
            lambda st, q, kk, res=None: _mut._search_state(st, q, kk,
                                                           res=res),
            res=res)


class ReplicatedShard:
    """R MutableIndex twins behind the MutableIndex surface (see module
    doc). ``sealed`` is built once and shared by the twins (a brute-force
    index gets a shell each, since a wrap may move its dataset);
    ``devices`` puts twin ``j`` on ``devices[j]``. ``wal`` /
    ``snapshot_path`` arm group durability; ``policy`` is the
    :class:`FencingPolicy`. Everything else forwards to each twin's
    :class:`MutableIndex` (``ids=`` global ids, ``shard=`` the ledger
    ordinal; twins attribute under ``name/r<j>``)."""

    def __init__(self, sealed, *, n_replicas: int = 2,
                 devices: Sequence | None = None, ids=None,
                 search_params=None, index_params=None,
                 builder: Callable | None = None,
                 delta_capacity: int = 1024,
                 retain_vectors: bool | None = None, dataset=None,
                 wal=None, snapshot_path: str | None = None,
                 policy: FencingPolicy = FencingPolicy(),
                 name: str = "default", shard: int | None = None,
                 storage: str = "hbm", tier=None,
                 clock: Callable[[], float] = time.monotonic):
        n_replicas = int(n_replicas)
        expects(n_replicas >= 1, "n_replicas must be >= 1, got %d",
                n_replicas)
        if devices is not None:
            devices = list(devices)
            expects(len(devices) >= n_replicas,
                    "%d replicas need %d devices, got %d", n_replicas,
                    n_replicas, len(devices))
        self._name = name
        self._clock = clock
        self.policy = policy
        self._lock = threading.RLock()
        # the breaker state has its own mutex: a read's pick / strike /
        # observe never waits out a group write's WAL fsync and R uploads
        self._hlock = threading.Lock()
        self._rr = 0  # round-robin tie-break cursor
        kind, _ = _mut._resolve_kind(sealed)
        self._replicas: list[MutableIndex] = []
        for j in range(n_replicas):
            sealed_j = copy.copy(sealed) if kind == "brute_force" else sealed
            self._replicas.append(MutableIndex(
                sealed_j, search_params=search_params,
                index_params=index_params, delta_capacity=delta_capacity,
                retain_vectors=retain_vectors, dataset=dataset,
                builder=builder, ids=ids,
                device=devices[j] if devices is not None else None,
                name=f"{name}/r{j}", shard=shard, storage=storage,
                tier=tier, clock=clock))
        self._health = [_Health(policy.backoff_s) for _ in range(n_replicas)]
        # ONE log for the group's write stream (the twins are in-memory
        # redundancy, the log the copy on disk)
        if wal is not None and not hasattr(wal, "append_upsert"):
            from .wal import WriteAheadLog

            wal = WriteAheadLog(wal, name=name)
        if wal is not None:
            expects(wal.seq == 0,
                    "WAL %r already holds records (seq=%d) — recover with "
                    "stream.load(wal=) before re-replicating",
                    getattr(wal, "path", "?"), wal.seq)
        self._wal = wal
        self._wal_seq = 0
        self._snapshot_path = snapshot_path
        self._update_health_gauges()

    # -- introspection (the MutableIndex surface) ---------------------------
    @property
    def kind(self) -> str:
        return self._replicas[0].kind

    @property
    def dim(self) -> int:
        return self._replicas[0].dim

    @property
    def name(self) -> str:
        return self._name

    @property
    def query_dtype(self) -> str:
        return self._replicas[0].query_dtype

    @property
    def device(self):
        return self._replicas[0].device

    @property
    def delta_capacity(self) -> int:
        return self._replicas[0].delta_capacity

    @property
    def can_rebuild(self) -> bool:
        return all(r.can_rebuild for r in self._replicas)

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    @property
    def replicas(self) -> tuple:
        """The twins (a read-only tuple: write through the group so they
        stay in lockstep)."""
        return tuple(self._replicas)

    @property
    def uploaded_bytes(self) -> int:
        return sum(r.uploaded_bytes for r in self._replicas)

    @property
    def _cfg(self):
        return self._replicas[0]._cfg

    @property
    def _buckets(self):
        return self._replicas[0]._buckets

    @property
    def _next_id(self) -> int:
        return max(r._next_id for r in self._replicas)

    def _coerce_rows(self, rows):
        return self._replicas[0]._coerce_rows(rows)

    @property
    def size(self) -> int:
        return self._primary().size

    def _primary(self) -> MutableIndex:
        """The first non-stale twin: the one that speaks for the group's
        data (live twins are in lockstep)."""
        for j, h in enumerate(self._health):
            if not h.stale:
                return self._replicas[j]
        return self._replicas[0]

    def _drift_store(self):
        return self._primary()._drift_store()

    def _healthy_locked(self, now) -> int:
        return sum(1 for h in self._health
                   if not h.stale and (h.fenced_until is None
                                       or now >= h.fenced_until))

    def stats(self) -> dict:
        """The primary twin's watermarks (a Compactor reads them unchanged)
        plus the group's replica and health detail."""
        st = self._primary().stats()
        with self._hlock:
            st["replicas"] = len(self._replicas)
            st["healthy"] = self._healthy_locked(self._clock())
            st["stale"] = sum(1 for h in self._health if h.stale)
        return st

    def health(self) -> dict:
        """Per-replica breaker state (the ``/healthz`` detail)."""
        with self._hlock:
            now = self._clock()
            reps = []
            for j, h in enumerate(self._health):
                fenced = (h.stale or (h.fenced_until is not None
                                      and now < h.fenced_until))
                reps.append({
                    "replica": self._replicas[j].name,
                    "fenced": bool(fenced), "stale": bool(h.stale),
                    "consecutive_strikes": h.consecutive,
                    "strikes_total": h.strikes,
                    "ewma_ms": (round(h.ewma * 1e3, 3)
                                if h.ewma is not None else None),
                    "fenced_until": h.fenced_until,
                    "last_error": (f"{type(h.last_error).__name__}: "
                                   f"{str(h.last_error)[:120]}"
                                   if h.last_error is not None else None),
                })
            return {"name": self._name, "replicas": reps,
                    "healthy": sum(1 for r in reps if not r["fenced"])}

    def _update_health_gauges(self) -> None:
        if not metrics._enabled:
            return
        _g_healthy().set(self._healthy_locked(self._clock()),
                         name=self._name)
        _g_stale().set(sum(1 for h in self._health if h.stale),
                       name=self._name)

    # -- read pick + breaker -------------------------------------------------
    def _pick(self, exclude: set) -> int | None:
        """The twin for one attempt: a probe-due fenced twin (fence expired,
        earliest first) half-opens first; otherwise the closed twin with
        the lowest scan-wall EWMA, round-robin among ties; None when nothing
        is pickable."""
        with self._hlock:
            now = self._clock()
            closed, probes = [], []
            for j, h in enumerate(self._health):
                if j in exclude or h.stale:
                    continue
                if h.fenced_until is None:
                    closed.append(j)
                elif now >= h.fenced_until:
                    probes.append((h.fenced_until, j))
            if probes:
                return min(probes)[1]
            if closed:
                self._rr += 1
                rr = self._rr
                return min(closed,
                           key=lambda j: (self._health[j].ewma or 0.0,
                                          (j - rr) % len(self._health)))
            return None

    def _strike(self, j: int, reason: str, exc=None) -> None:
        fenced = was_probe = False
        with self._hlock:
            h = self._health[j]
            h.consecutive += 1
            h.strikes += 1
            if exc is not None:
                h.last_error = exc
            was_probe = h.fenced_until is not None
            if was_probe or h.consecutive >= self.policy.max_consecutive:
                fenced = True
                h.fenced_until = self._clock() + h.backoff
                backoff = h.backoff
                h.backoff = min(h.backoff * 2, self.policy.backoff_max_s)
                if metrics._enabled:
                    _c_fenced().inc(1, name=self._name, reason=reason)
                    if was_probe:
                        _c_probes().inc(1, name=self._name, outcome="fail")
            self._update_health_gauges()
        # journal outside the health lock: a subscriber never runs under it
        if fenced:
            if was_probe:
                obs_events.emit(
                    "replica_probe", severity="warning",
                    subject=("replica", self._name, j, None),
                    evidence={"outcome": "fail", "reason": reason,
                              "backoff_s": backoff})
            obs_events.emit(
                "replica_fenced",
                subject=("replica", self._name, j, None),
                evidence={"reason": reason, "backoff_s": backoff,
                          "error": None if exc is None else repr(exc)})

    def _observe_ok(self, j: int, wall: float) -> bool:
        """Record a completed scan; returns True if it was a SLOW strike
        (the caller still returns the valid result)."""
        p = self.policy
        slow = p.deadline_s is not None and wall > p.deadline_s
        unfenced = False
        with self._hlock:
            h = self._health[j]
            h.ewma = (wall if h.ewma is None
                      else (1 - p.ewma_alpha) * h.ewma + p.ewma_alpha * wall)
            if not slow:
                if h.fenced_until is not None:
                    unfenced = True
                    if metrics._enabled:
                        _c_probes().inc(1, name=self._name, outcome="ok")
                h.consecutive = 0
                h.fenced_until = None  # a successful probe closes the breaker
                h.backoff = self.policy.backoff_s
            self._update_health_gauges()
        if unfenced:
            obs_events.emit("replica_probe",
                            subject=("replica", self._name, j, None),
                            evidence={"outcome": "ok",
                                      "wall_s": round(wall, 6)})
            obs_events.emit("replica_unfenced",
                            subject=("replica", self._name, j, None),
                            evidence={"wall_s": round(wall, 6)})
        if slow:
            self._strike(j, "slow")
        return slow

    def _failover(self, states, queries, k, scan, res=None):
        """Run ``scan`` on one twin, failing over to the survivors IN THE
        SAME CALL on error; a deadline-slow completion returns its (valid)
        result but strikes the breaker for later picks."""
        from ..obs import requestlog

        tried: set = set()
        last_exc = None
        while True:
            j = self._pick(tried)
            if j is None:
                with self._hlock:
                    fenced = sum(
                        1 for h in self._health
                        if h.stale or h.fenced_until is not None)
                raise ReplicaUnavailableError(
                    f"replica group {self._name!r}: no replica can serve "
                    f"({fenced}/{len(self._replicas)} fenced or stale, "
                    f"{len(tried)} failed this call)",
                    name=self._name, replicas=len(self._replicas),
                    fenced=fenced) from last_exc
            tried.add(j)
            t0 = self._clock()
            try:
                with requestlog.prefix(f"r{j}/"):
                    faults.fire("replica/search",
                                replica=self._replicas[j].name, attempt=j)
                    out = scan(states[j], queries, k, res=res)
            except ReplicaUnavailableError:
                raise
            except faults.FaultError as e:
                last_exc = e
                self._strike(j, "error", exc=e)
                continue
            except RaftError:
                # a caller's error (query shape, dim, k): every twin refuses
                # it alike, so it must not strike the breaker
                raise
            except Exception as e:
                last_exc = e
                self._strike(j, "error", exc=e)
                continue
            self._observe_ok(j, self._clock() - t0)
            if metrics._enabled:
                if len(tried) > 1:
                    _c_failovers().inc(len(tried) - 1, name=self._name)
                _c_reads().inc(1, name=self._name, replica=f"r{j}")
            if len(tried) > 1:
                obs_events.emit(
                    "replica_failover",
                    subject=("replica", self._name, j, None),
                    evidence={"retried": len(tried) - 1,
                              "error": repr(last_exc)})
            requestlog.annotate("replica", j)
            return out

    # -- reads ---------------------------------------------------------------
    def pin_group(self) -> _PinnedGroup:
        """Freeze every twin's current state epoch behind the live failover:
        what a serving hook (and the sharded scatter) holds across swaps."""
        return _PinnedGroup(self, tuple(r._state for r in self._replicas))

    def search(self, queries, k: int, res=None):
        """One twin's merged search with same-call failover (the
        :meth:`MutableIndex.search` contract)."""
        return self.pin_group().search(queries, k, res=res)

    def _exact_scan(self, queries, k: int, res=None):
        """The exact-oracle scan half through the failover (the sharded
        ``exact_search`` calls this per shard)."""
        return self._failover(
            tuple(range(len(self._replicas))), queries, k,
            lambda j, q, kk, res=None: self._replicas[j]._exact_scan(
                q, kk, res=res),
            res=res)

    def exact_search(self, queries, k: int, res=None):
        """Exact kNN over the live corpus through any live twin."""
        sd, si, dd, di = self._exact_scan(queries, k, res=res)
        return _mut._merge(sd, si, dd, di, int(k), self._cfg.select_min)

    def searcher(self):
        """Serving hook pinned to the group's current epochs, failover
        inside."""
        from ..neighbors._hooks import make_hook

        pin = self.pin_group()
        cfg = self._cfg
        fn = make_hook(lambda queries, k: pin.search(queries, k),
                       f"stream/replicated/{cfg.kind}", cfg.dim,
                       cfg.data_kind, cfg.device)
        fn.mutable = self
        return fn

    # -- writes --------------------------------------------------------------
    def _delta_rows_now(self) -> int:
        return max(r._delta_rows_now() for r in self._live())

    def _growth_bytes(self, r: int) -> int:
        return sum(rep._growth_bytes(r) for rep in self._live())

    def _live(self) -> list[MutableIndex]:
        return [rep for rep, h in zip(self._replicas, self._health)
                if not h.stale] or [self._replicas[0]]

    def _live_pairs(self) -> list:
        live = [(j, self._replicas[j]) for j in range(len(self._replicas))
                if not self._health[j].stale]
        if not live:
            raise ReplicaUnavailableError(
                f"replica group {self._name!r}: every replica is "
                "stale — refusing the write (acknowledging it with "
                "no twin to hold it would lose it); rebuild the "
                "group", name=self._name,
                replicas=len(self._replicas),
                fenced=len(self._replicas))
        return live

    def upsert(self, rows, ids=None, res=None):
        """Insert / upsert on every live twin. Capacity and the memory
        budget are checked across the group before the WAL append and
        before any twin writes; a twin that fails past admission goes
        stale, and the write succeeds while one twin applied it."""
        rows = self._coerce_rows(rows)
        r = rows.shape[0]
        expects(r >= 1, "upsert needs at least one row")
        with self._lock:
            live = self._live_pairs()
            gids = self._assign_ids(r, ids)
            for j, rep in live:
                if rep._delta_rows_now() + r > rep.delta_capacity:
                    if metrics._enabled:
                        _mut._c_delta_full().inc(1, name=self._name)
                    raise _mut.DeltaFullError(
                        f"replica {rep.name} delta at "
                        f"{rep._delta_rows_now()}/{rep.delta_capacity} "
                        f"rows; upsert of {r} refused — compact() to fold")
            obs_mem.gate(res or default_resources(),
                         lambda: self._growth_bytes(r),
                         site="upsert",
                         detail=f"stream/replicated {self._name!r}")
            wal_prev = (self._wal.size_bytes
                        if self._wal is not None else None)
            if self._wal is not None:
                self._wal_seq = self._wal.append_upsert(rows, gids)
                faults.fire("stream/post-wal", name=self._name, op="upsert")
            inner = _budget_free(res)
            self._apply(live, "upsert",
                        lambda rep: rep.upsert(rows, ids=gids, res=inner),
                        wal_prev=wal_prev)
        return gids

    def delete(self, ids) -> int:
        """Tombstone ids on every live twin; returns how many were live (the
        first live twin's count)."""
        arr = np.asarray(_mut._host(ids), np.int64).reshape(-1)
        if arr.size == 0:
            return 0
        with self._lock:
            live = self._live_pairs()
            wal_prev = (self._wal.size_bytes
                        if self._wal is not None else None)
            if self._wal is not None:
                self._wal_seq = self._wal.append_delete(arr)
                faults.fire("stream/post-wal", name=self._name, op="delete")
            box: dict = {}

            def do(rep, _box=box):
                n = rep.delete(arr)
                _box.setdefault("n", n)

            self._apply(live, "delete", do, wal_prev=wal_prev)
        return int(box.get("n", 0))

    def _assign_ids(self, r: int, ids):
        if ids is None:
            base = self._next_id
            return np.arange(base, base + r, dtype=np.int64)
        return _mut.check_upsert_ids(ids, r)

    def _apply(self, live, op: str, fn, wal_prev=None) -> None:
        """Forward one admitted write to every live twin; a raising twin
        goes STALE. If EVERY twin failed, the write failed: its WAL record
        is rolled back (recovery must not bring back a write the caller was
        told did not land) and the last error re-raises."""
        ok = 0
        last = None
        for j, rep in live:
            try:
                faults.fire(f"replica/{op}", replica=rep.name)
                fn(rep)
                ok += 1
            except Exception as e:
                last = e
                with self._hlock:
                    h = self._health[j]
                    h.stale = True
                    h.last_error = e
                if metrics._enabled:
                    _c_fenced().inc(1, name=self._name, reason="write")
                obs_events.emit(
                    "replica_stale",
                    subject=("replica", self._name, j, None),
                    evidence={"op": op, "error": repr(e)})
        with self._hlock:
            self._update_health_gauges()
        if ok == 0 and last is not None:
            if self._wal is not None and wal_prev is not None:
                self._wal.rollback_last(self._wal_seq, wal_prev)
                self._wal_seq -= 1
            raise last

    # -- compaction / warm / durability --------------------------------------
    def compact(self, mode: str = "auto", res=None,
                trigger: str | None = None,
                ooc_chunk_rows: int | None = None) -> dict:
        """Fold every live twin through its own fold and swap. The report is
        the primary fold's plus per-replica walls; with group durability
        armed, the post-fold snapshot and WAL truncation ride here."""
        reports = []
        for rep in self._live():
            reports.append(rep.compact(mode=mode, res=res,
                                       ooc_chunk_rows=ooc_chunk_rows))
        report = dict(reports[0])
        report["replica_wall_s"] = [rp["wall_s"] for rp in reports]
        if self._wal is not None and self._snapshot_path is not None:
            self.save(self._snapshot_path)
            report["snapshot"] = self._snapshot_path
        return report

    def warm(self, buckets, ks=(10,), sample=None) -> dict:
        """Warm EVERY twin's delta ladder: a twin never picked must be ready
        the moment its sibling is fenced."""
        return {f"r{j}": rep.warm(buckets, ks=ks, sample=sample)
                for j, rep in enumerate(self._replicas)}

    def save(self, path: str) -> None:
        """Atomic group snapshot: the primary twin's state stamped with the
        GROUP's WAL seq, then the group log truncates. Recovery:
        ``stream.load(path, wal=...)``, a degraded-to-one restore."""
        with self._lock:
            primary = self._primary()
            with primary._lock:
                primary._wal_seq = self._wal_seq
                _mut.save(primary, path)
            if self._wal is not None:
                self._wal.reset()


def _budget_free(res):
    """The handle the per-twin (and per-shard) writes run with once the
    hoisted admission passed: the caller's without its memory budget, so a
    twin's own gate cannot refuse halfway through a group write."""
    inner = res or default_resources()
    if getattr(inner, "memory_budget_bytes", None) is not None:
        inner = dataclasses.replace(inner, memory_budget_bytes=None)
    return inner
