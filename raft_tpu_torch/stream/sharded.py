"""ShardedMutableIndex: the mutable serve + stream lifecycle across shards.

Counterpart of raft_tpu/stream/sharded.py. Everything
:class:`~raft_tpu_torch.stream.MutableIndex` does on one index (delta
memtable, tombstones, warm compaction swaps), composed S ways:

- **Hash-routed writes.** Every global id has one home shard
  (:func:`shard_of`, a SplitMix64-style mix, the JAX function bit for bit:
  a restart, or the other package, routes identically). Each shard is a
  full :class:`MutableIndex` whose ``ids=`` carry the global ids, so its
  sealed build stays dense while its results surface global ids.
- **Scatter-gather search.** A query batch goes to every shard; each gives
  its sealed and delta candidate sets with global ids, and all ``2S``
  parts merge through ONE top-k. A delta part narrower than k is padded to
  k, after its real candidates, with the shared ``-1 / ±inf`` sentinel, so
  the merge runs at ``(m, 2S·k)`` whatever the deltas hold; parts are
  concatenated shard by shard, sealed then delta, and ties go to the lowest
  position, which is the JAX order and what makes a 1-shard mesh equal a
  plain MutableIndex bit for bit.
- **Staggered compaction.** :meth:`ShardedMutableIndex.compact` folds ONE
  shard a call (the most due one); the others keep serving their epochs. A
  :class:`~raft_tpu_torch.stream.Compactor` drives it unchanged: ``stats()``
  reports the binding shard's watermarks.
- **Elastic resharding** (:meth:`ShardedMutableIndex.reshard`): online
  power-of-two split and merge. ``shard_of`` routes by ``h % S``, so a
  doubling sends every id of shard ``s`` to ``s`` or ``s + S``: each step
  folds one donor shard at a time into its successors while the donors keep
  serving reads and writes, warms the new topology before the flip (through
  the registry's pre-flip ``publish(warm_hook=)`` seam when a publisher
  drives it), carries over the writes that landed mid-migration and flips
  the shard list atomically. Flushes in flight finish on the topology they
  leased.
- **Mesh durability** (``wal_dir=``): one WAL per shard group, an atomic
  snapshot per shard and a topology manifest whose atomic rename is the
  commit point of :meth:`save` and of a reshard. The manifest and the
  snapshots are the JAX package's files byte for byte, so a mesh directory
  saved by either package loads in the other. A crash before the manifest
  lands recovers the old topology with no acknowledged write lost (fault
  points ``reshard/split``, ``reshard/flip``, ``reshard/manifest``).

**On one card.** ``devices=None`` leaves every shard on the device its
sealed index was built on: on one H100 every shard is on ``cuda:0``, the
per-shard scans run one after another on the device's current stream, and
the gather moves nothing (``stream_moved_parts`` is 0). ``devices=`` (a
list of torch devices) puts shard ``s`` on ``devices[s % len(devices)]``
and gathers the candidate parts onto ``devices[0]`` for the merge.
``comms=`` (a :class:`~raft_tpu_torch.comms.Comms` of one rank) takes
its rank's device: shard ``s`` on ``comms.devices[s % D]``. A communicator
of several ranks is refused: every rank, a process of its own, would build
every shard.

Serving is duck-typed: ``SearchService.publish`` and the registry resolve a
mesh as they resolve a ``MutableIndex`` (``upsert`` / ``searcher``; the
hook's ``fn.mutable`` routes writes), :meth:`exact_search` composes the
shards' exact scans through the same merge so ``obs.quality.exact_oracle``
covers the mesh, and request-log spans are prefixed ``stream/shard<i>/``.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.errors import expects
from ..core.resources import default_resources
from ..obs import dispatch as obs_dispatch
from ..obs import events as obs_events
from ..obs import mem as obs_mem
from ..obs import metrics
from ..testing import faults
from . import mutable as _mut
from .mutable import DeltaFullError, MutableIndex
from .replicated import FencingPolicy, ReplicatedShard, _budget_free, _PinnedGroup
from .tiered import TieredStore

__all__ = ["ShardedMutableIndex", "shard_of"]

# the topology manifest's file name inside a mesh's wal_dir / save dir
_MANIFEST = "manifest"


# -- the one merge ------------------------------------------------------------

def _pad_part(d, i, k: int, select_min: bool):
    """Widen a (m, kd < k) candidate part to width k with the shared
    underfill sentinel (id -1 at ±inf), AFTER the real candidates."""
    obs_dispatch.note(1)
    m, kd = d.shape
    fill = float("inf") if select_min else float("-inf")
    return (torch.cat([d, d.new_full((m, k - kd), fill)], 1),
            torch.cat([i, i.new_full((m, k - kd), -1)], 1))


def _merge_parts(ds, is_, k: int, select_min: bool):
    """The 2S parts, each of width k, merged by one top-k on the plain
    route (ties to the lowest column); underfilled slots get id -1."""
    from ..matrix.select_k import select_k_impl

    obs_dispatch.note(1)
    d = torch.cat(list(ds), 1)
    i = torch.cat([x.to(is_[0].dtype) for x in is_], 1)
    dv, iv = select_k_impl(d, i, int(k), bool(select_min), impl="torch")
    return dv, torch.where(torch.isinf(dv), torch.full_like(iv, -1), iv)


def _serving_scan(st, queries, k, res=None):
    """One shard's serving scan: the sealed width clamps to the shard's
    sealed rows (a small shard gives what it has; the merge pads)."""
    return _mut._scan_state(st, queries, k, res=res,
                            k_sealed=min(int(k), st.id_map.shape[0]))


def _view_scan(view, queries, k, res=None):
    """One shard's scan over a pinned view: a plain shard's state runs the
    one-index scan, a replica group's view its health-picked twin with
    same-call failover."""
    if isinstance(view, _PinnedGroup):
        return view.scan_serving(queries, k, res=res)
    return _serving_scan(view, queries, k, res=res)


def _gather_parts(parts_d, parts_i, device):
    """Move the candidate parts onto the merge ``device``, skipping those
    already there. Returns ``(parts_d, parts_i, moved)``; with no merge
    device (every shard on one device) nothing moves."""
    if device is None:
        return list(parts_d), list(parts_i), 0
    arrays = list(parts_d) + list(parts_i)
    moved = 0
    for j, a in enumerate(arrays):
        if a.device != device:
            arrays[j] = a.to(device)
            moved += 1
    if moved:
        obs_dispatch.note(moved)
    s = len(parts_d)
    return arrays[:s], arrays[s:], moved


@functools.lru_cache(maxsize=None)
def _g_shards():
    return metrics.gauge(
        "raft_tpu_stream_shards",
        "shard count of a sharded mutable index (per-shard series report "
        "under name/shard<i>)")


@functools.lru_cache(maxsize=None)
def _c_migrations():
    return metrics.counter(
        "raft_tpu_reshard_migrations_total",
        "reshard migrations by action (split/merge) and phase "
        "(started/completed) — started without completed is an aborted "
        "or crashed migration, which recovery resolves to the old "
        "topology")


@functools.lru_cache(maxsize=None)
def _c_rows_moved():
    return metrics.counter(
        "raft_tpu_reshard_rows_moved_total",
        "live rows folded from donor shards into reshard successors",
        unit="rows")


@functools.lru_cache(maxsize=None)
def _h_reshard():
    return metrics.histogram(
        "raft_tpu_reshard_seconds",
        "one reshard step's wall seconds (fold + warm + carry-over + "
        "flip + manifest, off the serving hot path)", unit="seconds")


def shard_of(ids, n_shards: int):
    """Stable home shard of each global id: a SplitMix64-style avalanche
    mix mod the shard count, independent of insertion order or shard state
    (the JAX package's routing, bit for bit)."""
    h = np.asarray(_mut._host(ids), np.uint64)
    h = (h + np.uint64(0x9E3779B97F4A7C15))
    h ^= h >> np.uint64(30)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(27)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(31)
    return (h % np.uint64(n_shards)).astype(np.int64)


def _units(sh) -> tuple:
    """The MutableIndex objects of a shard: its twins, or itself."""
    return sh.replicas if isinstance(sh, ReplicatedShard) else (sh,)


def _comms_devices(comms, devices) -> list:
    """The devices a ``comms=`` communicator stands for: its one rank's.

    A communicator of several ranks is refused. Each rank is a process of
    its own, so a mesh built on every rank would hold every shard, on the
    other ranks' cards too (the JAX package's one controller builds each
    shard once); a mesh that keeps only a rank's shards and merges over the
    communicator is not built yet."""
    expects(devices is None, "pass devices= or comms=, not both")
    expects(comms.size() == 1,
            "comms= takes a communicator of one rank, got %d: each rank would "
            "build every shard; pass devices= in one process", comms.size())
    return list(comms.devices)


class ShardedMutableIndex:
    """Mesh-wide mutable index (see module docstring).

    ``dataset`` (n, d) rows (an array, a tensor or a
    :class:`~raft_tpu_torch.core.chunked.ChunkedReader`, of which each shard
    gathers only its own rows) are routed to ``n_shards`` home shards by
    :func:`shard_of` over their global ids (``ids=``, default the row
    range), and each shard's sealed index is ``build(rows)`` (any
    ``fn(rows) -> sealed index``; size per-shard knobs such as ``n_lists``
    for rows / S). Every shard must own at least one row.

    ``devices`` (torch devices) puts shard ``s`` on ``devices[s]`` and
    gathers the candidates onto ``devices[0]`` for the merge; ``comms`` (a
    communicator of one rank, not with ``devices``) puts shard ``s`` on
    ``comms.devices[s % D]``; without either every shard stays where
    ``build`` put it. ``replicas=R`` makes every
    shard a :class:`ReplicatedShard` (twin ``j`` of shard ``s`` on
    ``devices[(s*R + j) % D]``) under ``fencing``.
    ``search_params`` / ``index_params`` / ``builder`` / ``delta_capacity``
    (per shard) / ``retain_vectors`` / ``storage`` / ``tier`` / ``clock``
    go to every shard's :class:`MutableIndex` (``storage="tiered"``: one
    :class:`~raft_tpu_torch.stream.tiered.TieredStore` per shard). The
    retained row store defaults on (the constructor holds each shard's rows
    anyway), so rebuild compaction, :meth:`exact_search` and
    :meth:`reshard` work; ``retain_vectors=False`` drops it.

    ``wal_dir`` arms mesh durability: one WAL per shard group
    (``<wal_dir>/shard<i>.e<epoch>.wal``), per-shard atomic snapshots and
    the manifest, written at construction so :meth:`load` recovers from the
    first acknowledged write. A directory that already holds a manifest is
    refused (recover it with :meth:`load`)."""

    def __init__(self, dataset, *, n_shards: int, build: Callable,
                 ids=None, search_params=None, index_params=None,
                 builder: Callable | None = None,
                 delta_capacity: int = 1024,
                 retain_vectors: bool | None = None,
                 devices: Sequence | None = None, comms=None,
                 replicas: int = 1,
                 fencing: FencingPolicy | None = None,
                 wal_dir: str | None = None,
                 name: str = "default",
                 storage: str = "hbm", tier=None,
                 clock: Callable[[], float] = time.monotonic):
        from ..core import chunked

        stream = chunked.is_reader(dataset)
        if not stream:
            dataset = _mut._host(dataset)
        expects(dataset.ndim == 2, "dataset must be (rows, d)")
        n = int(dataset.shape[0])
        n_shards = int(n_shards)
        expects(n_shards >= 1, "n_shards must be >= 1, got %d", n_shards)
        if ids is None:
            gids = np.arange(n, dtype=np.int64)
        else:
            gids = np.asarray(_mut._host(ids), np.int64).reshape(-1)
            expects(gids.shape == (n,), "ids= must match dataset rows (%d)", n)
        if comms is not None:
            devices = _comms_devices(comms, devices)
            if int(replicas) == 1:
                devices = [devices[s % len(devices)] for s in range(n_shards)]
        if devices is not None:
            devices = [torch.device(dv) for dv in devices]
            expects(len(devices) >= n_shards,
                    "%d shards need %d devices, got %d", n_shards, n_shards,
                    len(devices))
        owner = shard_of(gids, n_shards)
        self._name = name
        self._clock = clock  # a Compactor inherits it (one age time base)
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()
        R = int(replicas)
        expects(R >= 1, "replicas must be >= 1, got %d", R)
        if R > 1 and devices is not None:
            # twins of one shard land on devices[(s*R + j) % D]: they collide
            # iff D < R, which would void the anti-affinity a group promises
            # (devices=None for unpinned twins)
            expects(len(devices) >= R,
                    "replica anti-affinity needs >= %d devices so twins "
                    "of one shard land on different devices, got %d",
                    R, len(devices))
        # the shard recipe, kept whole: reshard successors are built with
        # exactly what the originals were
        self._build_fn = build
        self._search_params = search_params
        self._index_params = index_params
        self._builder = builder
        self._delta_capacity = int(delta_capacity)
        self._retain_vectors = retain_vectors
        self._storage = storage
        self._tier = tier
        self._devices = devices
        self._replicas_n = R
        self._fencing = fencing
        self._topology_epoch = 0
        self._migration: dict | None = None
        self._wal_dir = os.fspath(wal_dir) if wal_dir is not None else None
        if self._wal_dir is not None:
            os.makedirs(self._wal_dir, exist_ok=True)
            # a committed manifest belongs to an earlier life of a mesh,
            # possibly at another topology epoch: a fresh epoch-0 manifest
            # would orphan its acknowledged writes
            expects(not os.path.exists(
                os.path.join(self._wal_dir, _MANIFEST)),
                "wal_dir %r already holds a mesh manifest — recover that "
                "mesh with ShardedMutableIndex.load() (a fresh mesh here "
                "would shadow its acknowledged writes) or point at a "
                "fresh directory", self._wal_dir)
        self._shards: list = []
        for s in range(n_shards):
            rows_idx = np.nonzero(owner == s)[0]
            expects(len(rows_idx) > 0,
                    "shard %d of %d owns no rows (n=%d) — use fewer shards",
                    s, n_shards, n)
            wal_path = snap_path = None
            if self._wal_dir is not None:
                snap_path, wal_path = self._shard_files(s)
            rows_s = (dataset.take(rows_idx) if stream
                      else dataset[rows_idx])
            self._shards.append(self._make_shard(
                rows_s, gids[rows_idx], s, n_shards,
                wal=wal_path, snapshot_path=snap_path))
        self._next_id = int(gids.max()) + 1 if n else 0
        self._finish_init()
        if self._wal_dir is not None:
            # durable by construction: baseline snapshots and the manifest
            # land before the first write can be acknowledged
            self.save()

    @staticmethod
    def _shard_names(s: int, e: int) -> tuple:
        """(snapshot, wal) FILE NAMES of shard ``s`` at topology epoch
        ``e``: construction, save(), the manifest and the reshard commit
        all derive from here."""
        return f"shard{s}.e{e}.idx", f"shard{s}.e{e}.wal"

    def _shard_files(self, s: int, epoch: int | None = None,
                     dir: str | None = None) -> tuple:
        """(snapshot, wal) paths of shard ``s`` at a topology epoch (epoch-
        keyed, so a crashed reshard's successor files never pass for the old
        topology's)."""
        e = self._topology_epoch if epoch is None else int(epoch)
        sn, wn = self._shard_names(s, e)
        d = self._wal_dir if dir is None else dir
        return os.path.join(d, sn), os.path.join(d, wn)

    def _make_shard(self, rows_s, gids_s, s: int, total: int, *,
                    wal=None, snapshot_path=None):
        """Build the home shard at ordinal ``s`` of a ``total``-shard
        topology: the one recipe of construction and resharding. Ordinals
        past the device list wrap around it."""
        sealed = self._build_fn(rows_s)
        devices = self._devices
        rows_s = _mut._host(rows_s)
        if self._replicas_n == 1:
            return MutableIndex(
                sealed, search_params=self._search_params,
                index_params=self._index_params,
                delta_capacity=self._delta_capacity,
                retain_vectors=self._retain_vectors,
                dataset=(None if self._retain_vectors is False else rows_s),
                builder=self._builder, ids=gids_s,
                device=(devices[s % len(devices)] if devices is not None
                        else None),
                wal=wal, snapshot_path=snapshot_path,
                storage=self._storage, tier=self._tier,
                name=f"{self._name}/shard{s}", shard=s, clock=self._clock)
        R = self._replicas_n
        return ReplicatedShard(
            sealed, n_replicas=R,
            devices=([devices[(s * R + j) % len(devices)]
                      for j in range(R)] if devices is not None else None),
            search_params=self._search_params,
            index_params=self._index_params,
            delta_capacity=self._delta_capacity,
            retain_vectors=self._retain_vectors,
            dataset=(None if self._retain_vectors is False else rows_s),
            builder=self._builder, ids=gids_s,
            policy=self._fencing or FencingPolicy(),
            wal=wal, snapshot_path=snapshot_path,
            storage=self._storage, tier=self._tier,
            name=f"{self._name}/shard{s}", shard=s, clock=self._clock)

    def _finish_init(self) -> None:
        """Shared tail of ``__init__`` and :meth:`load`: cross-shard config
        consistency, the merge device, the gauge baseline."""
        cfg0 = self._shards[0]._cfg
        for s, sh in enumerate(self._shards[1:], 1):
            expects(sh._cfg.kind == cfg0.kind and sh._cfg.dim == cfg0.dim
                    and sh._cfg.query_dtype == cfg0.query_dtype,
                    "shard %d built a (%s, %d, %s) index but shard 0 is "
                    "(%s, %d, %s) — build must be deterministic in kind",
                    s, sh._cfg.kind, sh._cfg.dim, sh._cfg.query_dtype,
                    cfg0.kind, cfg0.dim, cfg0.query_dtype)
        self._select_min = cfg0.select_min
        self._merge_device = (self._devices[0]
                              if self._devices is not None else None)
        self._update_gauges()

    # -- introspection ------------------------------------------------------
    @property
    def kind(self) -> str:
        return self._shards[0].kind

    @property
    def dim(self) -> int:
        return self._shards[0].dim

    @property
    def name(self) -> str:
        return self._name

    @property
    def query_dtype(self) -> str:
        return self._shards[0].query_dtype

    @property
    def device(self) -> torch.device:
        """Where the merge runs and results come back: ``devices[0]``, or
        shard 0's device."""
        return (self._merge_device if self._merge_device is not None
                else self._shards[0]._cfg.device)

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def shards(self) -> tuple:
        """The per-shard :class:`MutableIndex` (or :class:`ReplicatedShard`)
        objects, a read-only tuple: write through the mesh so routing stays
        consistent."""
        return tuple(self._shards)

    @property
    def can_rebuild(self) -> bool:
        return all(sh.can_rebuild for sh in self._shards)

    @property
    def size(self) -> int:
        return sum(sh.size for sh in self._shards)

    @property
    def uploaded_bytes(self) -> int:
        """Host-to-device bytes every shard's writes, swaps and store copies
        have uploaded so far."""
        return sum(sh.uploaded_bytes for sh in self._shards)

    def stats(self) -> dict:
        """Aggregate view plus ``per_shard`` detail. The watermarks a
        :class:`~raft_tpu_torch.stream.Compactor` reads are the BINDING
        shard's: ``delta_fill`` / ``tombstone_ratio`` are maxima and
        ``delta_oldest_at`` the minimum, so an aggregate watermark trips
        exactly when some shard needs a fold, and :meth:`compact` folds
        that shard."""
        per = [sh.stats() for sh in self._shards]
        oldest = [p["delta_oldest_at"] for p in per
                  if p["delta_oldest_at"] is not None]
        return {
            "live": sum(p["live"] for p in per),
            "sealed_rows": sum(p["sealed_rows"] for p in per),
            "sealed_dead": sum(p["sealed_dead"] for p in per),
            "tombstone_ratio": max(p["tombstone_ratio"] for p in per),
            "delta_rows": sum(p["delta_rows"] for p in per),
            "delta_fill": max(p["delta_fill"] for p in per),
            "delta_oldest_at": min(oldest) if oldest else None,
            "epoch": sum(p["epoch"] for p in per),
            "shards": len(per),
            "per_shard": per,
            # replica groups: healthy is the WORST shard's pickable twins
            **({"replicas": sum(p.get("replicas", 1) for p in per),
                "healthy": min(p.get("healthy", 1) for p in per),
                "stale": sum(p.get("stale", 0) for p in per)}
               if any("replicas" in p for p in per) else {}),
        }

    def health(self) -> dict:
        """Per-shard replica-group health (the ``/healthz`` detail) and the
        live migration state: a shard with ZERO pickable twins means its
        queries fail."""
        shards = [sh.health() if isinstance(sh, ReplicatedShard)
                  else {"name": sh.name, "replicas": [], "healthy": 1}
                  for sh in self._shards]
        with self._lock:
            migration = (dict(self._migration)
                         if self._migration is not None else None)
        return {"name": self._name, "shards": shards,
                "healthy_min": min(s["healthy"] for s in shards),
                "reshard": migration}

    def _update_gauges(self, st: dict | None = None) -> None:
        if not metrics._enabled:
            return
        st = self.stats() if st is None else st
        name = self._name
        _g_shards().set(st["shards"], name=name)
        # the aggregate under the mesh's name; each shard reports under
        # name/shard<i>
        _mut._g_delta_fill().set(st["delta_fill"], name=name)
        _mut._g_delta_rows().set(st["delta_rows"], name=name)
        _mut._g_tombstone().set(st["tombstone_ratio"], name=name)

    def _drift_store(self):
        """Cross-shard corpus sample for the drift detector: the first rows
        of every shard's store (None when a shard dropped its store)."""
        stores = [sh._drift_store() for sh in self._shards]
        if any(s is None for s in stores):
            return None
        cap = max(4096 // len(stores), 256)
        return np.concatenate([s[:cap] for s in stores])

    # -- writes -------------------------------------------------------------
    def upsert(self, rows, ids=None, res=None):
        """Insert / upsert rows, each routed to its id's home shard.
        Admission is checked across ALL touched shards before any row lands:
        one full home shard refuses the whole call with
        :class:`~raft_tpu_torch.stream.DeltaFullError`, and the summed delta
        growth of the touched shards is gated against
        ``res.memory_budget_bytes``
        (:class:`~raft_tpu_torch.serve.errors.MemoryBudgetError`). Either
        way nothing is written."""
        rows = self._shards[0]._coerce_rows(rows)
        r = rows.shape[0]
        expects(r >= 1, "upsert needs at least one row")
        with self._lock:
            if ids is None:
                gids = np.arange(self._next_id, self._next_id + r,
                                 dtype=np.int64)
            else:
                gids = _mut.check_upsert_ids(ids, r)
            self._next_id = max(self._next_id, int(gids.max()) + 1)
            owner = shard_of(gids, len(self._shards))
            groups = [np.nonzero(owner == s)[0]
                      for s in range(len(self._shards))]
            for s, idx in enumerate(groups):
                sh = self._shards[s]
                # a concurrent fold only SHRINKS a delta: a stale read here
                # can over-refuse, never admit past capacity
                if len(idx) and (sh._delta_rows_now() + len(idx)
                                 > sh.delta_capacity):
                    if metrics._enabled:
                        _mut._c_delta_full().inc(1, name=self._name)
                    raise DeltaFullError(
                        f"shard {s} delta at {sh._delta_rows_now()}"
                        f"/{sh.delta_capacity} rows; upsert routing "
                        f"{len(idx)} there refused — compact() (or attach "
                        "a stream.Compactor) to fold it")
            obs_mem.gate(
                res or default_resources(),
                lambda: sum(
                    self._shards[s]._growth_bytes(len(idx))
                    for s, idx in enumerate(groups) if len(idx)),
                site="upsert", detail=f"stream/sharded {self._name!r}")
            # the hoisted pass IS the admission: the per-shard writes run
            # budget-free so none can refuse after a sibling wrote
            inner = _budget_free(res)
            for s, idx in enumerate(groups):
                if len(idx):
                    self._shards[s].upsert(rows[idx], ids=gids[idx],
                                           res=inner)
            self._update_gauges()
        return gids

    def delete(self, ids) -> int:
        """Tombstone ids on their home shards; returns how many were live.
        Unknown or dead ids are a counted no-op."""
        arr = np.asarray(_mut._host(ids), np.int64).reshape(-1)
        if arr.size == 0:
            return 0
        with self._lock:
            owner = shard_of(arr, len(self._shards))
            killed = 0
            for s in range(len(self._shards)):
                idx = np.nonzero(owner == s)[0]
                if len(idx):
                    killed += self._shards[s].delete(arr[idx])
            self._update_gauges()
        return killed

    # -- reads --------------------------------------------------------------
    def _scatter_gather(self, states, queries, k: int, scan, res=None):
        """Run ``scan`` on every shard state (one after another on one
        device's stream), collect each shard's sealed and delta parts, pad
        them to k and merge the ``2S`` parts through ONE top-k. Host queries
        cross to the device once, not once a shard."""
        from ..obs import requestlog

        k = int(k)
        if not isinstance(queries, torch.Tensor):
            queries = torch.as_tensor(_mut._host(queries)).to(self.device)
        parts_d, parts_i = [], []
        for s, st in enumerate(states):
            with requestlog.prefix(f"stream/shard{s}/"):
                sd, si, dd, di = scan(st, queries, k, res=res)
            for d, i in ((sd, si), (dd, di)):
                if d.shape[1] < k:
                    d, i = _pad_part(d, i, k, self._select_min)
                parts_d.append(d)
                parts_i.append(i)
        t0 = time.perf_counter()
        parts_d, parts_i, moved = _gather_parts(parts_d, parts_i,
                                                self._merge_device)
        out = _merge_parts(parts_d, parts_i, k, self._select_min)
        requestlog.add_span("stream/merge", time.perf_counter() - t0)
        requestlog.annotate("stream_shards", len(states))
        requestlog.annotate("stream_moved_parts", moved)
        return out

    def search(self, queries, k: int, res=None):
        """Scatter-gather search over every shard's (sealed − tombstones) +
        delta; returns ``(distances (m, k), global ids (m, k))`` with the
        shared ``-1 / ±inf`` sentinel in slots the live rows cannot fill,
        the :meth:`MutableIndex.search` contract. With ``replicas > 1``
        each shard's scan runs on its group's picked twin, failing over
        within the call."""
        return self._scatter_gather(self._views(), queries, k,
                                    _view_scan, res=res)

    def _views(self) -> tuple:
        """Per-shard read views: a plain shard's current state, a replica
        group's pinned twins behind the live failover."""
        return tuple(sh.pin_group() if isinstance(sh, ReplicatedShard)
                     else sh._state for sh in self._shards)

    def exact_search(self, queries, k: int, res=None):
        """EXACT kNN over the mesh's live corpus: the shards' exact store +
        delta scans through the same merge as :meth:`search` (the recall
        canary's oracle). Needs every shard's retained store."""
        shards = tuple(self._shards)

        def scan(sh, q, kk, res=None):
            return sh._exact_scan(q, kk, res=res)

        return self._scatter_gather(shards, queries, k, scan, res=res)

    def search_refined(self, queries, k: int, refine_ratio: int = 4,
                       res=None):
        """Scatter-gather :meth:`MutableIndex.search_refined`: each shard
        widens its PQ scan to ``k * refine_ratio``, refines against its OWN
        (tiered) store, and the refined and delta parts merge as in
        :meth:`search`. A 1-shard mesh equals the plain index's
        ``search_refined`` bit for bit."""
        shards = tuple(self._shards)
        expects(all(not isinstance(sh, ReplicatedShard) for sh in shards),
                "search_refined does not route replica groups yet — "
                "serve replicas=1 shards tiered, or use search()")

        def scan(sh, q, kk, res=None):
            return sh._refined_scan(q, kk, refine_ratio, res=res)

        return self._scatter_gather(shards, queries, k, scan, res=res)

    def refined_searcher(self, refine_ratio: int = 4):
        """Serving hook over :meth:`search_refined`, every shard's current
        state epoch pinned at hook creation (the lease-drain contract of
        :meth:`searcher`)."""
        from ..neighbors._hooks import make_hook

        shards = tuple(self._shards)
        expects(all(not isinstance(sh, ReplicatedShard) for sh in shards),
                "refined_searcher does not route replica groups yet — "
                "serve replicas=1 shards tiered, or use searcher()")
        pinned = tuple((sh, sh._state) for sh in shards)
        cfg0 = shards[0]._cfg

        def scan(pin, q, kk, res=None):
            sh, st = pin
            return sh._refined_scan(q, kk, refine_ratio, res=res, st=st)

        fn = make_hook(
            lambda queries, k: self._scatter_gather(pinned, queries, k,
                                                    scan),
            f"stream/sharded/{cfg0.kind}+refine", cfg0.dim, cfg0.data_kind,
            self.device)
        fn.mutable = self
        return fn

    def searcher(self):
        """Serving hook pinned to every shard's CURRENT state epoch (the
        ``batched_searcher`` contract). A staggered fold freezes only the
        folded shard's epoch in an issued hook, and a reshard the donor
        shards'; a republish (what the Compactor and :meth:`reshard` do)
        picks up the successors."""
        return self._searcher_for(tuple(self._shards))

    def _searcher_for(self, shards):
        """The serving hook over an explicit shard list: what
        :meth:`reshard` publishes for the successor topology BEFORE the
        flip, so the registry's bucket warm runs it while the old topology
        serves."""
        from ..neighbors._hooks import make_hook

        states = tuple(sh.pin_group() if isinstance(sh, ReplicatedShard)
                       else sh._state for sh in shards)
        cfg0 = shards[0]._cfg
        fn = make_hook(
            lambda queries, k: self._scatter_gather(
                states, queries, k, _view_scan),
            f"stream/sharded/{cfg0.kind}", cfg0.dim, cfg0.data_kind,
            self._merge_device if self._merge_device is not None
            else cfg0.device)
        # the serve write path follows this across republishes
        fn.mutable = self
        return fn

    # -- warmup -------------------------------------------------------------
    def warm(self, buckets, ks=(10,), sample=None) -> dict:
        """Run the mesh's delta ladder once per (query bucket, k): every
        shard's (every twin's) delta scan at every memtable bucket, the pads
        and the one merge at ``(m, 2S·k)``, so the kernels those shapes need
        are built (``obs.compile``) and the allocator holds their blocks
        before a write grows a delta onto them. The sealed side is warmed
        per epoch by ``registry.publish``. Returns per-(k, bucket) build
        attribution."""
        return self._warm_impl(tuple(self._shards), buckets, ks=ks,
                               sample=sample)

    def _warm_impl(self, shards, buckets, ks=(10,), sample=None) -> dict:
        """:meth:`warm` over an explicit shard list (:meth:`reshard` warms
        its successors through this before the flip)."""
        from ..neighbors import brute_force
        from ..obs import compile as obs_compile

        out: dict = {}
        gen = torch.Generator().manual_seed(0)
        for kk in sorted(set(int(x) for x in ks)):
            out[kk] = {}
            for b in sorted(set(int(x) for x in buckets)):
                qh = _mut._warm_queries(gen, b, shards[0]._cfg, sample)
                t0 = time.perf_counter()
                with obs_compile.attribution() as rec:
                    parts_d, parts_i = [], []
                    for sh in shards:
                        # every twin of a group warms: failover must never
                        # meet a first call; any twin's parts feed the merge
                        for u in _units(sh):
                            cfg = u._cfg
                            q = _mut._queries(cfg, qh)
                            dt = _mut._np_dtype(cfg.query_dtype)
                            sd = torch.zeros((b, kk), dtype=torch.float32,
                                             device=cfg.device)
                            si = torch.full((b, kk), -1, dtype=torch.int32,
                                            device=cfg.device)
                            dd = di = None
                            for db in u._buckets:
                                dummy = torch.from_numpy(
                                    np.zeros((db, cfg.dim), dt)).to(cfg.device)
                                keep = torch.zeros(db, dtype=torch.bool,
                                                   device=cfg.device)
                                dd, di = brute_force.knn.native(
                                    dummy, q, min(kk, db), cfg.metric,
                                    cfg.metric_arg, sample_filter=keep,
                                    res=cfg.res)
                                di = _mut._map_ids(di, torch.zeros(
                                    db, dtype=torch.int32, device=cfg.device))
                                if dd.shape[1] < kk:
                                    dd, di = _pad_part(dd, di, kk,
                                                       self._select_min)
                            _mut._wait(cfg)
                        parts_d += [sd, dd]
                        parts_i += [si, di]
                    parts_d, parts_i, _ = _gather_parts(
                        parts_d, parts_i, self._merge_device)
                    _merge_parts(parts_d, parts_i, kk, self._select_min)
                    for sh in shards:
                        _mut._wait(sh._cfg)
                out[kk][b] = {"wall_s": round(time.perf_counter() - t0, 3),
                              **rec.summary()}
        return out

    # -- compaction ---------------------------------------------------------
    def _pick_shard(self, mode: str, trigger: str | None = None) -> int:
        """The most-due shard for one staggered fold: a rebuild (or a
        tombstone trip) chases the highest tombstone ratio, an AGE trip the
        stalest non-empty delta (the fullest would starve a quiet shard),
        anything else the fullest delta; ties break low."""
        per = [sh.stats() for sh in self._shards]
        if mode == "rebuild" or trigger == "tombstone_ratio":
            ratios = [p["tombstone_ratio"] for p in per]
            if max(ratios) > 0:
                return int(np.argmax(ratios))
        if trigger == "age":
            ages = [(p["delta_oldest_at"], s) for s, p in enumerate(per)
                    if p["delta_oldest_at"] is not None]
            if ages:
                return min(ages)[1]
        return int(np.argmax([p["delta_rows"] for p in per]))

    def compact(self, mode: str = "auto", shard: int | None = None,
                res=None, trigger: str | None = None,
                ooc_chunk_rows: int | None = None) -> dict:
        """Fold ONE shard (the most due, or ``shard=``) through its own
        fold and swap; the others keep serving their epochs. A Compactor
        forwards its tripped ``trigger`` so the pick chases the right shard.
        Returns the shard's report plus ``shard``, ``shard_epoch`` and the
        aggregate ``epoch``."""
        with self._compact_lock:
            if shard is None:
                shard = self._pick_shard(mode, trigger)
            shard = int(shard)
            expects(0 <= shard < len(self._shards),
                    "shard %d out of range (%d shards)", shard,
                    len(self._shards))
            report = self._shards[shard].compact(
                mode=mode, res=res, ooc_chunk_rows=ooc_chunk_rows)
            report["shard"] = shard
            report["shard_epoch"] = report["epoch"]
            agg = self.stats()
            report["epoch"] = agg["epoch"]  # the aggregate fold count
            self._update_gauges(agg)
            return report

    # -- elastic resharding --------------------------------------------------
    def reshard(self, n_shards: int, *, publisher=None,
                name: str | None = None, ks=(10,), warm_buckets=None,
                warm_data=None, res=None,
                cause: dict | None = None) -> dict:
        """Online power-of-two split / merge to ``n_shards``, as a sequence
        of LOCAL folds: each doubling (halving) folds one donor shard (donor
        pair) at a time into its successor(s) while the donors keep serving
        reads and writes, warms the new topology, carries over the writes
        that landed mid-migration and flips the shard list atomically under
        the write lock. A larger jump runs as successive doublings, each
        committed on its own.

        ``publisher`` (with ``name`` / ``ks`` / ``warm_data``) runs the flip
        through the registry's pre-flip ``publish(warm_hook=)`` seam: the
        registry warms the successor searcher at every bucket, the commit
        runs as the last pre-flip hook, and only then does the registry
        pointer move. Without a publisher, ``warm_buckets`` runs the warm
        (successor delta ladders, sealed scans, the new merge) before the
        flip.

        With ``wal_dir``, each successor gets its baseline snapshot and a
        fresh WAL before the flip, carry-over writes land in the successor
        logs, and the manifest's rename is the commit point: a crash at any
        fault point recovers (:meth:`load`) the OLD topology.

        Returns ``{from, to, steps, rows_moved, epoch, wall_s}``. Raises,
        with the mesh untouched, on a ratio that is not a power of two, a
        successor that would own no rows, or a shard without its retained
        store. ``cause`` rides the ``reshard_*`` events' evidence."""
        target = int(n_shards)
        S = len(self._shards)
        expects(target >= 1, "n_shards must be >= 1, got %d", target)
        expects(target != S, "mesh is already at %d shards", S)
        big, small = max(target, S), min(target, S)
        ratio = big // small
        expects(big % small == 0 and (ratio & (ratio - 1)) == 0,
                "reshard moves between power-of-two-related shard counts "
                "(%d -> %d is not): shard_of routes by h %% S, so only a "
                "doubling/halving keeps every id's migration local to one "
                "donor group", S, target)
        expects(self._build_fn is not None,
                "reshard needs the shard build recipe — construct with "
                "build=, or pass build= to load()")
        expects(publisher is None or hasattr(publisher, "publish"),
                "publisher must expose publish() (SearchService or "
                "IndexRegistry)")
        expects(publisher is None or name is not None,
                "a publisher needs the published name")
        kks = (ks,) if isinstance(ks, int) else tuple(int(x) for x in ks)
        t0 = time.perf_counter()
        steps = []
        while len(self._shards) != target:
            nxt = (len(self._shards) * 2 if target > len(self._shards)
                   else len(self._shards) // 2)
            steps.append(self._reshard_step(
                nxt, publisher=publisher, name=name, ks=kks,
                warm_buckets=warm_buckets, warm_data=warm_data, res=res,
                cause=cause))
        return {"from": S, "to": target, "steps": steps,
                "rows_moved": sum(st["rows_moved"] for st in steps),
                "epoch": self._topology_epoch,
                "wall_s": round(time.perf_counter() - t0, 3)}

    def _snapshot_donor(self, di: int):
        """The fold input of donor ``di`` under a brief write freeze: its
        live rows (sealed survivors, then the live delta prefix), their ids,
        the delta length and the tombstone watermarks at the snapshot."""
        donor = self._shards[di]
        prim = (donor._primary() if isinstance(donor, ReplicatedShard)
                else donor)
        with self._lock:
            st = prim._state
            expects(st.store is not None,
                    "reshard folds raw rows into successor builds — shard "
                    "%d has no retained row store (retain_vectors=False)", di)
            snap_n = int(st.delta_n)
            s_live = np.nonzero(st.sealed_alive)[0]
            d_live = np.nonzero(st.delta_alive[:snap_n])[0]
            rows = np.concatenate([_mut._store_rows(st.store)[s_live],
                                   st.delta[d_live]])
            gids = np.concatenate([st.id_map[s_live],
                                   st.delta_ids[d_live].astype(np.int64)])
            # a delete (or replacing upsert) of a snapshot-live id flips one
            # of these, so the commit skips its dead-id scan when they hold
            dead0 = (int(st.sealed_dead_n), snap_n - len(d_live))
        # the DONOR rides to the commit, not the twin read here: a replicated
        # donor's primary can go stale mid-migration
        return rows, gids, (donor, snap_n, gids, dead0)

    def _reshard_step(self, target: int, *, publisher, name, ks,
                      warm_buckets, warm_data, res, cause=None) -> dict:
        """One doubling / halving: fold donors shard at a time, warm, then
        commit (carry-over, flip, manifest). Holds the compaction lock for
        the whole step; reads and writes block only for the snapshot and
        commit sections."""
        with self._compact_lock:
            S = len(self._shards)
            action = "split" if target > S else "merge"
            if metrics._enabled:
                _c_migrations().inc(1, name=self._name, action=action,
                                    phase="started")
            obs_events.emit(
                "reshard_started",
                subject=("reshard", self._name, None,
                         self._topology_epoch),
                evidence={"action": action, "from": S, "to": target,
                          **({"cause": dict(cause)} if cause else {})})
            t0 = time.perf_counter()
            with self._lock:
                self._migration = {"action": action, "from": S,
                                   "to": target, "folded_donors": 0,
                                   "rows_moved": 0}
            try:
                # split: donor s feeds successors (s, s+S); merge: donors
                # (t, t+T) feed successor t (h % S and h % target agree on
                # exactly these groups)
                donor_groups = ([((s,), (s, s + S)) for s in range(S)]
                                if action == "split"
                                else [((t, t + target), (t,))
                                      for t in range(target)])
                successors: list = [None] * target
                snaps: list = []
                rows_moved = 0
                for donors_idx, succ_idx in donor_groups:
                    faults.fire("reshard/split", name=self._name,
                                donors=donors_idx, action=action)
                    rows_parts, gid_parts = [], []
                    for di in donors_idx:
                        rows, gids, snap = self._snapshot_donor(di)
                        rows_parts.append(rows)
                        gid_parts.append(gids)
                        snaps.append(snap)
                    rows = (np.concatenate(rows_parts)
                            if len(rows_parts) > 1 else rows_parts[0])
                    gids = (np.concatenate(gid_parts)
                            if len(gid_parts) > 1 else gid_parts[0])
                    owner = shard_of(gids, target)
                    for t in succ_idx:
                        mask = owner == t
                        expects(int(mask.sum()) > 0,
                                "successor shard %d of %d would own no "
                                "live rows — the corpus is too small for "
                                "this split", t, target)
                        # the build runs OFF every lock: donors keep serving
                        successors[t] = self._make_shard(
                            rows[mask], gids[mask], t, target)
                    rows_moved += int(len(gids))
                    with self._lock:
                        self._migration["folded_donors"] += len(donors_idx)
                        self._migration["rows_moved"] = rows_moved
                succ = tuple(successors)
                # warm BEFORE the flip: successor delta ladders, pads, the
                # (bucket, 2·target·k) merge
                if warm_buckets:
                    self._warm_impl(succ, warm_buckets, ks=ks,
                                    sample=warm_data)
                step: dict = {"action": action, "from": S, "to": target,
                              "rows_moved": rows_moved}

                if publisher is not None:
                    # the registry's pre-flip seam: its bucket warm runs the
                    # new topology's hook, the commit runs as the last
                    # pre-flip hook, then the registry pointer flips
                    def commit_hook(_searcher, _ks, _step=step):
                        out = self._commit_reshard(succ, snaps, target,
                                                   action, cause=cause)
                        _step.update(out)
                        return out

                    step["publish"] = publisher.publish(
                        name, self._searcher_for(succ), k=ks,
                        warm_data=warm_data, res=res,
                        warm_hook=commit_hook, cause=cause)
                else:
                    if warm_buckets:
                        self._rehearse(succ, warm_buckets, ks, warm_data)
                    step.update(self._commit_reshard(succ, snaps, target,
                                                     action, cause=cause))
                if metrics._enabled:
                    _c_migrations().inc(1, name=self._name, action=action,
                                        phase="completed")
                    _c_rows_moved().inc(rows_moved, name=self._name)
                    _h_reshard().observe(time.perf_counter() - t0,
                                         name=self._name, action=action)
                obs_events.emit(
                    "reshard_committed",
                    subject=("reshard", self._name, None,
                             step.get("epoch")),
                    evidence={"action": action, "rows_moved": rows_moved,
                              "carried_over": step.get("carried_over"),
                              **({"cause": dict(cause)} if cause else {})})
                step["wall_s"] = round(time.perf_counter() - t0, 3)
                return step
            finally:
                with self._lock:
                    self._migration = None

    def _commit_reshard(self, successors, snaps, target: int,
                        action: str, cause: dict | None = None) -> dict:
        """The atomic flip. Before the lock: each successor's baseline
        snapshot and fresh WAL (durability armed). Under the mesh write
        lock: carry over every write that landed on a donor after its fold
        snapshot (deletes first, then the delta tail), swap the shard list
        and commit the manifest (its rename is the durable commit point; no
        write is admitted between the swap and the manifest). After it: the
        donors retire and the old epoch's files are removed."""
        new_epoch = self._topology_epoch + 1
        if self._wal_dir is not None:
            from .wal import WriteAheadLog

            for t, sh in enumerate(successors):
                snap, wal_path = self._shard_files(t, epoch=new_epoch)
                # files of an earlier ABORTED migration at this epoch (never
                # committed by a manifest) must not pass for live state
                if os.path.exists(wal_path):
                    os.remove(wal_path)
                if isinstance(sh, ReplicatedShard):
                    sh.save(snap)
                else:
                    _mut.save(sh, snap)
                sh._wal = WriteAheadLog(wal_path, name=sh.name)
                sh._snapshot_path = snap
        carried = 0
        with self._lock:
            for donor, snap_n, snap_gids, dead0 in snaps:
                # re-pick the twin NOW: a stale twin stopped receiving group
                # writes, while any non-stale twin received every one at the
                # same offsets, so snap_n and the watermarks transfer
                prim = (donor._primary()
                        if isinstance(donor, ReplicatedShard) else donor)
                st = prim._state
                dead_now = (int(st.sealed_dead_n),
                            snap_n
                            - int(np.count_nonzero(st.delta_alive[:snap_n])))
                if dead_now == dead0:
                    # no snapshot-live id died mid-migration: skip the
                    # O(live rows) membership scan under the write lock
                    dead = np.empty(0, np.int64)
                elif len(prim._loc):
                    live_now = np.fromiter(prim._loc.keys(), np.int64,
                                           count=len(prim._loc))
                    dead = np.sort(snap_gids[
                        np.isin(snap_gids, live_now, invert=True)])
                else:
                    dead = np.sort(snap_gids)
                tail = (np.nonzero(st.delta_alive[snap_n:st.delta_n])[0]
                        + snap_n)
                tail_ids = st.delta_ids[tail].astype(np.int64)
                tail_rows = st.delta[tail].copy()
                if dead.size:
                    owner = shard_of(dead, target)
                    for t in np.unique(owner):
                        successors[int(t)].delete(dead[owner == t])
                    carried += int(dead.size)
                if tail_ids.size:
                    owner = shard_of(tail_ids, target)
                    for t in np.unique(owner):
                        m2 = owner == t
                        # an id upserted mid-migration tombstones its
                        # snapshot copy in the successor here (and lands in
                        # the successor WAL, durable before the flip)
                        successors[int(t)].upsert(tail_rows[m2],
                                                  ids=tail_ids[m2])
                    carried += int(tail_ids.size)
            old_shards = self._shards
            self._shards = list(successors)
            self._topology_epoch = new_epoch
            try:
                faults.fire("reshard/flip", name=self._name,
                            epoch=new_epoch)
                if self._wal_dir is not None:
                    faults.fire("reshard/manifest", name=self._name,
                                epoch=new_epoch)
                    self._write_manifest(self._wal_dir)
            except BaseException:
                # a manifest that failed to LAND (a raise, not a crash) must
                # not leave the mesh flipped in memory while the durable
                # manifest names the old topology: roll the swap back (the
                # donors are untouched and keep logging)
                self._shards = old_shards
                self._topology_epoch = new_epoch - 1
                if self._wal_dir is not None:
                    for sh in successors:
                        if sh._wal is not None:
                            sh._wal.close()
                            sh._wal = None
                obs_events.emit(
                    "reshard_aborted", severity="error",
                    subject=("reshard", self._name, None, new_epoch - 1),
                    evidence={"action": action, "rolled_back_to":
                              new_epoch - 1,
                              **({"cause": dict(cause)} if cause else {})})
                raise
            obs_events.emit(
                "reshard_flip",
                subject=("reshard", self._name, None, new_epoch),
                evidence={"action": action, "shards": target,
                          "carried_over": carried})
            self._update_gauges()
        # off the write lock: the manifest is durable and nothing references
        # the donors or the old epoch's files any more
        for sh in old_shards:
            self._retire_shard(sh)
        if self._wal_dir is not None:
            for j in range(len(old_shards)):
                for path in self._shard_files(j, epoch=new_epoch - 1):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        return {"epoch": new_epoch, "carried_over": carried}

    def _retire_shard(self, sh) -> None:
        """Donor retirement: its ledger entries (and tiered stores) retire,
        so the audit shows the migration's double buffer freeing once
        leases drain, and its WAL handles close (the successor logs own
        durability now)."""
        for rep in _units(sh):
            obs_mem.retire(rep._state.mem)
            obs_mem.retire(rep._sealed_mem)
            if isinstance(rep._state.store, TieredStore):
                rep._state.store.retire()
            if rep._wal is not None:
                rep._wal.close()
                rep._wal = None
        if isinstance(sh, ReplicatedShard) and sh._wal is not None:
            sh._wal.close()
            sh._wal = None

    def _rehearse(self, shards, buckets, ks, sample) -> None:
        """The pre-flip warm of the successors' SEALED side when no
        publisher drives the flip: the new topology's scatter-gather at
        every (bucket, k), once per replica ordinal so every twin runs
        before failover can pick it."""
        R = max((sh.n_replicas if isinstance(sh, ReplicatedShard) else 1)
                for sh in shards)
        gen = torch.Generator().manual_seed(7)
        cfg0 = shards[0]._cfg
        for r in range(R):
            states = tuple(
                (sh.replicas[min(r, sh.n_replicas - 1)]._state
                 if isinstance(sh, ReplicatedShard) else sh._state)
                for sh in shards)
            for kk in ks:
                for b in sorted(set(int(x) for x in buckets)):
                    q = _mut._warm_queries(gen, b, cfg0, sample)
                    self._scatter_gather(states, q, int(kk), _view_scan)
        for sh in shards:
            _mut._wait(sh._cfg)

    # -- mesh durability -----------------------------------------------------
    def save(self, dir: str | None = None) -> None:
        """Atomic mesh snapshot: every shard's full mutable state
        (:func:`raft_tpu_torch.stream.save`, atomic, WAL-truncating when
        durability is armed), then the topology manifest written LAST
        through ``core.serialize.atomic_write``. A crash anywhere mid-save
        leaves a loadable set. ``dir`` defaults to (and, with durability
        armed, must be) the construction-time ``wal_dir``."""
        if dir is None:
            dir = self._wal_dir
        expects(dir is not None,
                "save() needs a directory (pass dir= or construct with "
                "wal_dir=)")
        dir = os.fspath(dir)
        if self._wal_dir is not None:
            expects(os.path.abspath(dir) == os.path.abspath(self._wal_dir),
                    "a durable mesh snapshots into its wal_dir (%r) — the "
                    "per-shard WALs truncate against exactly these files; "
                    "got %r", self._wal_dir, dir)
        os.makedirs(dir, exist_ok=True)
        # a reshard committing mid-save would close donor WALs under the
        # per-shard saves and flip the topology before the manifest
        with self._compact_lock:
            for s, sh in enumerate(self._shards):
                snap, _ = self._shard_files(s, dir=dir)
                if isinstance(sh, ReplicatedShard):
                    sh.save(snap)
                else:
                    _mut.save(sh, snap)
            self._write_manifest(dir)

    def _write_manifest(self, dir: str) -> None:
        from ..core.serialize import (atomic_write, serialize_header,
                                      serialize_scalar)

        e = self._topology_epoch
        with atomic_write(os.path.join(dir, _MANIFEST)) as f:
            serialize_header(f, "mesh")
            serialize_scalar(f, self._name)
            serialize_scalar(f, len(self._shards))
            serialize_scalar(f, int(e))
            serialize_scalar(f, int(self._replicas_n))
            serialize_scalar(f, int(self._next_id))
            for s, sh in enumerate(self._shards):
                sn, wn = self._shard_names(s, e)
                serialize_scalar(f, sn)
                serialize_scalar(f, wn if self._wal_dir is not None else "")
                serialize_scalar(f, int(sh._wal_seq))

    @classmethod
    def load(cls, dir, *, build: Callable | None = None,
             search_params=None, index_params=None,
             builder: Callable | None = None,
             devices: Sequence | None = None, comms=None,
             fencing: FencingPolicy | None = None,
             name: str | None = None, tier=None, res=None,
             clock: Callable[[], float] = time.monotonic
             ) -> "ShardedMutableIndex":
        """Recover a mesh (saved by this package or the JAX package) from
        its manifest and per-shard snapshots, each shard's WAL replayed past
        its snapshot's stamp when durability was armed. The manifest decides
        the topology: a crash mid-reshard, before its rename, recovers the
        OLD topology with no acknowledged write lost and none brought back.
        Runtime configuration (``build``, needed only to reshard again,
        ``search_params`` / ``index_params`` / ``builder`` / ``fencing``) is
        supplied fresh. Shards load onto ``devices[s % D]`` (or
        ``comms.devices[s % D]``), or ``res``'s device (``cuda`` by
        default).

        A replicated mesh recovers DEGRADED-TO-ONE (the group snapshot is
        the primary twin's state). ``mesh.last_recovery`` aggregates the
        per-shard replay reports."""
        from ..core.serialize import check_header, deserialize_scalar

        if comms is not None:
            devices = _comms_devices(comms, devices)
        dir = os.fspath(dir)
        if devices is not None:
            devices = [torch.device(dv) for dv in devices]
        with open(os.path.join(dir, _MANIFEST), "rb") as f:
            check_header(f, "mesh")
            saved_name = deserialize_scalar(f)
            n_shards = int(deserialize_scalar(f))
            epoch = int(deserialize_scalar(f))
            saved_replicas = int(deserialize_scalar(f))
            next_id = int(deserialize_scalar(f))
            entries = [(deserialize_scalar(f), deserialize_scalar(f),
                        int(deserialize_scalar(f)))
                       for _ in range(n_shards)]
        obj = cls.__new__(cls)
        obj._name = saved_name if name is None else name
        obj._clock = clock
        obj._lock = threading.RLock()
        obj._compact_lock = threading.Lock()
        obj._build_fn = build
        obj._search_params = search_params
        obj._index_params = index_params
        obj._builder = builder
        obj._retain_vectors = None
        obj._devices = devices
        obj._replicas_n = 1  # degraded-to-one restore (see docstring)
        obj._fencing = fencing
        obj._topology_epoch = epoch
        obj._migration = None
        has_wal = any(wname for _, wname, _ in entries)
        obj._wal_dir = dir if has_wal else None
        shards = []
        for j, (sname, wname, _seq) in enumerate(entries):
            shards.append(_mut.load(
                os.path.join(dir, sname),
                wal=os.path.join(dir, wname) if wname else None,
                search_params=search_params, index_params=index_params,
                builder=builder, shard=j, tier=tier, res=res,
                device=(devices[j % len(devices)] if devices else None),
                clock=clock))
        obj._shards = shards
        # the per-shard stream sections carry the tier layout
        obj._storage = shards[0]._storage
        obj._tier = tier
        obj._delta_capacity = shards[0].delta_capacity
        obj._next_id = max([next_id] + [sh._next_id for sh in shards])
        obj._finish_init()
        per = [getattr(sh, "last_recovery", None) for sh in shards]
        obj.last_recovery = {
            "n_shards": n_shards, "topology_epoch": epoch,
            "replayed": sum(p["replayed"] for p in per if p),
            "torn": any(p["torn"] for p in per if p),
            "degraded_from_replicas": saved_replicas,
            "per_shard": per,
        }
        return obj
