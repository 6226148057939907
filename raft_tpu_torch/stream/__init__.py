"""raft_tpu_torch.stream — the mutable index lifecycle (delta memtable,
tombstones, write-ahead log, background compaction with a warm hot-swap).

Counterpart of raft_tpu/stream, with the names that are ported:

- :class:`MutableIndex` — wraps a sealed brute-force, IVF-Flat, IVF-PQ or
  CAGRA index: upserts land in a fixed-capacity delta memtable scanned by
  exact brute force at power-of-two bucket shapes, deletes flip tombstone
  bits applied through ``sample_filter=`` on the sealed side, and
  ``search()`` merges both. A write is visible to the next search.
- :class:`Compactor` / :class:`CompactionPolicy` — watermark-triggered
  folds (``extend`` for the IVF kinds, a rebuild to reclaim tombstones),
  swapped in and republished through :class:`raft_tpu_torch.serve.
  IndexRegistry` / ``SearchService``.
- :func:`save` / :func:`load` — the full mutable state as the JAX
  package's ``stream`` file section, atomic, stamped with the WAL sequence
  it covers; ``load(wal=)`` replays the acknowledged writes past it.
- :class:`~.wal.WriteAheadLog` — the append-only checksummed log of every
  write, in the JAX package's record format.
- :class:`TieredStore` / :class:`TierPolicy` — beyond-HBM storage of the
  refine rows (host RAM, an mmap file or an adopted memmap, a device mirror
  placed by the budget), behind ``MutableIndex(storage="tiered")``.
- :class:`ReplicatedShard` / :class:`FencingPolicy` — R MutableIndex twins
  behind one surface: writes in lockstep with whole-or-nothing admission,
  reads on one twin picked by health and latency with same-call failover,
  a strike breaker with doubling-backoff re-probes.
- :class:`ShardedMutableIndex` / :func:`shard_of` — the lifecycle across S
  hash-routed shards: one top-k merge over every shard's sealed and delta
  candidates, one shard folded a Compactor cycle, ``replicas=R`` groups,
  ``storage="tiered"`` shards, online power-of-two ``reshard``, and mesh
  durability (a WAL per shard group, atomic snapshots, the topology
  manifest) in the JAX package's files. On one card every shard runs on
  the same device; ``devices=`` or ``comms=`` (a communicator of one
  rank) pins shard ``s`` to a device.
"""

from . import compactor, mutable, replicated, sharded, tiered, wal
from .compactor import CompactionPolicy, Compactor
from .mutable import (DELTA_MIN_BUCKET, DeltaFullError, MutableIndex,
                      delta_buckets, load, save)
from .replicated import FencingPolicy, ReplicatedShard
from .sharded import ShardedMutableIndex, shard_of
from .tiered import TieredStore, TierPolicy
from .wal import WalCorruptError, WriteAheadLog

__all__ = [
    "mutable", "compactor", "sharded", "replicated", "wal", "tiered",
    "TieredStore", "TierPolicy",
    "MutableIndex", "DeltaFullError", "DELTA_MIN_BUCKET", "delta_buckets",
    "ShardedMutableIndex", "shard_of",
    "ReplicatedShard", "FencingPolicy",
    "WriteAheadLog", "WalCorruptError",
    "Compactor", "CompactionPolicy",
    "save", "load",
]
