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

Not yet ported: ``ShardedMutableIndex`` / ``shard_of`` (``sharded.py``) and
``ReplicatedShard`` / ``FencingPolicy`` (``replicated.py``), which wait for
``comms/``, and with them the sharded and replicated tiered stores.
"""

from . import compactor, mutable, tiered, wal
from .compactor import CompactionPolicy, Compactor
from .mutable import (DELTA_MIN_BUCKET, DeltaFullError, MutableIndex,
                      delta_buckets, load, save)
from .tiered import TieredStore, TierPolicy
from .wal import WalCorruptError, WriteAheadLog

__all__ = [
    "mutable", "compactor", "wal", "tiered", "TieredStore", "TierPolicy",
    "MutableIndex", "DeltaFullError", "DELTA_MIN_BUCKET", "delta_buckets",
    "WriteAheadLog", "WalCorruptError",
    "Compactor", "CompactionPolicy",
    "save", "load",
]
