"""raft_tpu_torch.serve — the online serving layer.

Counterpart of raft_tpu/serve, with its exports:

- :mod:`.batcher` — dynamic micro-batching of concurrent callers into a
  small fixed set of padded power-of-two batch shapes, flushing on
  batch-full or a ``max_wait_us`` deadline;
- :mod:`.registry` — versioned index registry with warm, atomic hot-swap:
  ``publish`` runs the new index at every serving bucket BEFORE the flip,
  in-flight requests drain on the old version, retired versions drop their
  tensors;
- :mod:`.service` — :class:`SearchService`: admission control (bounded
  queue with fast-fail :class:`OverloadedError`), per-request deadlines,
  clean shutdown/drain, and the pipelined flush (results copied to pinned
  host memory on the card's stream, waited on by a completion thread);
- :mod:`.staging` — per-bucket pinned host buffers and device slots;
- :mod:`.errors` — the fast-fail vocabulary; :mod:`.retry` — the client's
  bounded retry.

Metrics ride :mod:`raft_tpu_torch.obs` under the JAX package's names
(``raft_tpu_serve_*``); flushes are annotated ``serve/flush/<bucket>`` by
:mod:`raft_tpu_torch.core.tracing` when tracing is enabled.
"""

from . import batcher, errors, registry, retry, service, staging
from .batcher import MicroBatcher, PendingFlush, bucket_for, bucket_sizes
from .errors import (DeadlineExceededError, MemoryBudgetError,
                     OverloadedError, ReplicaUnavailableError, ServeError,
                     ServiceClosedError)
from .registry import IndexRegistry, make_searcher
from .retry import submit_with_retry
from .service import SearchService
from .staging import StagingBuffers, warm_staging

__all__ = [
    "batcher", "registry", "service", "errors", "retry", "staging",
    "MicroBatcher", "PendingFlush", "bucket_sizes", "bucket_for",
    "IndexRegistry", "make_searcher", "SearchService",
    "submit_with_retry", "StagingBuffers", "warm_staging",
    "ServeError", "OverloadedError", "DeadlineExceededError",
    "ServiceClosedError", "MemoryBudgetError", "ReplicaUnavailableError",
]
