"""raft_tpu_torch.obs — the observability surface the serving layer reads.

Counterpart of raft_tpu/obs, holding what is ported:

- :mod:`.metrics` — zero-dependency counters/gauges/histograms with labels;
  ``snapshot()``, ``to_prometheus()``, ``to_json()``, under the JAX
  package's metric names.
- :mod:`.compile` — build attribution: which kernel builds (nvcc runs or
  cached-library loads) a region paid for.
- :mod:`.dispatch` — per-flush dispatch counting at the serve sites.
- :mod:`.requestlog` — request ids minted at admission and span timings
  through batcher → flush → lease → index search.
- :mod:`.mem` — the memory ledger, its retirement audit and the
  ``Resources.memory_budget_bytes`` admission gate.
- :mod:`.events` — the process-wide operations event journal.

Not yet ported: ``instrument`` (the entry-point decorator), ``quality``,
``slo``, ``build`` and ``http`` (which needs ``net/``). Trace annotation
lives in :mod:`raft_tpu_torch.core.tracing`.
"""

from . import compile  # noqa: A004 - submodule named like the builtin
from . import dispatch
from . import events
from . import mem
from . import metrics
from . import requestlog
from .compile import CompileRecord, attribution
from .events import EventJournal
from .metrics import (DEFAULT_BUCKETS, RATIO_BUCKETS, Registry, counter,
                      delta, disable, enable, enabled, gauge, histogram,
                      quantile, reset, snapshot, to_json, to_prometheus)
from .requestlog import RequestLog

__all__ = [
    "metrics", "compile", "dispatch", "attribution", "CompileRecord",
    "Registry", "DEFAULT_BUCKETS", "RATIO_BUCKETS", "counter", "gauge",
    "histogram", "snapshot", "to_prometheus", "to_json", "delta", "quantile",
    "reset", "enable", "disable", "enabled", "requestlog", "mem",
    "RequestLog", "events", "EventJournal",
]
