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
- :mod:`.mem` — the memory ledger, its retirement audit, the
  ``Resources.memory_budget_bytes`` admission gate and its pressure relief.
- :mod:`.events` — the process-wide operations event journal and its flight
  recorder.
- :mod:`.quality` — the live recall canary (:class:`RecallCanary`, a Wilson
  interval over shadow-reranked samples) and family drift detection
  (:class:`DriftDetector`).
- :mod:`.slo` — availability / latency / quality objectives with
  multi-window burn rates and a healthz verdict (:class:`SLOTracker`).
- :mod:`.build` — the ``raft_tpu_build_*`` metrics of the streamed builds.
- :mod:`.instrument` — the entry-point decorator: per-call latency, items
  and build seconds.
- :mod:`.http` — the opt-in stdlib endpoint routing ``/metrics``,
  ``/healthz``, ``/debug/requests``, ``/debug/mem``, ``/debug/events`` and
  ``/debug/control`` (404 elsewhere): :func:`start_http_exporter`,
  :class:`MetricsExporter`.

Trace annotation lives in :mod:`raft_tpu_torch.core.tracing`.
"""

from . import build
from . import compile  # noqa: A004 - submodule named like the builtin
from . import dispatch
from . import events
from . import http
from . import mem
from . import metrics
from . import quality
from . import requestlog
from . import slo
from .compile import CompileRecord, attribution
from .events import EventJournal
from .http import MetricsExporter, start_http_exporter, stop_http_exporter
from .instrument import instrument
from .metrics import (DEFAULT_BUCKETS, RATIO_BUCKETS, Registry, counter,
                      delta, disable, enable, enabled, gauge, histogram,
                      quantile, reset, snapshot, to_json, to_prometheus)
from .quality import DriftDetector, RecallCanary, exact_oracle, wilson_interval
from .requestlog import RequestLog
from .slo import SLOPolicy, SLOTracker

__all__ = [
    "metrics", "compile", "dispatch", "http", "attribution", "CompileRecord",
    "MetricsExporter", "start_http_exporter", "stop_http_exporter",
    "Registry", "DEFAULT_BUCKETS", "RATIO_BUCKETS", "counter", "gauge",
    "histogram", "snapshot", "to_prometheus", "to_json", "delta", "quantile",
    "reset", "enable", "disable", "enabled", "requestlog", "mem",
    "RequestLog", "events", "EventJournal", "build", "instrument",
    "quality", "slo", "RecallCanary", "DriftDetector", "exact_oracle",
    "wilson_interval", "SLOPolicy", "SLOTracker",
]
