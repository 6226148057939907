"""Zero-dependency metrics registry: counters, gauges, histograms with labels.

The port's own copy of raft_tpu/obs/metrics.py, with the same metric names
(``raft_tpu_serve_*``, ``raft_tpu_mem_*``, ...) so the two packages'
catalogues compare one to one. The reference exposes its runtime signals
through spdlog levels and the benchmark harness's structured result files
(benchmark.hpp:111-200); a served system needs the same numbers scrapeable
from the process: stdlib-only, thread-safe, Prometheus-text exportable, and
JSON-flattenable for benchmark records.

Semantics worth knowing:

- **Disabled mode** (:func:`disable`) is a single module-attribute check on
  every hot-path touch point — instrumented entry points fall straight
  through to the wrapped function and metric mutators return immediately.
- **Labels** are free-form str->str (ints/floats are stringified). Series are
  keyed by the sorted label set, so ``inc(op="a", k="5")`` and
  ``inc(k="5", op="a")`` hit the same series.
- **Histograms** use fixed cumulative buckets (Prometheus convention); the
  default bucket ladder spans 100 us .. 60 s, sized for call latencies.
  Metrics whose values live on [0, 1] — recall, ratios, fractions — pass
  ``buckets=RATIO_BUCKETS`` instead (a latency ladder would dump every
  observation into the first two buckets and :func:`quantile` would report
  garbage). Re-registering a histogram under a different bucket ladder
  raises: the first registration would otherwise silently win and the
  later call site would read quantiles against buckets it never asked for.
  :func:`quantile` interpolates within the owning bucket.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Iterable

__all__ = [
    "Registry", "counter", "gauge", "histogram", "snapshot", "to_prometheus",
    "to_json", "delta", "quantile", "reset", "enable", "disable", "enabled",
    "DEFAULT_BUCKETS", "RATIO_BUCKETS",
]

# Latency ladder: 100 us .. 60 s (a kernel launch to a cold 1M build).
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# [0, 1] ladder for recall/ratio/fraction metrics: dense near 1.0, where
# recall lives (the gap between 0.95 and 0.99 is the whole quality story).
RATIO_BUCKETS = (
    0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0,
)

_enabled = True


def enable() -> None:
    """Turn metric recording on (the default)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn all metric recording off. Instrumented entry points reduce to a
    single module-flag check; mutators become no-ops."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """One named metric holding many labeled series.

    Series state: float for counter/gauge; ``[count, sum, bucket_counts]``
    for histogram (bucket_counts is per-bucket, NON-cumulative internally;
    export cumulates, as the Prometheus text format requires).
    """

    def __init__(self, name: str, kind: str, help: str, unit: str,
                 buckets: tuple, lock: threading.RLock):
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.buckets = buckets
        self._lock = lock
        self._series: dict[tuple, object] = {}

    # -- mutators -----------------------------------------------------------
    def inc(self, value: float = 1.0, **labels) -> None:
        if not _enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def set(self, value: float, **labels) -> None:
        if not _enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = float(value)

    def observe(self, value: float, **labels) -> None:
        if not _enabled:
            return
        key = _label_key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = [0, 0.0, [0] * (len(self.buckets) + 1)]
                self._series[key] = st
            st[0] += 1
            st[1] += value
            # first bucket whose upper bound holds the value; last slot = +Inf
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    st[2][i] += 1
                    break
            else:
                st[2][len(self.buckets)] += 1

    # -- accessors ----------------------------------------------------------
    def series(self) -> dict[tuple, object]:
        with self._lock:
            return {k: (list(v) if isinstance(v, list) else v)
                    for k, v in self._series.items()}

    def quantile(self, q: float, /, **labels) -> float:
        """Histogram quantile estimate by linear interpolation inside the
        owning bucket (Inf bucket reports the last finite bound). ``q`` is
        positional-only so a series labeled ``q=...`` stays addressable."""
        assert self.kind == "histogram", "quantile() is histogram-only"
        key = _label_key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None or st[0] == 0:
                return math.nan
            count, _, per_bucket = st[0], st[1], list(st[2])
        rank = q * count
        cum = 0.0
        lo = 0.0
        for i, n in enumerate(per_bucket):
            ub = self.buckets[i] if i < len(self.buckets) else math.inf
            if cum + n >= rank and n > 0:
                if math.isinf(ub):
                    return self.buckets[-1]
                frac = (rank - cum) / n
                return lo + (ub - lo) * min(max(frac, 0.0), 1.0)
            cum += n
            lo = ub
        return self.buckets[-1]


class Registry:
    """Thread-safe named-metric registry (get-or-create semantics)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, Metric] = {}

    def _get(self, name: str, kind: str, help: str, unit: str,
             buckets: tuple) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Metric(name, kind, help, unit, buckets, self._lock)
                self._metrics[name] = m
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            elif kind == "histogram" and m.buckets != buckets:
                # first-registration-wins would silently hand the later call
                # site quantiles over a bucket ladder it never asked for
                # (e.g. a recall metric read against the latency ladder)
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{m.buckets}, requested {buckets}")
            return m

    def counter(self, name: str, help: str = "", unit: str = "") -> Metric:
        return self._get(name, "counter", help, unit, ())

    def gauge(self, name: str, help: str = "", unit: str = "") -> Metric:
        return self._get(name, "gauge", help, unit, ())

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Metric:
        return self._get(name, "histogram", help, unit, tuple(buckets))

    def reset(self) -> None:
        """Clear all series (metric definitions survive)."""
        with self._lock:
            for m in self._metrics.values():
                m._series.clear()

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """Nested dict of everything: {name: {type, help, unit, series: [
        {labels, value} | {labels, count, sum, buckets}]}} — buckets are
        cumulative keyed by upper bound (str), Prometheus-style."""
        out = {}
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                series = []
                for key in sorted(m._series):
                    labels = dict(key)
                    st = m._series[key]
                    if m.kind == "histogram":
                        cum, bk = 0, {}
                        for i, n in enumerate(st[2]):
                            cum += n
                            ub = (m.buckets[i] if i < len(m.buckets)
                                  else math.inf)
                            bk[_fmt_le(ub)] = cum
                        series.append({"labels": labels, "count": st[0],
                                       "sum": st[1], "buckets": bk})
                    else:
                        series.append({"labels": labels, "value": st})
                out[name] = {"type": m.kind, "help": m.help, "unit": m.unit,
                             "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one HELP/TYPE block per metric,
        histogram expands to _bucket/_sum/_count samples)."""
        lines = []
        for name, meta in self.snapshot().items():
            if meta["help"]:
                lines.append(f"# HELP {name} {meta['help']}")
            lines.append(f"# TYPE {name} {meta['type']}")
            for s in meta["series"]:
                if meta["type"] == "histogram":
                    for le, cum in s["buckets"].items():
                        lines.append(_sample(f"{name}_bucket",
                                             {**s["labels"], "le": le}, cum))
                    lines.append(_sample(f"{name}_sum", s["labels"], s["sum"]))
                    lines.append(_sample(f"{name}_count", s["labels"],
                                         s["count"]))
                else:
                    lines.append(_sample(name, s["labels"], s["value"]))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        """Flat {'name{l1="v1",...}': number} view — subtractable, and small
        enough to ride inside a benchmark record. Histograms flatten to _sum/_count
        plus one ``_bucket`` key per cumulative bucket with the series'
        OWN labels preserved alongside ``le`` — so a benchmark record carries
        the full per-bucket distribution (the canary's per-bucket recall
        histogram) without collapsing label sets, and :func:`delta`
        subtracts bucket counts like any other monotone series."""
        out = {}
        for name, meta in self.snapshot().items():
            for s in meta["series"]:
                lbl = _label_str(s["labels"])
                if meta["type"] == "histogram":
                    out[f"{name}_sum{lbl}"] = s["sum"]
                    out[f"{name}_count{lbl}"] = s["count"]
                    for le, cum in s["buckets"].items():
                        blbl = _label_str({**s["labels"], "le": le})
                        out[f"{name}_bucket{blbl}"] = cum
                else:
                    out[f"{name}{lbl}"] = s["value"]
        return out


def _fmt_le(ub: float) -> str:
    if math.isinf(ub):
        return "+Inf"
    return repr(ub)


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _sample(name: str, labels: dict, value) -> str:
    # NaN/±Inf are legal sample values in the exposition format; int(value)
    # on them raises, so only finite integral floats collapse to ints
    if (isinstance(value, float) and math.isfinite(value)
            and value == int(value) and abs(value) < 1e15):
        value = int(value)
    return f"{name}{_label_str(labels)} {value}"


def delta(before: dict, after: dict) -> dict:
    """Difference of two :func:`to_json` snapshots (new/changed numeric keys
    only) — the per-row attribution a benchmark attaches to its records."""
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


# -- default registry + module-level veneer ---------------------------------

_default = Registry()


def default_registry() -> Registry:
    return _default


def counter(name: str, help: str = "", unit: str = "") -> Metric:
    return _default.counter(name, help, unit)


def gauge(name: str, help: str = "", unit: str = "") -> Metric:
    return _default.gauge(name, help, unit)


def histogram(name: str, help: str = "", unit: str = "",
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Metric:
    return _default.histogram(name, help, unit, buckets)


def snapshot() -> dict:
    return _default.snapshot()


def to_prometheus() -> str:
    return _default.to_prometheus()


def to_json() -> dict:
    return _default.to_json()


def quantile(name: str, q: float, /, **labels) -> float:
    # positional-only: the serve/stream/quality series all carry a `name`
    # label, which must not collide with the metric-name parameter
    return _default._metrics[name].quantile(q, **labels)


def reset() -> None:
    _default.reset()


def dumps() -> str:
    """snapshot() as a JSON string (debug convenience)."""
    return json.dumps(snapshot(), default=float)
