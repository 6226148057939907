"""Entry-point instrumentation: per-call latency, volume and build share.

Counterpart of raft_tpu/obs/instrument.py. ``@instrument("ivf_pq.search",
...)`` wraps a public entry point with three metrics, under the JAX
package's names:

- ``raft_tpu_call_seconds{op=...}``         histogram, host wall time a call
- ``raft_tpu_call_compile_seconds{op=...}`` histogram, the nvcc seconds the
  call paid for (:func:`raft_tpu_torch.obs.compile.attribution`; 0 once
  the kernels are built)
- ``raft_tpu_items_total{op=...}``          counter, rows or queries

Wall time is host time through dispatch: PyTorch queues CUDA work and
returns, so a call whose results are not yet read records its launch cost,
not device time.

Under ``obs.disable()`` the wrapper is one module-flag check and a tail
call.
"""

from __future__ import annotations

import functools
import time

from . import compile as _compile
from . import metrics

__all__ = ["instrument", "nrows", "dtype_of"]


def _call_seconds():
    return metrics.histogram(
        "raft_tpu_call_seconds",
        "host wall time of instrumented raft_tpu entry points",
        unit="seconds")


def _call_compile_seconds():
    return metrics.histogram(
        "raft_tpu_call_compile_seconds",
        "kernel build (nvcc) seconds attributed to instrumented calls "
        "(call_seconds minus this is execute/dispatch time)",
        unit="seconds")


def _items_total():
    return metrics.counter(
        "raft_tpu_items_total",
        "rows/queries processed by instrumented entry points")


def instrument(op: str, items=None, labels=None):
    """Decorator factory. ``items(args, kwargs) -> int`` counts rows or
    queries; ``labels(args, kwargs) -> dict`` adds low-cardinality labels
    to the latency series. A raising hook drops its labels or count, never
    the call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not metrics._enabled:
                return fn(*args, **kwargs)
            with _compile.attribution() as rec:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                dt = time.perf_counter() - t0
            try:
                lbls = labels(args, kwargs) if labels is not None else {}
            except Exception:
                lbls = {}
            _call_seconds().observe(dt, op=op, **lbls)
            _call_compile_seconds().observe(rec.compile_s, op=op, **lbls)
            if items is not None:
                try:
                    _items_total().inc(int(items(args, kwargs)), op=op)
                except Exception:
                    pass
            return out

        return wrapper

    return deco


def nrows(x) -> int:
    """Row count of an array-like (the per-site ``items`` hooks)."""
    shape = getattr(x, "shape", None)
    if shape is not None:
        return int(shape[0]) if len(shape) else 1
    return len(x)


def dtype_of(x) -> str:
    """The dtype's name as numpy and JAX spell it (``"float32"``, not
    ``"torch.float32"``)."""
    return str(getattr(x, "dtype", type(x).__name__)).split(".")[-1]
