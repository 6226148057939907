"""Build attribution: which kernel builds a region of caller code paid for.

Counterpart of raft_tpu/obs/compile.py. There the compiles are XLA programs
and jax's monitoring bus reports them; on the port the only compile is a
kernel build in :mod:`raft_tpu_torch.ops._build`, which runs nvcc for a
source (a cache miss) or loads the cached ``.so`` (a cache hit). ``_build``
reports each of them here through :func:`record_build`, and the events fan
into two sinks:

- the default metrics registry (``raft_tpu_compile_seconds{stage="compile"}``
  per nvcc run, ``raft_tpu_compile_cache_total{outcome=hit|miss}``), while
  metrics are enabled;
- any active :func:`attribution` scopes, which accumulate a
  :class:`CompileRecord` for one region (the serve registry's warm ladder
  reports one per bucket, so a publish against built kernels reports zero
  builds).

A first-call cost that is not a build (cuBLAS handle creation, the caching
allocator's first blocks) is recorded nowhere here. The port uses no
``torch.compile``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

from . import metrics

__all__ = ["attribution", "CompileRecord", "record_build"]

_lock = threading.Lock()
_scopes: list["CompileRecord"] = []


@dataclasses.dataclass(eq=False)
class CompileRecord:
    """What happened, build-wise, inside one ``attribution()`` scope:
    ``cache_misses`` nvcc runs (``programs``, their seconds in
    ``program_compile_s`` and ``compile_s``, their sources in ``built``)
    and ``cache_hits`` cached libraries loaded. ``eq=False``: records are
    removed from ``_scopes`` by identity."""

    compile_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    program_compile_s: list = dataclasses.field(default_factory=list)
    built: list = dataclasses.field(default_factory=list)

    @property
    def programs(self) -> int:
        return len(self.program_compile_s)

    def summary(self) -> dict:
        """The JAX record's summary keys; a kernel build has no trace
        stage, so ``trace_s`` is 0."""
        return {
            "compile_s": round(self.compile_s, 3),
            "trace_s": 0.0,
            "programs": self.programs,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
        }


def record_build(name: str, seconds: float, cached: bool) -> None:
    """Report one kernel library made ready: ``cached`` when its ``.so``
    was loaded from the build cache, else an nvcc run of ``seconds``."""
    if metrics.enabled():
        metrics.counter(
            "raft_tpu_compile_cache_total",
            "kernel build cache outcomes (hit: a cached .so loaded; "
            "miss: an nvcc run)").inc(1, outcome="hit" if cached else "miss")
        if not cached:
            metrics.histogram(
                "raft_tpu_compile_seconds",
                "kernel build time by stage (compile: one nvcc run)",
                unit="seconds").observe(seconds, stage="compile")
    with _lock:
        scopes = list(_scopes)
    for rec in scopes:
        if cached:
            rec.cache_hits += 1
        else:
            rec.cache_misses += 1
            rec.compile_s += seconds
            rec.program_compile_s.append(seconds)
            rec.built.append(name)


@contextlib.contextmanager
def attribution():
    """Collect kernel builds for the enclosed region.

    >>> with attribution() as rec:
    ...     ivf_pq.search(params, index, q, 10)
    >>> rec.programs, rec.compile_s, rec.cache_hits

    Scopes nest (each sees every build reported while it is open, from any
    thread: a build may run on a serve flush worker)."""
    rec = CompileRecord()
    with _lock:
        _scopes.append(rec)
    try:
        yield rec
    finally:
        with _lock:
            _scopes.remove(rec)
