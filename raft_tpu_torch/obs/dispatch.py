"""Per-flush device-dispatch counting for the serve hot path.

The port's own copy of raft_tpu/obs/dispatch.py. A meter of how many
device interactions (searcher calls and host→device transfers at the
instrumented serve sites) one flush performs: a thread-local counter the
serve flush opens around the searcher call (:func:`count`), with the
staging upload calling :func:`note` as it dispatches. The batcher
publishes the total per flush as ``raft_tpu_serve_dispatches_per_flush``.

This counts INSTRUMENTED DISPATCH SITES, not kernel launches: a single
``ivf_pq.search`` call is one site even though it launches many kernels.
Cost discipline matches :mod:`raft_tpu_torch.obs.requestlog`: one
thread-local ``getattr`` per site when no counter is open.
"""

from __future__ import annotations

import threading

__all__ = ["count", "note"]

_tls = threading.local()


class count:
    """Context manager opening a dispatch counter on the current thread;
    read ``.total`` after exit. Reentrant-safe (inner scopes shadow, their
    counts roll up into the outer scope on exit so a nested open never
    loses dispatches)."""

    total: int

    def __enter__(self) -> "count":
        self.total = 0
        self._prev = getattr(_tls, "counter", None)
        _tls.counter = self
        return self

    def __exit__(self, *exc) -> None:
        _tls.counter = self._prev
        if self._prev is not None:
            self._prev.total += self.total


def note(n: int = 1) -> None:
    """Record ``n`` dispatches against the active counter (no-op without
    one — instrumented sites pay one getattr when no flush is counting)."""
    c = getattr(_tls, "counter", None)
    if c is not None:
        c.total += n
