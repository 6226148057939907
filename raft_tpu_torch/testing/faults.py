"""Deterministic fault injection for the durability paths.

The port's own copy of raft_tpu/testing/faults.py. A WAL write that fails
partway through a batch, a process that dies between the WAL append and the
memtable insert, a crash in the middle of a snapshot write: none can be
provoked on demand, and tests that kill processes or sleep past deadlines
are slow and flaky. So the production code paths carry **named fault
points** (one module-flag read each while nothing is armed), which tests
arm explicitly::

    from raft_tpu_torch.testing import faults

    with faults.scope():                      # disarms everything on exit
        faults.inject("wal/append", exc=faults.FaultError("disk full"),
                      after=2)                # the third record fails
        ...
        assert faults.fired("wal/append") == 1

Fault points in the port (grep ``faults.fire`` for the live list):

- ``wal/append`` — fired per record before it is written
  (:meth:`raft_tpu_torch.stream.wal.WriteAheadLog.append_upsert` /
  ``append_delete``); arm with ``after=k`` to fail the k-th record.
- ``wal/fsync`` — fired before each batched fsync.
- ``stream/post-wal`` — fired between the WAL append and the memtable
  insert in ``MutableIndex.upsert`` / ``delete``: the crash window the
  replay path must cover (arm with :class:`SimulatedCrash`).
- ``serialize/atomic-write`` — fired between writing the temporary file and
  the ``os.replace`` in :func:`raft_tpu_torch.core.serialize.atomic_write`:
  a crash here must leave the previous snapshot readable.

- ``tier/fetch`` — fired before a tiered store's gather
  (``stream/tiered.py``).
- ``replica/search`` — fired per scan attempt of a replica group
  (:class:`raft_tpu_torch.stream.ReplicatedShard`); a callback that
  advances an injected clock simulates a wedged twin. ``replica/upsert`` /
  ``replica/delete`` — fired per twin write.
- ``reshard/split`` (per donor group, as its fold starts), ``reshard/flip``
  (after the carry-over, before the manifest) and ``reshard/manifest``
  (before the manifest's write) in
  :meth:`raft_tpu_torch.stream.ShardedMutableIndex.reshard`: a crash at any
  of them recovers the old topology.

Every helper is thread-safe; ``fire`` holds no lock while nothing is armed.
Injected exceptions should derive from :class:`FaultError` (the registry
raises whatever it was given).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable

from ..core.errors import RaftError, expects

__all__ = ["FaultError", "SimulatedCrash", "inject", "clear", "fire",
           "fired", "armed", "scope"]


class FaultError(RaftError):
    """Base type for injected failures (so a test can catch exactly the
    injected class and nothing else)."""


class SimulatedCrash(FaultError):
    """An injected process death: the code path stops here, mid-operation,
    and recovery is proven by reopening the on-disk state (the in-memory
    object is considered gone). A :class:`FaultError`, not a
    ``BaseException``, so a leaked one fails a test instead of killing the
    runner."""


class _Fault:
    __slots__ = ("exc", "callback", "times", "after", "match", "fired",
                 "skipped")

    def __init__(self, exc, callback, times, after, match):
        self.exc = exc
        self.callback = callback
        self.times = times        # None = every call once armed
        self.after = int(after)   # skip this many matching calls first
        self.match = match
        self.fired = 0
        self.skipped = 0


_lock = threading.Lock()
_points: dict[str, list[_Fault]] = {}
_counts: dict[str, int] = {}
_armed = False  # fire() reads only this while nothing is armed


def inject(point: str, exc: BaseException | None = None, *,
           callback: Callable[[dict], None] | None = None,
           times: int | None = None, after: int = 0,
           match: Callable[[dict], bool] | None = None) -> None:
    """Arm fault ``point``. ``exc`` is raised at each triggering call (or
    ``callback(ctx)`` runs; it may raise itself or change state, such as
    advancing an injected clock). ``times`` bounds how many calls trigger
    (None = every one), ``after`` skips the first N matching calls,
    ``match(ctx)`` restricts the fault to matching contexts. Several
    injections on one point stack in arming order."""
    global _armed
    expects(exc is not None or callback is not None,
            "inject(%r) needs exc= or callback=", point)
    with _lock:
        _points.setdefault(point, []).append(
            _Fault(exc, callback, times, after, match))
        _armed = True


def clear(point: str | None = None) -> None:
    """Disarm one point (or everything); its fired counts reset with it."""
    global _armed
    with _lock:
        if point is None:
            _points.clear()
            _counts.clear()
        else:
            _points.pop(point, None)
            _counts.pop(point, None)
        _armed = bool(_points)


def fire(point: str, **ctx) -> None:
    """Production-side hook: trigger any armed faults at ``point``. One
    module-flag read while nothing is armed anywhere."""
    if not _armed:
        return
    with _lock:
        flist = _points.get(point)
        if not flist:
            return
        _counts[point] = _counts.get(point, 0) + 1
        todo = []
        for f in flist:
            if f.match is not None and not f.match(ctx):
                continue
            if f.skipped < f.after:
                f.skipped += 1
                continue
            if f.times is not None and f.fired >= f.times:
                continue
            f.fired += 1
            todo.append(f)
    # actions run outside the lock: a callback may reach code that fires
    # other points (or re-enters inject / clear)
    for f in todo:
        if f.callback is not None:
            f.callback(dict(ctx, point=point))
        if f.exc is not None:
            raise f.exc


def fired(point: str) -> int:
    """How many times the faults armed at ``point`` actually triggered."""
    with _lock:
        return sum(f.fired for f in _points.get(point, ()))


def armed(point: str | None = None) -> bool:
    with _lock:
        return bool(_points if point is None else _points.get(point))


@contextmanager
def scope():
    """Context manager for tests: everything injected inside is disarmed on
    exit, pass or fail, so a leaked fault never reaches the next test."""
    try:
        yield
    finally:
        clear()
