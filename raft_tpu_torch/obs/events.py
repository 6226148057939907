"""The unified operations event plane: one causally-ordered journal.

The port's own copy of raft_tpu/obs/events.py, with the same kind
catalogue (:data:`KINDS`), so a journal of the port and one of the JAX
package read alike.

Every advisory and state transition the serving stack produces — drift
``retune_advised``, compactor ``reshard_advised`` and fold lifecycle, mem
budget refusals and pressure relief, tier promote/spill, replica
fence/unfence/probe/failover/stale, reshard split/flip/commit/abort, WAL
truncate/recovery, registry publish/retire, SLO verdict flips — lands in
ONE process-wide structured journal through :func:`emit`, instead of the
per-subsystem ad-hoc surfaces that preceded it (``DriftDetector.events``,
``Compactor.last_advice`` — both survive as thin views over this
journal). An operator (and a test) can then read a single timeline:
sequence numbers are strictly increasing across all emitters, every
event carries a ``(component, name, shard, epoch)`` subject and an
optional request id, and ``/debug/events`` (obs/http.py) pages it by
``since_seq``.

Semantics worth knowing:

- **One emit = log line + metric + journal entry, atomically.** A call
  site passes its pre-formatted WARNING (``message``/``log_args``) and
  its legacy per-site counter constructor (``counter=``/
  ``counter_labels=``) into the same :func:`emit` that appends the ring
  entry and bumps ``raft_tpu_events_total{kind,severity}`` — the three
  can no longer disagree on re-arm paths (previously the WARNING fired
  unconditionally while the counter was gated, or vice versa).
- **Disabled mode is one flag check.** Under ``obs.disable()``
  :func:`emit` returns on the first line after reading
  ``metrics._enabled`` — the ``obs_overhead`` discipline; nothing is
  appended, logged, counted, tapped or sunk.
- **Transition dedup lives here.** :func:`transition` records the last
  state (and a standing payload) per key, returning True only on
  change — the once-per-transition bookkeeping the compactor's
  ``_advice_key`` used to duplicate. The payload store is what makes
  ``Compactor.last_advice`` eviction-proof: a standing advisory survives
  even after its emitting event scrolls off the bounded ring.
- **Subscriber taps are the controller seam** (ROADMAP item 2): a tap
  sees every event, in sequence order, delivered synchronously inside
  the journal lock — taps must be fast and non-blocking (queue and
  return); a raising tap is dropped from delivery for that event but
  never breaks the emitter.
- **The JSONL sink rides the WAL's durability discipline**: appended
  line-per-event and rotated atomically (``os.replace`` + directory
  fsync, the ``core/serialize.atomic_write`` rename discipline), and
  :func:`load_jsonl` tolerates a torn tail exactly like WAL replay — a
  crash mid-append loses at most the unacknowledged last line.
- **Not yet ported: the flight recorder** (``arm_flight_recorder`` /
  ``snapshot``), whose trigger is the SLO verdict of ``obs/slo.py``; its
  ``flight_recorder`` kind stays in the catalogue.

Kind catalogue: :data:`KINDS` below is the single source of truth
(``emit`` rejects unknown kinds); docs/observability.md mirrors it and
``tests/test_obs_catalogue.py`` lints both directions.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from typing import Callable

from . import metrics

__all__ = [
    "EventJournal", "KINDS", "SEVERITIES", "emit", "subscribe",
    "unsubscribe", "transition", "transition_payload", "query", "tail",
    "last_seq", "counts_by_kind", "attach_sink", "detach_sink",
    "load_jsonl", "clear", "default_journal", "configure",
]

SEVERITIES = ("info", "warning", "error")

# kind -> default severity. THE catalogue: emit() rejects kinds not
# listed here, docs/observability.md mirrors this table, and the
# catalogue lint (tests/test_obs_catalogue.py) holds the two equal in
# both directions — a new kind ships with its doc row or not at all.
KINDS = {
    # quality / tuning
    "retune_advised": "warning",
    # compaction lifecycle (stream/compactor.py)
    "reshard_advised": "warning",
    "reshard_advice_cleared": "info",
    "compaction_started": "info",
    "compaction_completed": "info",
    "compaction_failed": "error",
    # memory ledger (obs/mem.py)
    "budget_refusal": "error",
    "mem_pressure": "warning",
    # tiered storage (stream/tiered.py)
    "tier_promote": "info",
    "tier_spill": "info",
    # replica group (stream/replicated.py)
    "replica_fenced": "warning",
    "replica_unfenced": "info",
    "replica_probe": "info",
    "replica_stale": "error",
    "replica_failover": "warning",
    # elastic resharding (stream/sharded.py)
    "reshard_started": "info",
    "reshard_flip": "info",
    "reshard_committed": "info",
    "reshard_aborted": "error",
    # write-ahead log (stream/wal.py)
    "wal_truncated": "info",
    "wal_recovered": "info",
    # serve registry (serve/registry.py)
    "serve_published": "info",
    "serve_retired": "info",
    # SLO verdict transitions (obs/slo.py)
    "slo_verdict": "info",
    # closed-loop controller decisions (control/controller.py) — every
    # event embeds the triggering sensor event's seq + evidence inline,
    # so a decision is replayable from the journal alone
    "control/decision": "info",
    "control/skipped": "info",
    "control/action_completed": "info",
    "control/action_failed": "error",
    "control/degraded": "warning",
    "control/restored": "info",
    # process-mesh worker breakers (net/mesh.py) — the cross-process
    # mirror of the replica_* family: a killed worker process fences,
    # the scatter fails over to its twin in the same call
    "net_worker_fenced": "warning",
    "net_worker_unfenced": "info",
    "net_worker_failover": "warning",
    # the recorder's own breadcrumb (this module)
    "flight_recorder": "info",
}

_SUBJECT_KEYS = ("component", "name", "shard", "epoch")

_LOG_LEVELS = {"info": "info", "warning": "warning", "error": "error"}


@functools.lru_cache(maxsize=None)
def _c_events():
    return metrics.counter(
        "raft_tpu_events_total",
        "journal events by kind and severity (the unified operations "
        "event plane — every advisory/transition call site emits here)")


def _norm_subject(subject) -> dict:
    """``(component, name, shard, epoch)`` tuple (trailing entries
    optional) or dict → the four flat subject keys (None-padded)."""
    if subject is None:
        vals = ()
    elif isinstance(subject, dict):
        return {k: subject.get(k) for k in _SUBJECT_KEYS}
    else:
        vals = tuple(subject)
    out = dict.fromkeys(_SUBJECT_KEYS)
    for k, v in zip(_SUBJECT_KEYS, vals):
        out[k] = v
    return out


class EventJournal:
    """One bounded, lock-guarded event ring (see module doc). The
    process-wide instance lives behind the module-level veneer; tests
    construct their own with an injected clock and a small capacity."""

    def __init__(self, capacity: int = 2048,
                 clock: Callable[[], float] = time.monotonic):
        # RLock: a subscriber tap may emit (the controller seam reacts
        # in-line); delivery stays in-lock so tap order == seq order
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._seq = 0
        self._clock = clock
        # cumulative per-kind counts — survive ring eviction, so a bench
        # window's per-kind attribution never undercounts
        self._counts: dict[str, int] = {}
        self._taps: list = []
        # transition-dedup state: key -> (state, payload). Plain dict
        # bookkeeping, NOT gated on metrics._enabled — standing
        # advisories (Compactor.last_advice) must answer correctly even
        # while the observable surface is off.
        self._transitions: dict = {}
        # durable JSONL sink (attach_sink)
        self._sink_path: str | None = None
        self._sink_f = None
        self._sink_bytes = 0
        self._sink_rotate = 0

    # -- emit ----------------------------------------------------------------
    def emit(self, kind: str, severity: str | None = None, *,
             subject=None, evidence: dict | None = None,
             request_id: str | None = None, message: str | None = None,
             log_args: tuple = (), counter=None,
             counter_labels: dict | None = None) -> dict | None:
        """Append one event; returns the event dict (None when obs is
        disabled — the single flag check below IS the disabled path).
        ``counter`` is the call site's legacy lru-cached metric
        constructor (zero-arg, returns the Metric), incremented here so
        the per-site counter, the WARNING (``message`` + lazy
        ``log_args``) and the journal entry are one atomic emission."""
        if not metrics._enabled:
            return None
        sev = KINDS.get(kind)
        if sev is None:
            raise ValueError(
                f"unknown event kind {kind!r}: add it to "
                f"raft_tpu_torch.obs.events.KINDS (and the docs/observability.md "
                "catalogue) first")
        if severity is not None:
            if severity not in SEVERITIES:
                raise ValueError(f"unknown severity {severity!r} "
                                 f"(one of {SEVERITIES})")
            sev = severity
        ev = dict(_norm_subject(subject))
        with self._lock:
            self._seq += 1
            ev.update(seq=self._seq, at=round(self._clock(), 6), kind=kind,
                      severity=sev, evidence=dict(evidence or {}),
                      request_id=request_id)
            self._ring.append(ev)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            _c_events().inc(1, kind=kind, severity=sev)
            if counter is not None:
                counter().inc(1, **(counter_labels or {}))
            if message is not None:
                from ..core.logger import logger

                getattr(logger, _LOG_LEVELS[sev])(message, *log_args)
            for fn in list(self._taps):
                try:
                    fn(ev)
                except Exception:  # a tap must never break the emitter
                    pass
            if self._sink_f is not None:
                self._sink_write(ev)
        return ev

    # -- taps ----------------------------------------------------------------
    def subscribe(self, fn) -> Callable:
        """Register a tap called with every event dict, in sequence
        order, inside the journal lock (be fast; never block). Returns
        ``fn`` for decorator use."""
        with self._lock:
            if fn not in self._taps:
                self._taps.append(fn)
        return fn

    def unsubscribe(self, fn) -> None:
        with self._lock:
            if fn in self._taps:
                self._taps.remove(fn)

    # -- transition dedup ----------------------------------------------------
    def transition(self, key, state, payload=None) -> bool:
        """Record ``state`` under ``key``; True iff it CHANGED (the
        emit-once-per-transition guard). ``payload`` is the standing
        value :meth:`transition_payload` answers — eviction-proof
        storage for "current advisory" style views."""
        with self._lock:
            prev = self._transitions.get(key)
            if prev is not None and prev[0] == state:
                return False
            self._transitions[key] = (state, payload)
            return prev is not None or state is not None

    def transition_payload(self, key):
        with self._lock:
            entry = self._transitions.get(key)
            return None if entry is None else entry[1]

    # -- reads ---------------------------------------------------------------
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def tail(self, n: int = 50) -> list:
        with self._lock:
            if n <= 0:
                return []
            return [dict(e) for e in list(self._ring)[-int(n):]]

    def query(self, *, kind: str | None = None, severity: str | None = None,
              component: str | None = None, name: str | None = None,
              since_seq: int = 0, limit: int | None = None) -> list:
        """Filtered, seq-ordered slice of the ring. ``since_seq`` is
        EXCLUSIVE (pass the last seq you saw — the pagination cursor);
        ``limit`` caps from the FRONT so pages walk forward."""
        with self._lock:
            out = [dict(e) for e in self._ring
                   if e["seq"] > int(since_seq)
                   and (kind is None or e["kind"] == kind)
                   and (severity is None or e["severity"] == severity)
                   and (component is None or e["component"] == component)
                   and (name is None or e["name"] == name)]
        if limit is not None:
            out = out[:max(int(limit), 0)]
        return out

    def counts_by_kind(self) -> dict:
        """Cumulative events per kind since construction/clear —
        eviction-proof (unlike ``len(query(...))``), so a bench window
        attributes counts by subtracting two calls."""
        with self._lock:
            return dict(self._counts)

    # -- durable JSONL sink --------------------------------------------------
    def attach_sink(self, path: str, *,
                    rotate_bytes: int = 4_000_000) -> None:
        """Mirror every event to ``path`` as one JSON line each. When the
        file exceeds ``rotate_bytes`` it rotates to ``path + ".1"``
        atomically (``os.replace`` + directory fsync — the
        ``core/serialize`` rename discipline); one rotated generation is
        kept. Reload with :func:`load_jsonl` (torn-tail tolerant)."""
        with self._lock:
            self._sink_close_locked()
            self._sink_path = str(path)
            self._sink_rotate = int(rotate_bytes)
            self._sink_f = open(self._sink_path, "ab")
            self._sink_bytes = self._sink_f.tell()

    def detach_sink(self) -> None:
        with self._lock:
            self._sink_close_locked()

    def _sink_close_locked(self) -> None:
        if self._sink_f is not None:
            try:
                self._sink_f.close()
            except OSError:
                pass
        self._sink_f = None
        self._sink_path = None
        self._sink_bytes = 0

    def _sink_write(self, ev: dict) -> None:
        from ..core import serialize

        try:
            line = (json.dumps(ev, default=float, sort_keys=True)
                    + "\n").encode()
            self._sink_f.write(line)
            self._sink_f.flush()
            self._sink_bytes += len(line)
            if self._sink_bytes >= self._sink_rotate:
                self._sink_f.close()
                os.replace(self._sink_path, self._sink_path + ".1")
                serialize.fsync_dir(os.path.dirname(
                    os.path.abspath(self._sink_path)))
                self._sink_f = open(self._sink_path, "ab")
                self._sink_bytes = 0
        except (OSError, ValueError):
            # a full/broken disk (or a descriptor closed under us) must
            # not take the emitter down; the ring and metrics still
            # carry the event
            self._sink_close_locked()

    # -- lifecycle -----------------------------------------------------------
    def clear(self) -> None:
        """Drop ring contents, counts and transition state (tests).
        ``seq`` keeps counting — like a WAL's sequence, it coordinates
        with ``since_seq`` cursors and must never restart."""
        with self._lock:
            self._ring.clear()
            self._counts.clear()
            self._transitions.clear()


# -- process-wide journal + module-level veneer ------------------------------

_journal = EventJournal()


def default_journal() -> EventJournal:
    return _journal


def configure(capacity: int | None = None,
              clock: Callable[[], float] | None = None) -> EventJournal:
    """Swap the process-wide journal (tests: injected clock / small
    ring). Returns the NEW journal; taps, sinks and transition state of
    the old one are dropped."""
    global _journal
    old = _journal
    _journal = EventJournal(
        capacity=capacity if capacity is not None else old._ring.maxlen,
        clock=clock if clock is not None else old._clock)
    old.detach_sink()
    return _journal


def emit(kind: str, severity: str | None = None, *, subject=None,
         evidence: dict | None = None, request_id: str | None = None,
         message: str | None = None, log_args: tuple = (),
         counter=None, counter_labels: dict | None = None) -> dict | None:
    return _journal.emit(kind, severity, subject=subject,
                         evidence=evidence, request_id=request_id,
                         message=message, log_args=log_args,
                         counter=counter, counter_labels=counter_labels)


def subscribe(fn) -> Callable:
    return _journal.subscribe(fn)


def unsubscribe(fn) -> None:
    _journal.unsubscribe(fn)


def transition(key, state, payload=None) -> bool:
    return _journal.transition(key, state, payload)


def transition_payload(key):
    return _journal.transition_payload(key)


def query(**kw) -> list:
    return _journal.query(**kw)


def tail(n: int = 50) -> list:
    return _journal.tail(n)


def last_seq() -> int:
    return _journal.last_seq()


def counts_by_kind() -> dict:
    return _journal.counts_by_kind()


def attach_sink(path: str, *, rotate_bytes: int = 4_000_000) -> None:
    _journal.attach_sink(path, rotate_bytes=rotate_bytes)


def detach_sink() -> None:
    _journal.detach_sink()


def clear() -> None:
    _journal.clear()


def load_jsonl(path: str) -> list:
    """Reload a sink file: one event dict per intact line, stopping at
    the first undecodable one — the WAL's torn-tail discipline (a crash
    mid-append loses only the unacknowledged tail; everything before it
    is returned)."""
    out: list = []
    try:
        with open(path, "rb") as f:
            for raw in f:
                try:
                    out.append(json.loads(raw))
                except ValueError:
                    break
    except OSError:
        pass
    return out
