"""Serving-layer error types.

All derive from :class:`raft_tpu_torch.core.errors.RaftError` so a caller's
existing ``except RaftError`` fences keep working; the three subclasses are
the serving layer's fast-fail vocabulary (the reference leaves request
scheduling to the user, so it has no counterpart — these follow the standard
serving taxonomy: overload, deadline, shutdown).
"""

from __future__ import annotations

from ..core.errors import RaftError

__all__ = ["ServeError", "OverloadedError", "DeadlineExceededError",
           "ServiceClosedError", "MemoryBudgetError",
           "ReplicaUnavailableError"]


class ServeError(RaftError):
    """Base for serving-layer failures."""


class OverloadedError(ServeError):
    """Admission control rejected the request: the queue is at its bound.

    Raised synchronously from ``submit`` — the caller finds out in
    microseconds, not after its deadline (fast-fail is the point: shed load
    at the door, never queue work that cannot be served in time).
    """


class MemoryBudgetError(OverloadedError):
    """The ``Resources.memory_budget_bytes`` gate refused admission: the
    operation would push the ledger-accounted device bytes past the budget
    (:func:`raft_tpu_torch.obs.mem.gate`).

    An :class:`OverloadedError`, so existing shed-load fences catch it, and
    whole-or-nothing like every admission refusal: raised at
    ``build``/``publish``/``upsert`` BEFORE any state lands. Structured
    fields: ``site`` (which admission point), ``budget_bytes``,
    ``accounted_bytes`` (ledger device total at refusal), ``need_bytes``
    (the projected growth that tripped the gate).
    """

    def __init__(self, msg: str, *, site: str = "", budget_bytes: int = 0,
                 accounted_bytes: int = 0, need_bytes: int = 0):
        super().__init__(msg)
        self.site = site
        self.budget_bytes = int(budget_bytes)
        self.accounted_bytes = int(accounted_bytes)
        self.need_bytes = int(need_bytes)


class ReplicaUnavailableError(ServeError):
    """EVERY replica of a ``stream.ReplicatedShard`` is
    fenced or failed — the query cannot be served by any twin. One dead
    replica never raises this (the scatter retries the survivor in the
    same flush, which is the availability contract); all-dead is a real
    outage the caller must see. Structured fields: ``name`` (the shard),
    ``replicas`` (total), ``fenced`` (how many were fenced when the last
    attempt failed)."""

    def __init__(self, msg: str, *, name: str = "", replicas: int = 0,
                 fenced: int = 0):
        super().__init__(msg)
        self.name = name
        self.replicas = int(replicas)
        self.fenced = int(fenced)


class DeadlineExceededError(ServeError):
    """The request's deadline expired.

    Either synchronously at submit (deadline already in the past) or set on
    the request's future when the batcher drains the queue — expired
    requests are dropped BEFORE being batched, so an overloaded service
    never burns device time on results nobody is waiting for.
    """


class ServiceClosedError(ServeError):
    """The service (or one of its streams) has been shut down."""
