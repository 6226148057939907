"""Client-side bounded retry for transient serve refusals.

:class:`~raft_tpu_torch.serve.errors.OverloadedError` is the service saying "not
right now" — the queue is at its bound, a delta memtable is full, a memory
budget refused admission. Those clear in milliseconds (a flush drains the
queue, a compaction folds the delta), so the right client response is a
short, bounded, jittered retry — not an immediate failure and not an
unbounded hammer. :class:`~raft_tpu_torch.serve.errors.DeadlineExceededError` is
the opposite: the request's time budget is SPENT, and retrying it would
serve an answer nobody is waiting for — it never retries, by construction.

:func:`submit_with_retry` wraps :meth:`SearchService.submit` with exactly
that policy: exponential backoff (``base_s`` doubling up to
``max_backoff_s``) with multiplicative jitter (de-synchronizes a thundering
herd of clients that were all refused by the same full queue), a bounded
attempt count, and deadline awareness — with ``timeout_s`` set, the backoff
never sleeps past the caller's deadline, and the per-attempt submit carries
the REMAINING budget so the service's own deadline accounting stays
truthful. Counterpart of raft_tpu/serve/retry.py.

Everything is injectable (``clock``/``sleep``/``rng``) so the policy is
unit-testable without wall-clock sleeps.
"""

from __future__ import annotations

import functools
import random
import time
from typing import Callable

from ..core.errors import expects
from ..obs import metrics
from .errors import DeadlineExceededError, OverloadedError

__all__ = ["submit_with_retry"]


@functools.lru_cache(maxsize=None)
def _c_retries():
    return metrics.counter(
        "raft_tpu_serve_retries_total",
        "client-side submit retries after OverloadedError "
        "(submit_with_retry; outcome: admitted/exhausted)")


def submit_with_retry(service, name: str, queries, k: int = 10, *,
                      timeout_s: float | None = None,
                      max_attempts: int = 5, base_s: float = 0.01,
                      max_backoff_s: float = 1.0, jitter: float = 0.5,
                      clock: Callable[[], float] = time.monotonic,
                      sleep: Callable[[float], None] = time.sleep,
                      rng: random.Random | None = None):
    """Submit to ``service`` with bounded, jittered retries on
    :class:`OverloadedError` ONLY; returns the admitted request's Future.

    Backoff before attempt ``n+1`` is ``base_s * 2**n`` capped at
    ``max_backoff_s``, scaled by a uniform jitter in
    ``[1 - jitter, 1 + jitter]``. ``max_attempts`` bounds total submits;
    when the last one is still refused, ITS ``OverloadedError`` re-raises
    (the caller sees the service's own refusal, structured fields intact).
    With ``timeout_s``, every attempt submits with the remaining budget
    and a backoff that would cross the deadline raises
    :class:`DeadlineExceededError` immediately instead of sleeping into
    it. ``DeadlineExceededError`` (and every other error) propagates on
    the first occurrence — a spent deadline must never burn more queue
    slots. ``clock``/``sleep``/``rng`` are injectable for tests.

    A refusal carrying a ``retry_after_s`` attribute — the server's own
    drain estimate, set from queue depth by the net front door's
    ``Retry-After`` header (:meth:`SearchService.retry_after_hint`) —
    overrides the exponential schedule for THAT attempt: the client
    sleeps the hint scaled by a jitter in ``[1, 1 + jitter]`` (upward
    only — never less than the server asked, uncapped by
    ``max_backoff_s`` because the server's estimate beats the client's
    blind doubling). Refusals without the hint fall back to the
    exponential backoff above; the deadline check applies either way."""
    expects(max_attempts >= 1, "max_attempts must be >= 1, got %d",
            max_attempts)
    expects(0.0 <= jitter <= 1.0, "jitter must be in [0, 1], got %g", jitter)
    rng = rng or random.Random()
    deadline = None if timeout_s is None else clock() + float(timeout_s)
    for attempt in range(int(max_attempts)):
        remaining = None if deadline is None else deadline - clock()
        try:
            fut = service.submit(name, queries, k, timeout_s=remaining)
        except OverloadedError as exc:
            if attempt + 1 >= int(max_attempts):
                if metrics._enabled:
                    _c_retries().inc(1, name=name, outcome="exhausted")
                raise
            hint = getattr(exc, "retry_after_s", None)
            if hint is not None and float(hint) > 0:
                # server-supplied drain estimate: jitter upward only
                delay = float(hint) * (1.0 + jitter * rng.random())
            else:
                delay = min(base_s * (2.0 ** attempt), max_backoff_s)
                delay *= 1.0 - jitter + 2.0 * jitter * rng.random()
            if deadline is not None and clock() + delay >= deadline:
                raise DeadlineExceededError(
                    f"deadline would expire during retry backoff "
                    f"({delay * 1e3:.1f} ms sleep vs "
                    f"{max(deadline - clock(), 0) * 1e3:.1f} ms left) — "
                    "not retrying into a spent budget") from None
            sleep(delay)
            continue
        if attempt and metrics._enabled:
            _c_retries().inc(attempt, name=name, outcome="admitted")
        return fut
    raise AssertionError("unreachable")  # pragma: no cover
