"""SLO tracking: availability / latency / quality objectives with
multi-window error-budget burn rates and a /healthz verdict.

Counterpart of raft_tpu/obs/slo.py: the same objectives, ring, burn rates,
verdicts, ``raft_tpu_slo_*`` metrics and ``slo_verdict`` journal events (a
failing verdict trips an armed flight recorder,
:func:`raft_tpu_torch.obs.events.arm_flight_recorder`). Plain Python, no
device work.

A serving fleet is not operated on raw metrics — it is operated on
*objectives* and how fast they consume their error budget (the
multi-window, multi-burn-rate alerting pattern of the Google SRE workbook,
ch. 5). This module is the stdlib-only tracker the serve tier feeds:

- **availability** — the non-overload admission fraction: every
  :meth:`SearchService.submit` either admits (good) or sheds at the queue
  bound (bad). Target e.g. 99.9% → a 0.1% error budget.
- **latency** — the p99 bound, computed from the queue-wait/flush
  decomposition the batcher already measures: a request is good when
  ``queue_wait + flush <= latency_bound_s``; the target fraction (default
  0.99) makes "p99 <= bound" a budgeted objective instead of a gauge.
- **quality** — the recall floor, fed by the
  :class:`~raft_tpu_torch.obs.quality.RecallCanary`: every scored neighbor slot
  is good (matched the exact oracle) or bad; the budget is
  ``1 - recall_floor``.

Events land in an injected-clock ring of fixed time slots, so burn rates
over each window are exact and deterministic under test (no wall-clock
sleeps — the same discipline as the serve/stream suites). ``burn rate =
(bad fraction in window) / error budget``: 1.0 means the budget is being
consumed exactly at the sustainable rate; the degraded/failing thresholds
fire only when EVERY window agrees (the short window proves it is still
happening, the long one that it matters).

:meth:`healthz` renders the verdict for an HTTP endpoint: ready/degraded
→ 200, failing → 503 so load balancers eject the replica; the exporter's
``/healthz`` serves it (``obs.start_http_exporter(port, slo=tracker)``,
:mod:`raft_tpu_torch.obs.http`). Burn rates and the status are also
published as ``raft_tpu_slo_*`` gauges.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import Callable

from ..core.errors import expects
from . import events as obs_events
from . import metrics

__all__ = ["SLOPolicy", "SLOTracker", "OBJECTIVES"]

OBJECTIVES = ("availability", "latency", "quality")

_STATUS_CODE = {"ready": 0.0, "degraded": 1.0, "failing": 2.0}


@functools.lru_cache(maxsize=None)
def _g_burn():
    return metrics.gauge(
        "raft_tpu_slo_burn_rate",
        "error-budget burn rate per objective and window (1.0 = consuming "
        "the budget exactly at the sustainable rate)")


@functools.lru_cache(maxsize=None)
def _g_status():
    return metrics.gauge(
        "raft_tpu_slo_status",
        "SLO verdict: 0 ready, 1 degraded, 2 failing (the /healthz answer)")


@functools.lru_cache(maxsize=None)
def _c_events():
    return metrics.counter(
        "raft_tpu_slo_events_total",
        "SLO events per objective and outcome (good/bad)")


@dataclass(frozen=True)
class SLOPolicy:
    """Objectives + windowing (see module doc). Targets are GOOD-event
    fractions; budgets are their complements. ``windows_s`` must be
    multiples of ``slot_s`` (the ring's resolution)."""

    availability_target: float = 0.999
    latency_bound_s: float = 0.25
    latency_target: float = 0.99     # fraction under the bound == p99 bound
    recall_floor: float = 0.90
    windows_s: tuple = (300.0, 3600.0)
    slot_s: float = 30.0
    degraded_burn: float = 1.0
    failing_burn: float = 10.0


class SLOTracker:
    """Multi-window burn-rate tracker over an injected-clock slot ring."""

    def __init__(self, policy: SLOPolicy = SLOPolicy(), *,
                 name: str = "default",
                 clock: Callable[[], float] = time.monotonic):
        for target in (policy.availability_target, policy.latency_target,
                       policy.recall_floor):
            expects(0.0 < target < 1.0,
                    "SLO targets must be in (0, 1), got %r", target)
        expects(policy.slot_s > 0, "slot_s must be positive")
        for w in policy.windows_s:
            expects(w >= policy.slot_s
                    and abs(w / policy.slot_s - round(w / policy.slot_s))
                    < 1e-9,
                    "window %rs must be a multiple of slot_s=%rs",
                    w, policy.slot_s)
        self.policy = policy
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._n_slots = int(round(max(policy.windows_s) / policy.slot_s))
        # ring[objective][pos] = [good, bad]; _slot is the absolute slot id
        # currently written at _slot % n_slots
        self._ring = {o: [[0.0, 0.0] for _ in range(self._n_slots)]
                      for o in OBJECTIVES}
        self._slot: int | None = None
        # last verdict seen by status() — the transition edge the
        # slo_verdict journal event (and the flight recorder) fires on
        self._last_status: str | None = None
        self._budget = {
            "availability": 1.0 - policy.availability_target,
            "latency": 1.0 - policy.latency_target,
            "quality": 1.0 - policy.recall_floor,
        }

    # -- ring mechanics ------------------------------------------------------
    def _advance_locked(self, now: float) -> int:
        idx = int(now // self.policy.slot_s)
        if self._slot is None:
            self._slot = idx
        elif idx > self._slot:
            gap = idx - self._slot
            if gap >= self._n_slots:  # everything in the ring expired
                for o in OBJECTIVES:
                    for slot in self._ring[o]:
                        slot[0] = slot[1] = 0.0
            else:
                for s in range(self._slot + 1, idx + 1):
                    pos = s % self._n_slots
                    for o in OBJECTIVES:
                        self._ring[o][pos][0] = 0.0
                        self._ring[o][pos][1] = 0.0
            self._slot = idx
        return self._slot % self._n_slots

    def _record(self, objective: str, good: float, bad: float) -> None:
        if good <= 0 and bad <= 0:
            return
        with self._lock:
            pos = self._advance_locked(self._clock())
            self._ring[objective][pos][0] += good
            self._ring[objective][pos][1] += bad
        if metrics._enabled:
            if good:
                _c_events().inc(good, objective=objective, outcome="good")
            if bad:
                _c_events().inc(bad, objective=objective, outcome="bad")

    # -- feeds ---------------------------------------------------------------
    def record_admission(self, admitted: bool) -> None:
        """One submit outcome: admitted, or shed at the queue bound."""
        self._record("availability", 1.0 if admitted else 0.0,
                     0.0 if admitted else 1.0)

    def record_request(self, queue_wait_s: float, flush_s: float) -> None:
        """One served request's latency decomposition (the batcher's
        queue-wait + flush walls); good iff the sum is under the bound."""
        ok = (queue_wait_s + flush_s) <= self.policy.latency_bound_s
        self._record("latency", 1.0 if ok else 0.0, 0.0 if ok else 1.0)

    def record_quality(self, matched_slots: float, scored_slots: float)\
            -> None:
        """Canary rerank outcome: ``matched`` of ``scored`` neighbor slots
        agreed with the exact oracle."""
        matched = float(matched_slots)
        scored = float(scored_slots)
        expects(0.0 <= matched <= scored,
                "matched_slots (%r) must be within [0, scored_slots=%r]",
                matched_slots, scored_slots)
        self._record("quality", matched, scored - matched)

    # -- burn rates ----------------------------------------------------------
    def _window_counts_locked(self, objective: str, window_s: float,
                              now: float) -> tuple[float, float]:
        cur = self._advance_locked(now)
        n = int(round(window_s / self.policy.slot_s))
        ring = self._ring[objective]
        good = bad = 0.0
        for back in range(min(n, self._n_slots)):
            slot = ring[(cur - back) % self._n_slots]
            good += slot[0]
            bad += slot[1]
        return good, bad

    def burn_rate(self, objective: str, window_s: float) -> float:
        """``(bad fraction over the window) / error budget``; 0.0 when the
        window holds no events (an idle service is not burning budget)."""
        expects(objective in OBJECTIVES, "unknown objective %r (one of %s)",
                objective, ", ".join(OBJECTIVES))
        with self._lock:
            good, bad = self._window_counts_locked(
                objective, float(window_s), self._clock())
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / self._budget[objective]

    def burn_rates(self) -> dict:
        """{objective: {"<window>s": burn}} for every configured window,
        published to the ``raft_tpu_slo_burn_rate`` gauge as a side
        effect."""
        out: dict = {}
        for o in OBJECTIVES:
            out[o] = {}
            for w in self.policy.windows_s:
                burn = self.burn_rate(o, w)
                label = f"{int(w)}s"
                out[o][label] = round(burn, 4)
                if metrics._enabled:
                    _g_burn().set(round(burn, 4), objective=o, window=label)
        return out

    def burn_snapshot(self, window_s: float | None = None) -> dict:
        """Every objective's burn over ONE window (default the shortest
        configured) plus the window itself — the single-ring-walk
        snapshot a controller takes at decision time and inlines as
        evidence (the JAX package's ``control``: reshard admission, the
        degrade/restore loop, compaction pacing). One dict, one walk:
        the admission check and its journal evidence can never disagree
        on a slot boundary."""
        w = (float(window_s) if window_s is not None
             else min(self.policy.windows_s))
        out = {o: round(self.burn_rate(o, w), 4) for o in OBJECTIVES}
        out["window_s"] = w
        return out

    # -- verdict -------------------------------------------------------------
    def status(self, rates: dict | None = None) -> str:
        """ready / degraded / failing. An objective degrades (fails) the
        service only when its burn exceeds the threshold in EVERY window —
        the multi-window AND that keeps one bad slot from flapping a
        long-window alert, and one stale hour from paging on a problem
        that already stopped. ``rates`` (a :meth:`burn_rates` result) lets
        a caller make verdict and evidence atomic — :meth:`healthz` passes
        its own so the body's rates can never disagree with the status a
        slot boundary later."""
        if rates is None:
            rates = self.burn_rates()
        status = "ready"
        for o in OBJECTIVES:
            burns = rates[o].values()
            if all(b >= self.policy.failing_burn for b in burns):
                status = "failing"
                break
            if all(b >= self.policy.degraded_burn for b in burns):
                status = "degraded"
        if metrics._enabled:
            _g_status().set(_STATUS_CODE[status], name=self.name)
        if status != self._last_status:
            prev, self._last_status = self._last_status, status
            # verdict TRANSITIONS journal once each (ready→failing and
            # back both matter in a postmortem); a failing transition
            # also trips the armed flight recorder inside emit()
            obs_events.emit(
                "slo_verdict",
                severity=("error" if status == "failing" else
                          "warning" if status == "degraded" else "info"),
                subject=("slo", self.name, None, None),
                evidence={"status": status, "previous": prev,
                          "burn_rates": rates},
                message=("SLO verdict for %r: %s (was %s)"
                         if status != "ready" else None),
                log_args=(self.name, status, prev))
        return status

    def healthz(self) -> tuple[int, dict]:
        """The /healthz answer: (http status code, body dict). Failing maps
        to 503 so load balancers eject the replica; degraded stays 200 —
        it is an alert, not an outage. The verdict is computed from the
        SAME burn-rate snapshot the body reports (one ring walk)."""
        rates = self.burn_rates()
        status = self.status(rates)
        body = {
            "status": status,
            "name": self.name,
            "objectives": {
                o: {"burn_rates": rates[o],
                    "budget": round(self._budget[o], 6)}
                for o in OBJECTIVES
            },
            "policy": {
                "availability_target": self.policy.availability_target,
                "latency_bound_s": self.policy.latency_bound_s,
                "latency_target": self.policy.latency_target,
                "recall_floor": self.policy.recall_floor,
                "windows_s": list(self.policy.windows_s),
                "degraded_burn": self.policy.degraded_burn,
                "failing_burn": self.policy.failing_burn,
            },
        }
        return (503 if status == "failing" else 200), body
