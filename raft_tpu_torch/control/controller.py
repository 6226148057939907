"""The serving-plane controller (see the package doc).

The port's own copy of raft_tpu/control/controller.py. Its actuators are
the port's: the retune sweep is :func:`raft_tpu_torch.tune.sweep` on the
index's device, the republish is ``publish(tuned=)`` through a registry
whose kernels are already loaded (the warm ladder builds nothing), and the
reshard is :meth:`raft_tpu_torch.stream.ShardedMutableIndex.reshard`. An
actuation runs on the controller's thread while serve flushes run on the
batcher's, on the same device, as a compaction's fold does.

Design rules, in the repo's established discipline:

- **The journal tap queues and returns.** Taps run inside the journal
  lock, so :meth:`Controller._tap` only appends the sensor event to a
  bounded deque; all actuation happens in :meth:`Controller.step` —
  driven directly by tests (injected clock, no sleeps) or by the
  background worker ``start()`` spawns for deployments, exactly the
  :class:`raft_tpu_torch.stream.Compactor` split.
- **Every decision is evidence-logged.** Acting, skipping and failing
  each emit one ``control/*`` event whose evidence embeds the triggering
  sensor event's ``seq`` and evidence dict inline — a decision is
  replayable from the journal alone, and the ``seq`` chain
  (sensor → ``control/decision`` → outcome event) is the causal record
  the bench rows assert.
- **Bounded everywhere.** Per-action cooldowns (armed on success AND
  failure — a crashing actuator must not retry-storm), one heavy
  actuation at a time across all actions, a bounded event queue
  (overflow counts, oldest dropped), and ``dry_run=`` which logs
  decisions without acting.
- **The r5 non-transfer rule is a hard guard.** Before ANY publish the
  controller re-measures the index's shape family and refuses a decision
  whose balance class differs (:class:`NonTransferError`): cross-class
  transfer is the measured 0.31-vs-0.82 recall collapse
  (``tune.decisions`` module doc), so even a restore of the original pin
  is refused if the corpus left its class — the only safe action then is
  a fresh sweep.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import deque
from typing import Callable

from ..core.errors import RaftError, expects
from ..obs import events as obs_events
from ..obs import metrics

__all__ = ["Controller", "ControlPolicy", "NonTransferError"]

# sensor kinds the tap queues; everything else passes through untouched
_SENSOR_KINDS = ("retune_advised", "reshard_advised")
_ACTIONS = ("retune", "reshard", "degrade", "restore")


class NonTransferError(RaftError):
    """A decision's balance class does not match the live index's
    measured class — applying it is the BASELINE-r5 recall collapse, so
    the controller refuses (the hard guard)."""


@functools.lru_cache(maxsize=None)
def _c_actions():
    return metrics.counter(
        "raft_tpu_control_actions_total",
        "controller decisions by action and outcome (completed/failed/"
        "skipped/dry_run) — the closed-loop serving plane's activity")


@functools.lru_cache(maxsize=None)
def _g_inflight():
    return metrics.gauge(
        "raft_tpu_control_inflight",
        "1 while the controller's single heavy-actuation slot is held "
        "(labelled by the action holding it)")


@functools.lru_cache(maxsize=None)
def _g_degraded():
    return metrics.gauge(
        "raft_tpu_control_degraded",
        "1 while a watched name serves the controller's degraded (cheap) "
        "operating point instead of its pinned decision")


@dataclasses.dataclass(frozen=True)
class ControlPolicy:
    """Bounds and thresholds for one :class:`Controller` (all times on
    the controller's injected clock).

    Cooldowns arm after an actuation COMPLETES OR FAILS (never after a
    skip) and gate the next decision for that action. ``restore_clear_s``
    is the hysteresis: latency burn must stay below ``degrade_burn`` for
    that long, continuously, before a degraded name is restored — one
    good window must not flap the operating point back into a still-hot
    serving path. ``burn_window_s=None`` consults the SLO policy's
    shortest configured window. ``min_headroom_frac`` is the device-
    budget headroom a heavy reshard must see (spillable tier mirrors
    count as reclaimable); with no budget armed the check passes."""

    retune_cooldown_s: float = 600.0
    reshard_cooldown_s: float = 900.0
    degrade_cooldown_s: float = 120.0
    restore_clear_s: float = 120.0
    burn_window_s: float | None = None
    degrade_burn: float = 1.0
    reshard_max_burn: float = 1.0
    min_headroom_frac: float = 0.10
    queue_capacity: int = 256

    def cooldown_s(self, action: str) -> float:
        return {"retune": self.retune_cooldown_s,
                "reshard": self.reshard_cooldown_s,
                "degrade": self.degrade_cooldown_s,
                "restore": self.degrade_cooldown_s}[action]


class _Target:
    """One watched serve name: everything a bounded retune needs at
    decision time, registered up front so the controller never probes at
    actuation time (``watch()`` docstring)."""

    __slots__ = ("name", "index", "queries", "dataset", "gt", "k", "ks",
                 "grid", "base_params", "repeats", "recall_target",
                 "warm_data", "decision", "degrade_params", "degraded",
                 "clear_since")

    def __init__(self, name, index, queries, dataset, gt, k, ks, grid,
                 base_params, repeats, recall_target, warm_data, decision,
                 degrade_params):
        self.name = name
        self.index = index
        self.queries = queries
        self.dataset = dataset
        self.gt = gt
        self.k = k
        self.ks = ks
        self.grid = grid
        self.base_params = base_params
        self.repeats = repeats
        self.recall_target = recall_target
        self.warm_data = warm_data
        self.decision = decision          # the live pin (Decision | None)
        self.degrade_params = degrade_params
        self.degraded = False
        self.clear_since: float | None = None


class Controller:
    """Closed-loop controller over journal sensors and mesh actuators.

    Construction wires the *capabilities*; :meth:`watch` /
    :meth:`attach_mesh` / :meth:`attach_compactor` register the targets;
    :meth:`arm` subscribes the journal tap. Tests drive :meth:`step`
    directly (injected ``clock``, no sleeps); deployments call
    :meth:`start` for the polling worker.

    ``publisher`` is anything with ``publish()`` (a
    :class:`~raft_tpu_torch.serve.SearchService` or
    :class:`~raft_tpu_torch.serve.IndexRegistry`); ``slo`` an
    :class:`~raft_tpu_torch.obs.slo.SLOTracker` (burn admission + the degrade
    loop need one); ``res`` a :class:`~raft_tpu_torch.core.Resources` whose
    ``memory_budget_bytes`` arms the headroom admission check.
    ``dry_run=True`` logs every decision with its evidence but actuates
    nothing — the recommended first deployment."""

    def __init__(self, *, publisher=None, slo=None, res=None,
                 policy: ControlPolicy = ControlPolicy(),
                 dry_run: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "default"):
        expects(publisher is None or hasattr(publisher, "publish"),
                "publisher must expose publish() (SearchService or "
                "IndexRegistry)")
        self.name = str(name)
        self.policy = policy
        self.dry_run = bool(dry_run)
        self._publisher = publisher
        self._slo = slo
        self._res = res
        self._clock = clock
        self._lock = threading.RLock()
        self._queue: deque = deque(maxlen=int(policy.queue_capacity))
        self._dropped = 0
        self._targets: dict[str, _Target] = {}
        self._mesh = None
        self._mesh_warm_buckets = None
        self._mesh_ks = (10,)
        self._mesh_warm_data = None
        self._mesh_publish_name: str | None = None
        self._compactors: list = []
        self._cooldowns: dict[str, float] = {}
        self._inflight: str | None = None
        self._armed = False
        self._last_action: dict | None = None
        self._counts: dict[str, dict[str, int]] = {}
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None

    # -- registration --------------------------------------------------------
    def watch(self, name: str, index, queries, *, dataset=None, gt=None,
              k: int = 10, ks=None, grid: list | None = None,
              base_params=None, repeats: int = 1,
              recall_target="default", warm_data=None, decision=None,
              degrade_params: dict | None = None) -> None:
        """Register a published name for the retune and degrade loops.

        ``index`` is the plain built index serving under ``name``;
        ``queries``/``dataset``/``gt`` are the canary/corpus samples a
        bounded sweep measures against (registered NOW so no sensor is
        re-probed at decision time); ``grid`` bounds the sweep (default
        :func:`raft_tpu_torch.tune.smoke_grid` — three arms); ``decision`` is
        the currently-pinned :class:`~raft_tpu_torch.tune.Decision` (what a
        restore republishes); ``degrade_params`` the explicit cheap
        operating point for latency-burn degradation (default: the pin
        minus its ``refine_ratio`` epilogue)."""
        expects(self._publisher is not None,
                "watch() needs a publisher (the retune/degrade loops "
                "republish through it)")
        expects(degrade_params is None or decision is not None,
                "degrade_params needs the pinned decision for its "
                "kind/family key — pass decision= too")
        kks = (k,) if ks is None else ((ks,) if isinstance(ks, int)
                                       else tuple(ks))
        with self._lock:
            self._targets[str(name)] = _Target(
                str(name), index, queries, dataset, gt, int(k), kks,
                grid, base_params, int(repeats), recall_target, warm_data,
                decision, degrade_params)

    def attach_mesh(self, mesh, *, warm_buckets=None, ks=(10,),
                    warm_data=None, publish_name: str | None = None)\
            -> None:
        """Register the :class:`~raft_tpu_torch.stream.ShardedMutableIndex`
        the reshard loop drives. ``warm_buckets`` (library mode) or
        ``publish_name`` (+ the controller's publisher: the registry
        warm-before-flip seam) pre-warms the successor topology's
        programs — either way the flip is compile-free to serving
        traffic (:meth:`~raft_tpu_torch.stream.ShardedMutableIndex.reshard`)."""
        expects(hasattr(mesh, "reshard"),
                "attach_mesh needs a reshard()-capable mesh "
                "(stream.ShardedMutableIndex)")
        with self._lock:
            self._mesh = mesh
            self._mesh_warm_buckets = warm_buckets
            self._mesh_ks = (ks,) if isinstance(ks, int) else tuple(ks)
            self._mesh_warm_data = warm_data
            self._mesh_publish_name = publish_name

    def attach_compactor(self, compactor) -> None:
        """Wire the compaction-pacing hint: while latency burn crosses
        ``policy.degrade_burn``, the compactor defers non-forced folds
        (:meth:`raft_tpu_torch.stream.Compactor.set_pacing`) instead of
        competing with the serve path at the worst moment."""
        expects(hasattr(compactor, "set_pacing"),
                "attach_compactor needs set_pacing() "
                "(stream.Compactor)")
        compactor.set_pacing(self._pacing_defer)
        with self._lock:
            self._compactors.append(compactor)

    # -- lifecycle -----------------------------------------------------------
    def arm(self) -> "Controller":
        """Subscribe the journal tap; idempotent. Returns self."""
        with self._lock:
            if not self._armed:
                obs_events.subscribe(self._tap)
                self._armed = True
        return self

    def disarm(self) -> None:
        with self._lock:
            if self._armed:
                obs_events.unsubscribe(self._tap)
                self._armed = False

    def start(self, poll_interval_s: float = 0.05) -> "Controller":
        """Arm and spawn the background worker polling :meth:`step` —
        the deployment mode; tests drive :meth:`step` directly."""
        self.arm()
        with self._lock:
            if self._worker is not None:
                return self
            self._stop.clear()
            self._worker = threading.Thread(
                target=self._run, name=f"raft-control-{self.name}",
                daemon=True)
            self._worker.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop the worker (waits out an in-flight actuation) and
        disarm the tap. Idempotent."""
        self._stop.set()
        with self._lock:
            worker, self._worker = self._worker, None
        if worker is not None:
            worker.join(timeout_s)
        self.disarm()

    def _run(self) -> None:
        while not self._stop.wait(0.05):
            try:
                self.step()
            except Exception:  # pragma: no cover - never kill the worker
                pass

    # -- the tap (journal-lock context: queue and return) --------------------
    def _tap(self, ev: dict) -> None:
        if ev.get("kind") not in _SENSOR_KINDS:
            return
        with self._lock:
            if len(self._queue) == self._queue.maxlen:
                self._dropped += 1  # deque drops the oldest on append
            self._queue.append(ev)

    # -- the loop ------------------------------------------------------------
    def step(self) -> int:
        """Drain queued sensor events and run one burn-loop check;
        returns how many sensor events were handled. The deterministic
        unit tests and the bench drive this directly."""
        handled = 0
        while True:
            with self._lock:
                if not self._queue:
                    break
                ev = self._queue.popleft()
            if ev["kind"] == "retune_advised":
                self._consider_retune(ev)
            elif ev["kind"] == "reshard_advised":
                self._consider_reshard(ev)
            handled += 1
        self._poll_burn()
        return handled

    # -- shared decision plumbing -------------------------------------------
    def _trigger_evidence(self, ev: dict) -> dict:
        return {"trigger_kind": ev["kind"], "trigger_seq": ev.get("seq"),
                "trigger": dict(ev.get("evidence") or {})}

    def _count(self, action: str, outcome: str) -> None:
        with self._lock:
            per = self._counts.setdefault(action, {})
            per[outcome] = per.get(outcome, 0) + 1
        if metrics._enabled:
            _c_actions().inc(1, action=action, outcome=outcome)

    def _skip(self, action: str, name, reason: str, trigger: dict,
              detail: dict | None = None) -> None:
        self._count(action, "skipped")
        obs_events.emit(
            "control/skipped", subject=("control", name),
            evidence={"action": action, "reason": reason, **trigger,
                      **(detail or {})})

    def _admit(self, action: str, name, trigger: dict) -> bool:
        """Cooldown + single-heavy-actuation admission (shared by every
        action). True reserves nothing — the caller takes the heavy slot
        via :meth:`_heavy` after the decision event."""
        now = self._clock()
        with self._lock:
            until = self._cooldowns.get(action, 0.0)
            inflight = self._inflight
        if now < until:
            self._skip(action, name, "cooldown", trigger,
                       {"retry_after_s": round(until - now, 3)})
            return False
        if inflight is not None:
            self._skip(action, name, "inflight", trigger,
                       {"inflight": inflight})
            return False
        return True

    def _arm_cooldown(self, action: str) -> None:
        with self._lock:
            self._cooldowns[action] = (self._clock()
                                       + self.policy.cooldown_s(action))

    class _Heavy:
        def __init__(self, ctl, action):
            self._ctl, self._action = ctl, action

        def __enter__(self):
            ctl = self._ctl
            with ctl._lock:
                expects(ctl._inflight is None,
                        "heavy actuation slot already held by %r",
                        ctl._inflight)
                ctl._inflight = self._action
            if metrics._enabled:
                _g_inflight().set(1.0, action=self._action)
            return self

        def __exit__(self, *exc):
            ctl = self._ctl
            with ctl._lock:
                ctl._inflight = None
            if metrics._enabled:
                _g_inflight().set(0.0, action=self._action)

    def _heavy(self, action: str) -> "_Heavy":
        return Controller._Heavy(self, action)

    def _record_outcome(self, action: str, outcome: str, name,
                        trigger: dict, decision_seq, detail: dict,
                        error: BaseException | None = None) -> None:
        """One actuation outcome: counter + journal event + last_action
        + cooldown, atomically enough that status() never shows a
        completed action without its cooldown armed."""
        self._arm_cooldown(action)
        self._count(action, outcome)
        evidence = {"action": action, "outcome": outcome,
                    "decision_seq": decision_seq, **trigger, **detail}
        if error is not None:
            evidence["error"] = (f"{type(error).__name__}: "
                                 f"{str(error)[:200]}")
        subject = ("control", name)
        # literal kind strings: the catalogue lint pins every KINDS entry
        # to a greppable emit site
        if outcome == "failed":
            ev = obs_events.emit(
                "control/action_failed", subject=subject,
                evidence=evidence,
                message="controller %s failed for %r — %s",
                log_args=(action, name, evidence.get("error")))
        elif outcome == "degraded":
            ev = obs_events.emit("control/degraded", subject=subject,
                                 evidence=evidence)
        elif outcome == "restored":
            ev = obs_events.emit("control/restored", subject=subject,
                                 evidence=evidence)
        else:
            ev = obs_events.emit("control/action_completed",
                                 subject=subject, evidence=evidence)
        with self._lock:
            self._last_action = {
                "action": action, "outcome": outcome, "name": name,
                "at": round(self._clock(), 6),
                "seq": ev["seq"] if ev else None,
                "trigger_seq": trigger.get("trigger_seq"),
                "error": evidence.get("error")}
        if outcome == "failed":
            # bundle the incident while its evidence is still in the
            # ring; a no-op when no flight recorder is armed
            obs_events.snapshot(reason=f"control_{action}_failed")

    def _decide(self, action: str, name, trigger: dict,
                detail: dict | None = None):
        """Emit the ``control/decision`` event (the acted-on decision
        record). Returns ``(go, decision_seq)`` — ``go`` False under
        ``dry_run`` (the decision is logged, nothing actuates)."""
        ev = obs_events.emit(
            "control/decision", subject=("control", name),
            evidence={"action": action, "dry_run": self.dry_run,
                      **trigger, **(detail or {})})
        seq = ev["seq"] if ev else None
        if self.dry_run:
            self._count(action, "dry_run")
            return False, seq
        return True, seq

    # -- the r5 non-transfer hard guard --------------------------------------
    def _guard_transfer(self, decision, target: _Target) -> None:
        """Refuse any decision whose balance class differs from the
        index's measured class (see module doc). Re-measures via
        :func:`raft_tpu_torch.tune.family_of` at decision time — the corpus
        may have drifted since the pin."""
        from ..tune import family_of

        measured = family_of(target.index, target.dataset)
        have = str(decision.family).split("-")[-1]
        want = measured.split("-")[-1]
        if have != want:
            raise NonTransferError(
                f"decision {decision.key!r} pins balance class {have!r} "
                f"but the live index measures {measured!r}: operating "
                "points never transfer across balance classes (BASELINE "
                "r5, 0.31 vs 0.82 recall) — run a fresh sweep instead")

    # -- retune --------------------------------------------------------------
    def _consider_retune(self, ev: dict) -> None:
        name = ev.get("name")
        with self._lock:
            target = self._targets.get(name)
        trigger = self._trigger_evidence(ev)
        if target is None:
            return  # not watched; another controller's (or operator's) name
        if not self._admit("retune", name, trigger):
            return
        go, seq = self._decide("retune", name, trigger)
        if not go:
            return
        try:
            with self._heavy("retune"):
                decision, report = self._retune(target, trigger, seq)
        except Exception as e:
            self._record_outcome("retune", "failed", name, trigger, seq,
                                 {}, error=e)
            return
        self._record_outcome(
            "retune", "completed", name, trigger, seq,
            {"decision_key": decision.key, "params": dict(decision.params),
             "chosen_recall": decision.evidence.get("chosen_recall"),
             "target_met": decision.evidence.get("target_met"),
             "version": report.get("version")})

    def _retune(self, target: _Target, trigger: dict, seq):
        from .. import tune

        grid = target.grid
        if grid is None:
            grid = tune.smoke_grid(tune.kind_of(target.index))
        decision = tune.sweep(
            target.index, target.queries, k=target.k,
            dataset=target.dataset, gt=target.gt,
            recall_target=target.recall_target, grid=grid,
            base_params=target.base_params, repeats=target.repeats)
        self._guard_transfer(decision, target)
        report = self._publish(target, decision, "retune", trigger, seq)
        with self._lock:
            target.decision = decision
            target.degraded = False
            target.clear_since = None
        if metrics._enabled:
            _g_degraded().set(0.0, name=target.name)
        return decision, report

    def _publish(self, target: _Target, decision, action: str,
                 trigger: dict, decision_seq) -> dict:
        """Republish ``target`` at ``decision`` through the warm-before-
        flip seam; the cause dict rides the registry's
        ``serve_published`` evidence, closing the sensor → actuation
        seq chain inside the registry's own event."""
        return self._publisher.publish(
            target.name, target.index, tuned=decision, k=target.ks,
            warm_data=target.warm_data, res=self._res,
            cause={"controller": self.name, "action": action,
                   "trigger_seq": trigger.get("trigger_seq"),
                   "decision_seq": decision_seq})

    # -- reshard -------------------------------------------------------------
    def _consider_reshard(self, ev: dict) -> None:
        with self._lock:
            mesh = self._mesh
        trigger = self._trigger_evidence(ev)
        name = ev.get("name")
        if mesh is None or name != getattr(mesh, "name", None):
            return
        advice = dict(ev.get("evidence") or {})
        target_shards = advice.get("target")
        if not target_shards or target_shards == mesh.n_shards:
            self._skip("reshard", name, "stale", trigger,
                       {"n_shards": mesh.n_shards})
            return
        if not self._admit("reshard", name, trigger):
            return
        # admission: the heavy migration must not start into a memory
        # squeeze or a latency burn — abort cleanly, evidence inline
        head = self._headroom()
        if (head is not None
                and head["headroom_frac"] + head.get("spillable_frac", 0.0)
                < self.policy.min_headroom_frac):
            self._skip("reshard", name, "headroom", trigger, head)
            return
        burn = self._burn_snapshot()
        if (burn is not None
                and burn["latency"] >= self.policy.reshard_max_burn):
            self._skip("reshard", name, "slo_burn", trigger, {"burn": burn})
            return
        detail = {"target_shards": int(target_shards),
                  "headroom": head, "burn": burn}
        go, seq = self._decide("reshard", name, trigger, detail)
        if not go:
            return
        try:
            with self._heavy("reshard"):
                rep = mesh.reshard(
                    int(target_shards),
                    publisher=(self._publisher
                               if self._mesh_publish_name else None),
                    name=self._mesh_publish_name, ks=self._mesh_ks,
                    warm_buckets=self._mesh_warm_buckets,
                    warm_data=self._mesh_warm_data, res=self._res,
                    cause={"controller": self.name, "action": "reshard",
                           "trigger_seq": trigger.get("trigger_seq"),
                           "decision_seq": seq})
        except Exception as e:
            self._record_outcome("reshard", "failed", name, trigger, seq,
                                 detail, error=e)
            return
        self._record_outcome(
            "reshard", "completed", name, trigger, seq,
            {"from": rep["from"], "to": rep["to"],
             "rows_moved": rep["rows_moved"], "epoch": rep["epoch"],
             "wall_s": rep["wall_s"]})

    # -- degrade / restore (the burn loop) -----------------------------------
    def _burn_snapshot(self) -> dict | None:
        if self._slo is None:
            return None
        return self._slo.burn_snapshot(self.policy.burn_window_s)

    def _headroom(self) -> dict | None:
        from ..obs import mem as obs_mem

        return obs_mem.headroom(self._res)

    def _pacing_defer(self) -> bool:
        """The compactor pacing hint: defer non-forced folds while
        latency burn crosses the degrade threshold."""
        burn = self._burn_snapshot()
        return (burn is not None
                and burn["latency"] >= self.policy.degrade_burn)

    def _poll_burn(self) -> None:
        burn = self._burn_snapshot()
        if burn is None:
            return
        hot = burn["latency"] >= self.policy.degrade_burn
        now = self._clock()
        with self._lock:
            targets = list(self._targets.values())
        for target in targets:
            if not target.degraded:
                if hot:
                    self._consider_degrade(target, burn)
                continue
            if hot:
                target.clear_since = None
                continue
            if target.clear_since is None:
                target.clear_since = now
                continue
            if now - target.clear_since >= self.policy.restore_clear_s:
                self._consider_restore(target, burn)

    def _degraded_decision(self, target: _Target):
        """The cheap operating point: explicit ``degrade_params`` when
        registered, else the live pin minus its exact-refine epilogue
        (``refine_ratio=1`` — the dominant serve-path cost knob). Stays
        in the pin's family: degradation is never a class transfer."""
        from ..tune import Decision

        pin = target.decision
        if target.degrade_params is not None:
            expects(pin is not None,
                    "degrade_params needs the pinned decision for its "
                    "kind/family key — pass decision= to watch()")
            params = dict(target.degrade_params)
        else:
            if pin is None or int(pin.params.get("refine_ratio", 1)) <= 1:
                return None  # nothing cheaper to fall back to
            params = {kk: v for kk, v in pin.params.items()
                      if kk != "refine_ratio"}
        return Decision(
            kind=pin.kind, dtype=pin.dtype, family=pin.family,
            params=params,
            evidence={"derived_from": pin.key, "degraded": True})

    def _consider_degrade(self, target: _Target, burn: dict) -> None:
        with self._lock:
            until = self._cooldowns.get("degrade", 0.0)
        if self._clock() < until:
            # the burn loop polls every step — while the degrade cooldown
            # is armed, return silently instead of journaling one
            # cooldown/no_cheaper_point skip per poll for the whole burn
            return
        trigger = {"trigger_kind": "slo_burn", "trigger_seq": None,
                   "trigger": {"burn": burn,
                               "threshold": self.policy.degrade_burn}}
        cheap = self._degraded_decision(target)
        if cheap is None:
            self._skip("degrade", target.name, "no_cheaper_point", trigger)
            # hold the skip from repeating every poll while the burn lasts
            self._arm_cooldown("degrade")
            return
        if not self._admit("degrade", target.name, trigger):
            return
        go, seq = self._decide("degrade", target.name, trigger,
                               {"params": dict(cheap.params)})
        if not go:
            return
        try:
            with self._heavy("degrade"):
                self._guard_transfer(cheap, target)
                self._publish(target, cheap, "degrade", trigger, seq)
        except Exception as e:
            self._record_outcome("degrade", "failed", target.name,
                                 trigger, seq, {}, error=e)
            return
        with self._lock:
            target.degraded = True
            target.clear_since = None
        if metrics._enabled:
            _g_degraded().set(1.0, name=target.name)
        self._record_outcome(
            "degrade", "degraded", target.name, trigger, seq,
            {"params": dict(cheap.params), "pinned": target.decision.key})

    def _consider_restore(self, target: _Target, burn: dict) -> None:
        trigger = {"trigger_kind": "slo_burn_cleared", "trigger_seq": None,
                   "trigger": {"burn": burn,
                               "clear_s": self.policy.restore_clear_s}}
        if not self._admit("restore", target.name, trigger):
            return
        go, seq = self._decide("restore", target.name, trigger,
                               {"pinned": target.decision.key})
        if not go:
            return
        try:
            with self._heavy("restore"):
                self._guard_transfer(target.decision, target)
                self._publish(target, target.decision, "restore", trigger,
                              seq)
        except Exception as e:
            self._record_outcome("restore", "failed", target.name,
                                 trigger, seq, {}, error=e)
            return
        with self._lock:
            target.degraded = False
            target.clear_since = None
        if metrics._enabled:
            _g_degraded().set(0.0, name=target.name)
        self._record_outcome(
            "restore", "restored", target.name, trigger, seq,
            {"pinned": target.decision.key})

    # -- observability -------------------------------------------------------
    def status(self) -> dict:
        """The /debug/control (and /healthz ``controller``) payload:
        enabled/dry-run, the in-flight actuation, last action + outcome,
        active cooldowns (seconds remaining), degraded names, queue
        depth and per-action outcome counts."""
        now = self._clock()
        with self._lock:
            cooldowns = {a: round(t - now, 3)
                         for a, t in self._cooldowns.items() if t > now}
            degraded = sorted(t.name for t in self._targets.values()
                              if t.degraded)
            return {
                "enabled": self._armed,
                "dry_run": self.dry_run,
                "inflight": self._inflight,
                "last_action": (dict(self._last_action)
                                if self._last_action else None),
                "cooldowns": cooldowns,
                "degraded": degraded,
                "targets": sorted(self._targets),
                "mesh": getattr(self._mesh, "name", None),
                "queue": len(self._queue),
                "queue_dropped": self._dropped,
                "actions": {a: dict(c) for a, c in self._counts.items()},
            }
