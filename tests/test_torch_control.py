"""raft_tpu_torch.control against raft_tpu.control (tier-1 ``control`` marker).

The cases of tests/test_control.py on the port, each deterministic (an
injected clock, the journal's ``configure()``, faults through
:mod:`raft_tpu_torch.testing.faults`, ``step()`` driven directly, no
sleeps):

- retune: drift advice → bounded sweep → ``tuned=`` republish through the
  warm-before-flip seam, the causal seq chain (sensor →
  ``control/decision`` → outcome, and the ``cause`` inside the registry's
  ``serve_published``) end to end; failures leave the registry serving
  its previous version and arm the cooldown;
- reshard: advice → topology doubling under headroom / burn admission,
  and a fault at every ``reshard/*`` point aborting with the mesh still
  serving its old topology;
- degrade / restore with hysteresis, the non-transfer guard;
- compaction pacing; bounds and observability (``status()``,
  ``/debug/control``, the ``/healthz`` fold, the 404 listing);

then parity: one scripted scenario (retune → cooldown skip → degrade →
restore) through the JAX ``Controller`` over JAX objects and through the
port's over port objects, the retune corpus a JAX-built IVF-Flat index
loaded into the port: both emit the same sequence of ``control/*`` kinds
with equal ``outcome`` and ``reason`` fields.

Every started controller and exporter is stopped in a ``finally`` or a
``with``; the last test checks that no controller worker is left.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import control as jcontrol
from raft_tpu import obs as jobs
from raft_tpu import tune as jtune
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.obs import events as jevents
from raft_tpu.obs.slo import SLOPolicy as JSLOPolicy
from raft_tpu.obs.slo import SLOTracker as JSLOTracker
from raft_tpu.serve import IndexRegistry as JRegistry
from raft_tpu_torch import obs, stream, tune
from raft_tpu_torch.control import Controller, ControlPolicy, NonTransferError
from raft_tpu_torch.core import Resources
from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.obs import events
from raft_tpu_torch.obs import mem as obs_mem
from raft_tpu_torch.obs.http import MetricsExporter
from raft_tpu_torch.obs.slo import SLOPolicy, SLOTracker
from raft_tpu_torch.serve import IndexRegistry
from raft_tpu_torch.testing import faults
from raft_tpu_torch.tune import Decision, reference

pytestmark = pytest.mark.control

CPU = Resources(device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_journal():
    obs.enable()
    events.configure(capacity=2048)
    yield
    events.disarm_flight_recorder()
    events.configure(capacity=2048)
    obs.enable()
    leaked = faults.armed()
    faults.clear()
    assert not leaked, "test left faults armed"


@pytest.fixture(scope="module")
def corpus():
    """One small ivf_flat family shared by the retune/degrade tests."""
    x, q = reference._clustered(3000, 32, 48, 64, seed=3)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=32, seed=0), x, res=CPU)
    return {"x": x, "q": q[:8], "idx": idx, "family": tune.family_of(idx, x)}


GRID = [{"n_probes": 8}, {"n_probes": 4}]


def make_registry():
    # one warm bucket keeps every publish small
    return IndexRegistry(buckets=(8,))


def watched(corpus, clk, *, dry_run=False, policy=None, slo=None,
            res=None, **watch_kw):
    reg = make_registry()
    reg.publish("live", corpus["idx"], k=5, warm_data=corpus["x"][:64])
    ctl = Controller(publisher=reg, clock=clk, slo=slo, res=res,
                     dry_run=dry_run, policy=policy or ControlPolicy())
    ctl.watch("live", corpus["idx"], corpus["q"], dataset=corpus["x"],
              k=5, ks=(5,), grid=GRID, repeats=1, **watch_kw)
    return reg, ctl


def advise_retune(name="live", emit=events.emit):
    return emit("retune_advised", subject=("quality", name),
                evidence={"drifted": True, "scale_cv": 1.4,
                          "observed": "1k-d32-skew"})


def bf_build(x):
    return brute_force.BruteForce().build(x, res=CPU)


def make_mesh(rng, n=280, shards=2, **kw):
    data = rng.standard_normal((n, 16)).astype(np.float32)
    mesh = stream.ShardedMutableIndex(data, n_shards=shards,
                                      build=bf_build, delta_capacity=64,
                                      **kw)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    return mesh, q


def advise_reshard(mesh, target):
    return events.emit(
        "reshard_advised", subject=("compactor", mesh.name),
        evidence={"action": "split", "target": int(target),
                  "watermark": "reshard_rows_per_shard", "threshold": 100,
                  "rows_per_shard": 140.0, "shards": mesh.n_shards,
                  "live": 280, "auto_apply": False})


def hot_slo(clk, bad=4, policy=SLOPolicy, tracker=SLOTracker):
    """A tracker whose latency burn is far over every threshold."""
    slo = tracker(policy(windows_s=(60.0,), slot_s=30.0, latency_bound_s=0.1), clock=clk)
    for _ in range(bad):
        slo.record_request(1.0, 1.0)
    return slo


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ---------------------------------------------------------------------------
# retune loop
# ---------------------------------------------------------------------------


class TestRetune:
    def test_happy_path_causal_chain_and_cooldown(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk)
        ctl.arm()
        try:
            sensor = advise_retune()
            assert ctl.step() == 1

            dec = events.query(kind="control/decision")[-1]
            assert dec["evidence"]["action"] == "retune"
            assert dec["evidence"]["trigger_seq"] == sensor["seq"]
            # the triggering evidence rides INLINE
            assert dec["evidence"]["trigger"]["scale_cv"] == 1.4

            done = events.query(kind="control/action_completed")[-1]
            assert done["evidence"]["decision_seq"] == dec["seq"]
            assert done["evidence"]["trigger_seq"] == sensor["seq"]
            assert done["evidence"]["params"] in GRID
            assert done["evidence"]["version"] == 2

            # the republish carries the cause — the chain closes inside
            # the registry's own event
            pub = events.query(kind="serve_published")[-1]
            assert pub["evidence"]["cause"]["decision_seq"] == dec["seq"]
            assert pub["evidence"]["cause"]["trigger_seq"] == sensor["seq"]
            assert reg.active("live").version == 2

            st = ctl.status()
            assert st["last_action"]["action"] == "retune"
            assert st["last_action"]["outcome"] == "completed"
            assert st["cooldowns"]["retune"] > 0

            # within the cooldown a second advisory only logs a skip
            advise_retune()
            ctl.step()
            skip = events.query(kind="control/skipped")[-1]
            assert skip["evidence"]["reason"] == "cooldown"
            assert skip["evidence"]["retry_after_s"] > 0
            assert reg.active("live").version == 2

            # past the cooldown it acts again
            clk.advance(ctl.policy.retune_cooldown_s + 1)
            advise_retune()
            ctl.step()
            assert reg.active("live").version == 3
        finally:
            ctl.disarm()

    def test_retuned_version_serves_the_chosen_params(self, corpus):
        """The republished searcher answers as a direct search at the
        decision's params."""
        clk = FakeClock()
        reg, ctl = watched(corpus, clk)
        ctl.arm()
        try:
            advise_retune()
            ctl.step()
        finally:
            ctl.disarm()
        done = events.query(kind="control/action_completed")[-1]
        sp = ivf_flat.SearchParams(**done["evidence"]["params"])
        with reg.lease("live") as v:
            d, i = v.searcher(corpus["q"], 5)
        rd, ri = ivf_flat.search(sp, corpus["idx"], corpus["q"], 5)
        assert torch.equal(torch.as_tensor(i), torch.as_tensor(ri))

    def test_dry_run_logs_decision_without_acting(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk, dry_run=True)
        ctl.arm()
        try:
            advise_retune()
            ctl.step()
        finally:
            ctl.disarm()
        dec = events.query(kind="control/decision")[-1]
        assert dec["evidence"]["dry_run"] is True
        assert events.query(kind="control/action_completed") == []
        assert reg.active("live").version == 1
        assert ctl.status()["actions"]["retune"]["dry_run"] == 1

    def test_unwatched_name_is_ignored(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk)
        ctl.arm()
        try:
            advise_retune(name="someone-else")
            assert ctl.step() == 1
        finally:
            ctl.disarm()
        assert events.query(kind="control/decision") == []
        assert events.query(kind="control/skipped") == []

    def test_inflight_slot_refuses_second_heavy_action(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk)
        ctl.arm()
        try:
            advise_retune()
            with ctl._heavy("reshard"):
                ctl.step()
        finally:
            ctl.disarm()
        skip = events.query(kind="control/skipped")[-1]
        assert skip["evidence"]["reason"] == "inflight"
        assert skip["evidence"]["inflight"] == "reshard"
        assert reg.active("live").version == 1

    def test_sweep_raise_leaves_registry_serving_and_arms_cooldown(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk)
        # poison the actuator: queries of the wrong dim crash the sweep
        ctl._targets["live"].queries = corpus["q"][:, :16]
        ctl.arm()
        try:
            advise_retune()
            ctl.step()
        finally:
            ctl.disarm()
        fail = events.query(kind="control/action_failed")[-1]
        assert fail["severity"] == "error"
        assert fail["evidence"]["outcome"] == "failed"
        assert fail["evidence"]["error"]
        assert reg.active("live").version == 1  # old version still live
        st = ctl.status()
        assert st["last_action"]["outcome"] == "failed"
        assert st["cooldowns"]["retune"] > 0  # no retry storm

    def test_budget_refusal_republish_leaves_registry_serving(self, corpus, tmp_path):
        class Tiny:
            memory_budget_bytes = 1  # any publish admission refuses
            host_budget_bytes = None

        clk = FakeClock()
        events.arm_flight_recorder(str(tmp_path), min_interval_s=0.0)
        reg, ctl = watched(corpus, clk, res=Tiny())
        ctl.arm()
        try:
            advise_retune()
            ctl.step()
        finally:
            ctl.disarm()
        fail = events.query(kind="control/action_failed")[-1]
        assert "MemoryBudgetError" in fail["evidence"]["error"]
        assert fail["evidence"]["trigger"]["drifted"] is True
        assert reg.active("live").version == 1
        # the armed flight recorder bundled the incident
        assert any(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# reshard loop
# ---------------------------------------------------------------------------


class TestReshard:
    def test_happy_path_doubles_topology_with_cause_chain(self, rng):
        clk = FakeClock()
        mesh, q = make_mesh(rng)
        ctl = Controller(clock=clk)
        ctl.attach_mesh(mesh, warm_buckets=(3,), ks=(3,))
        ctl.arm()
        try:
            sensor = advise_reshard(mesh, 4)
            assert ctl.step() == 1
        finally:
            ctl.disarm()
        assert mesh.n_shards == 4

        dec = events.query(kind="control/decision")[-1]
        assert dec["evidence"]["trigger_seq"] == sensor["seq"]
        assert dec["evidence"]["trigger"]["rows_per_shard"] == 140.0
        started = events.query(kind="reshard_started")[-1]
        assert started["evidence"]["cause"]["trigger_seq"] == sensor["seq"]
        assert started["evidence"]["cause"]["decision_seq"] == dec["seq"]
        done = events.query(kind="control/action_completed")[-1]
        assert done["evidence"]["from"] == 2 and done["evidence"]["to"] == 4
        assert done["evidence"]["decision_seq"] == dec["seq"]
        # still serving, and exactly: the resharded mesh equals its oracle
        d, i = mesh.search(q, 3)
        assert tuple(i.shape) == (3, 3)
        assert torch.equal(i, mesh.exact_search(q, 3)[1])

    def test_stale_advice_skipped(self, rng):
        clk = FakeClock()
        mesh, _ = make_mesh(rng)
        ctl = Controller(clock=clk)
        ctl.attach_mesh(mesh)
        ctl.arm()
        try:
            advise_reshard(mesh, 2)  # already at 2 shards
            ctl.step()
        finally:
            ctl.disarm()
        skip = events.query(kind="control/skipped")[-1]
        assert skip["evidence"]["reason"] == "stale"
        assert mesh.n_shards == 2

    def test_headroom_refusal_with_evidence_inline(self, rng):
        class Budget:
            memory_budget_bytes = 100_000_000
            host_budget_bytes = None

        clk = FakeClock()
        mesh, _ = make_mesh(rng)
        ctl = Controller(clock=clk, res=Budget())
        ctl.attach_mesh(mesh)
        ctl.arm()
        hog = obs_mem.account("index/test", name="hog", device_bytes=95_000_000)
        try:
            advise_reshard(mesh, 4)
            ctl.step()
        finally:
            obs_mem.release(hog)
            ctl.disarm()
        skip = events.query(kind="control/skipped")[-1]
        assert skip["evidence"]["reason"] == "headroom"
        assert skip["evidence"]["headroom_frac"] < 0.10
        assert skip["evidence"]["budget_bytes"] == 100_000_000
        assert mesh.n_shards == 2

    def test_slo_burn_refusal(self, rng):
        clk = FakeClock()
        mesh, _ = make_mesh(rng)
        slo = hot_slo(clk)
        # degrade loop off (no watched targets) — only the admission runs
        ctl = Controller(clock=clk, slo=slo)
        ctl.attach_mesh(mesh)
        ctl.arm()
        try:
            advise_reshard(mesh, 4)
            ctl.step()
        finally:
            ctl.disarm()
        skip = events.query(kind="control/skipped")[-1]
        assert skip["evidence"]["reason"] == "slo_burn"
        assert skip["evidence"]["burn"]["latency"] >= 1.0
        assert mesh.n_shards == 2

    @pytest.mark.parametrize("point", ["reshard/split", "reshard/flip", "reshard/manifest"])
    def test_fault_aborts_cleanly_mesh_keeps_serving(self, rng, tmp_path, point):
        clk = FakeClock()
        mesh, q = make_mesh(rng, wal_dir=str(tmp_path / "wal"))
        before = mesh.search(q, 3)[1].clone()
        ctl = Controller(clock=clk)
        ctl.attach_mesh(mesh)
        ctl.arm()
        events.arm_flight_recorder(str(tmp_path / "rec"), min_interval_s=0.0)
        try:
            with faults.scope():
                faults.inject(point, exc=faults.FaultError(f"boom@{point}"))
                advise_reshard(mesh, 4)
                ctl.step()
        finally:
            ctl.disarm()
        # the mesh still serves its OLD topology, bit-identically
        assert mesh.n_shards == 2
        assert torch.equal(mesh.search(q, 3)[1], before)
        fail = events.query(kind="control/action_failed")[-1]
        assert "boom@" in fail["evidence"]["error"]
        assert fail["evidence"]["trigger"]["target"] == 4
        assert ctl.status()["cooldowns"]["reshard"] > 0
        assert any((tmp_path / "rec").iterdir())


# ---------------------------------------------------------------------------
# degrade / restore (the burn loop)
# ---------------------------------------------------------------------------


class TestDegradeRestore:
    def test_degrade_then_hysteresis_restore(self, corpus):
        clk = FakeClock()
        slo = hot_slo(clk)
        pin = Decision(kind="ivf_flat", dtype="float32",
                       family=corpus["family"], params={"n_probes": 8})
        policy = ControlPolicy(degrade_cooldown_s=5.0, restore_clear_s=120.0)
        reg, ctl = watched(corpus, clk, slo=slo, policy=policy,
                           decision=pin, degrade_params={"n_probes": 2})
        ctl.arm()
        try:
            ctl.step()  # burn loop sees a hot window
            deg = events.query(kind="control/degraded")[-1]
            assert deg["severity"] == "warning"
            assert deg["evidence"]["params"] == {"n_probes": 2}
            assert deg["evidence"]["pinned"] == pin.key
            assert deg["evidence"]["trigger_kind"] == "slo_burn"
            assert deg["evidence"]["trigger"]["burn"]["latency"] >= 1.0
            assert reg.active("live").version == 2
            assert ctl.status()["degraded"] == ["live"]
            # the degraded version serves the cheap point
            with reg.lease("live") as v:
                got = v.searcher(corpus["q"], 5)[1]
            want = ivf_flat.search(ivf_flat.SearchParams(n_probes=2), corpus["idx"],
                                   corpus["q"], 5)[1]
            assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))

            # still hot: no restore, no re-degrade (the pinned flag holds)
            clk.advance(10.0)
            slo.record_request(1.0, 1.0)
            ctl.step()
            assert events.query(kind="control/restored") == []
            assert reg.active("live").version == 2

            # burn clears (the ring ages out) — hysteresis holds the
            # restore until the clear persists for restore_clear_s
            clk.advance(100.0)
            ctl.step()  # clear observed: clock starts
            assert events.query(kind="control/restored") == []
            clk.advance(60.0)
            ctl.step()  # 60 < 120: still holding
            assert events.query(kind="control/restored") == []
            clk.advance(70.0)
            ctl.step()  # 130 >= 120: restore
        finally:
            ctl.disarm()
        res = events.query(kind="control/restored")[-1]
        assert res["evidence"]["pinned"] == pin.key
        assert res["evidence"]["trigger_kind"] == "slo_burn_cleared"
        assert reg.active("live").version == 3
        assert ctl.status()["degraded"] == []

    def test_no_cheaper_point_skips_once_per_cooldown(self, corpus):
        clk = FakeClock()
        slo = hot_slo(clk)
        # no decision, no degrade_params: nothing cheaper exists
        reg, ctl = watched(corpus, clk, slo=slo)
        ctl.arm()
        try:
            ctl.step()
            ctl.step()  # the armed cooldown keeps the skip from repeating
        finally:
            ctl.disarm()
        skips = [e for e in events.query(kind="control/skipped")
                 if e["evidence"]["reason"] == "no_cheaper_point"]
        assert len(skips) == 1
        assert reg.active("live").version == 1

    def test_non_transfer_guard_refuses_cross_class_restore(self, corpus):
        clk = FakeClock()
        slo = hot_slo(clk)
        wrong = corpus["family"].rsplit("-", 1)[0] + "-clump"
        pin = Decision(kind="ivf_flat", dtype="float32", family=wrong,
                       params={"n_probes": 8})
        reg, ctl = watched(corpus, clk, slo=slo, decision=pin,
                           degrade_params={"n_probes": 2})
        with pytest.raises(NonTransferError, match="never transfer"):
            ctl._guard_transfer(pin, ctl._targets["live"])
        # end to end: the degrade actuation hits the guard and records
        # the refusal as a failed action — the registry is untouched
        ctl.arm()
        try:
            ctl.step()
        finally:
            ctl.disarm()
        fail = events.query(kind="control/action_failed")[-1]
        assert "NonTransferError" in fail["evidence"]["error"]
        assert reg.active("live").version == 1


# ---------------------------------------------------------------------------
# compaction pacing (Compactor.set_pacing)
# ---------------------------------------------------------------------------


class TestCompactionPacing:
    def _due_compactor(self, rng, clk, **kw):
        data = rng.standard_normal((64, 16)).astype(np.float32)
        m = stream.MutableIndex(bf_build(data), delta_capacity=16, clock=clk)
        comp = stream.Compactor(
            m, policy=stream.CompactionPolicy(delta_fill=0.5, tombstone_ratio=None),
            clock=clk, **kw)
        m.upsert(data[:8] + 0.5)
        assert comp.due() == "delta_fill"
        return m, comp

    def test_controller_burn_defers_then_releases(self, rng):
        clk = FakeClock()
        slo = hot_slo(clk)
        ctl = Controller(clock=clk, slo=slo)
        m, comp = self._due_compactor(rng, clk)
        ctl.attach_compactor(comp)
        assert comp.run_once() is None  # hot: deferred, not folded
        assert comp.last_deferred == "delta_fill"
        assert comp.due() == "delta_fill"  # the debt is still due
        # force overrides pacing (the back-pressure escape hatch)
        rep = comp.run_once(force=True)
        assert rep is not None and rep["folded"] == 8

    def test_burn_clear_lets_the_fold_run(self, rng):
        clk = FakeClock()
        slo = hot_slo(clk)
        ctl = Controller(clock=clk, slo=slo)
        m, comp = self._due_compactor(rng, clk)
        ctl.attach_compactor(comp)
        assert comp.run_once() is None
        clk.advance(120.0)  # the burn window ages out
        rep = comp.run_once()
        assert rep is not None and rep["trigger"] == "delta_fill"

    def test_default_behavior_unchanged_without_hint(self, rng):
        clk = FakeClock()
        m, comp = self._due_compactor(rng, clk)
        rep = comp.run_once()
        assert rep is not None and rep["folded"] == 8
        assert comp.last_deferred is None

    def test_raising_pacing_hint_never_blocks_the_fold(self, rng):
        clk = FakeClock()

        def bad_hint():
            raise RuntimeError("sensor down")

        m, comp = self._due_compactor(rng, clk, pacing=bad_hint)
        rep = comp.run_once()  # a broken sensor must not wedge compaction
        assert rep is not None and rep["folded"] == 8


# ---------------------------------------------------------------------------
# bounds + observability
# ---------------------------------------------------------------------------


class TestBoundsAndObservability:
    def test_bounded_tap_queue_counts_drops(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk, policy=ControlPolicy(queue_capacity=2))
        ctl.arm()
        try:
            for _ in range(3):
                advise_retune(name="nobody")
            st = ctl.status()
        finally:
            ctl.disarm()
        assert st["queue"] == 2 and st["queue_dropped"] == 1

    def test_drift_report_carries_replay_evidence(self):
        """The retune_advised evidence is replayable from the journal
        alone — thresholds and both balance classes inline."""
        from raft_tpu_torch.obs import quality

        hot, _ = reference._clustered(2000, 32, 8, 64, seed=29, heavytail=True)
        det = quality.DriftDetector(tune.shape_family(2000, 32, "bal"),
                                    name="ctl-drift", min_rows=256)
        det.offer_rows(hot[:1024])
        rep = det.check()
        assert rep["drifted"]
        ev = events.query(kind="retune_advised")[-1]["evidence"]
        assert ev["scale_cv_threshold"] == 0.75
        assert ev["pinned_balance"] == "bal"
        assert ev["observed_balance"] == "skew"
        assert ev["scale_cv"] > 0.75

    def test_debug_control_endpoint_and_healthz_fold(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk, dry_run=True)
        ctl.arm()
        try:
            advise_retune()
            ctl.step()
            with MetricsExporter(port=0, controller=ctl) as exp:
                code, body = _get(f"http://127.0.0.1:{exp.port}/debug/control")
                assert code == 200
                payload = json.loads(body)
                assert payload["controller"]["dry_run"] is True
                assert payload["controller"]["targets"] == ["live"]
                kinds = {e["kind"] for e in payload["recent"]}
                assert "control/decision" in kinds
                code, body = _get(f"http://127.0.0.1:{exp.port}/healthz")
                assert code == 200
                h = json.loads(body)
                assert h["control"]["enabled"] is True
                assert h["control"]["dry_run"] is True
                # 404 contract: unknown paths name every endpoint
                code, body = _get(f"http://127.0.0.1:{exp.port}/nope")
                assert code == 404 and "/debug/control" in body
        finally:
            ctl.disarm()

    def test_debug_control_404_without_controller(self):
        with MetricsExporter(port=0) as exp:
            code, body = _get(f"http://127.0.0.1:{exp.port}/debug/control")
            assert code == 404 and "controller=" in body

    def test_start_stop_worker_lifecycle(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk, dry_run=True)
        ctl.start()
        try:
            assert ctl.status()["enabled"]
            assert any(t.name == "raft-control-default" for t in threading.enumerate())
        finally:
            ctl.stop()
        assert not ctl.status()["enabled"]
        assert not any(t.name == "raft-control-default" for t in threading.enumerate())

    def test_started_worker_acts_on_advice(self, corpus):
        """The deployment mode: ``start()``'s worker drains the tap on its
        own thread (here with dry_run, so it decides and logs)."""
        reg, ctl = watched(corpus, time.monotonic, dry_run=True)
        ctl.start(poll_interval_s=0.01)
        try:
            advise_retune()
            deadline = time.monotonic() + 10.0
            while (not events.query(kind="control/decision")
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            ctl.stop()
        assert events.query(kind="control/decision")[-1]["evidence"]["dry_run"] is True

    def test_control_metrics_use_the_jax_names(self, corpus):
        clk = FakeClock()
        reg, ctl = watched(corpus, clk, dry_run=True)
        ctl.arm()
        try:
            advise_retune()
            ctl.step()
        finally:
            ctl.disarm()
        text = obs.to_prometheus()
        assert 'raft_tpu_control_actions_total{action="retune",outcome="dry_run"}' in text


# ---------------------------------------------------------------------------
# parity: one scripted scenario through both packages' controllers
# ---------------------------------------------------------------------------


def _scenario(pkg, x, q, index, family):
    """retune → cooldown skip → degrade → restore, on one package's
    objects; returns the ``control/*`` events' (kind, action, outcome,
    reason) in journal order."""
    if pkg == "jax":
        ev_mod, Ctl, Pol, Reg, Dec = (jevents, jcontrol.Controller, jcontrol.ControlPolicy,
                                      JRegistry, jtune.Decision)
        slo_kw = dict(policy=JSLOPolicy, tracker=JSLOTracker)
        jobs.enable()
    else:
        ev_mod, Ctl, Pol, Reg, Dec = events, Controller, ControlPolicy, IndexRegistry, Decision
        slo_kw = {}
    ev_mod.configure(capacity=2048)
    clk = FakeClock()
    reg = Reg(buckets=(8,))
    reg.publish("live", index, k=5, warm_data=x[:64])
    slo = hot_slo(clk, bad=0, **slo_kw)   # cool until the scenario heats it
    pin = Dec(kind="ivf_flat", dtype="float32", family=family, params={"n_probes": 8})
    ctl = Ctl(publisher=reg, clock=clk, slo=slo,
              policy=Pol(degrade_cooldown_s=5.0, restore_clear_s=120.0))
    ctl.watch("live", index, q, dataset=x, k=5, ks=(5,), grid=GRID, repeats=1,
              decision=pin, degrade_params={"n_probes": 2})
    ctl.arm()
    try:
        advise_retune(emit=ev_mod.emit)
        ctl.step()                       # retune: decision + completed
        advise_retune(emit=ev_mod.emit)
        ctl.step()                       # within the cooldown: skipped
        for _ in range(4):
            slo.record_request(1.0, 1.0)
        ctl.step()                       # hot: degrade
        clk.advance(100.0)
        ctl.step()                       # clear observed
        clk.advance(130.0)
        ctl.step()                       # held past restore_clear_s: restore
    finally:
        ctl.disarm()
    out = [(e["kind"], e["evidence"].get("action"), e["evidence"].get("outcome"),
            e["evidence"].get("reason"))
           for e in ev_mod.query(component="control")]
    versions = reg.active("live").version
    ev_mod.configure(capacity=2048)
    return out, versions


def test_scenario_emits_the_same_control_events_as_jax(tmp_path):
    x, q = reference._clustered(3000, 32, 48, 64, seed=3)
    q = q[:8]
    jindex = jfl.build(jfl.IndexParams(n_lists=32, seed=0), jnp.asarray(x))
    path = str(tmp_path / "ivf_flat.bin")
    jfl.save(jindex, path)
    tindex = ivf_flat.load(path, res=CPU)
    jfamily, tfamily = jtune.family_of(jindex, jnp.asarray(x)), tune.family_of(tindex, x)
    assert jfamily == tfamily
    theirs, jver = _scenario("jax", jnp.asarray(x), jnp.asarray(q), jindex, jfamily)
    mine, tver = _scenario("port", x, q, tindex, tfamily)
    assert [e[0] for e in mine] == [
        "control/decision", "control/action_completed", "control/skipped",
        "control/decision", "control/degraded", "control/decision", "control/restored"]
    assert mine == theirs
    assert tver == jver == 4


# ---------------------------------------------------------------------------
# nothing left running (keep last in the file)
# ---------------------------------------------------------------------------


def test_no_controller_worker_left():
    def left():
        return [t.name for t in threading.enumerate()
                if t.name.startswith(("raft-control-", "raft-obs-exporter", "raft-net-",
                                      "raft-httpd"))]

    deadline = time.monotonic() + 10.0
    while left() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert left() == []
